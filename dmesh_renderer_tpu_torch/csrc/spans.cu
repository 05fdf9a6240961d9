// The span mark of the port's train steps (utils/spans.py): one thread that
// appends one record to a ring on the device.
//
// A record is four int64: the span id, the step index, the device's
// %globaltimer in ns at the mark's start and a counter value. The ring's
// state is two uint64: the head (every mark takes the next slot with an
// atomic add; the slot is head % cap, so the ring wraps) and the step index
// (a mark that opens a step adds 1 to it and stores the new value; every
// other mark stores it as it is). The counter is read from an optional
// device scalar of type ctype: 0 none (the record holds 0), 1 int32, 2
// int64.
//
// A mark is launched on the current stream, so it starts when the stream's
// previous work has ended: its stamp closes the stage before it. Launched
// while a stream captures, it becomes a graph node, and every replay of the
// graph appends that replay's records. Nothing is read on the host here.

#include <cuda_runtime.h>

__global__ void span_mark_kernel(long long* ring,
                                 unsigned long long* state,
                                 const void* counter, int cap, int span,
                                 int open_step, int ctype) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long slot = atomicAdd(&state[0], 1ULL);
  long long step;
  if (open_step)
    step = (long long)atomicAdd(&state[1], 1ULL) + 1;
  else
    step = (long long)(*(volatile unsigned long long*)&state[1]);
  long long c = 0;
  if (ctype == 1)
    c = *(const int*)counter;
  else if (ctype == 2)
    c = *(const long long*)counter;
  long long* row = ring + (slot % (unsigned long long)cap) * 4;
  row[0] = span;
  row[1] = step;
  row[2] = (long long)t;
  row[3] = c;
}

extern "C" int span_mark(void* ring, void* state, const void* counter,
                         int cap, int span, int open_step, int ctype,
                         void* stream) {
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  span_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (unsigned long long*)state, counter, cap, span,
      open_step, ctype);
  return (int)cudaGetLastError();
}
