// The probe kernels of the round-3 experiment battery for Hopper (sm_90a):
// the in-kernel gather (T1, take_rows) and the segmented lane merge (T2,
// roll_merge). Driven by dmesh_renderer_tpu_torch/tools/exp_round3.py (e2
// and e3).
//
// T1 replaces the kernel of tools/exp_round3.py::e2 (the pallas_call at
// :157): out[r, l] = tab[idx[r, l], l], a per-lane gather along the rows of
// a [S, 128] table, what jnp.take_along_axis(tab, idx, 0) computes. e2 asks
// whether a kernel can gather from a table held on chip, and at what cost.
// Here: one block of 256 threads handles kRowsPerBlock rows of 128 lanes.
// When the table fits the block's static shared-memory budget (S * 512 B <=
// 48 KB, so S <= 96: the TPU sizes 8, 32 and 64), the block first stages it
// in shared memory with 16-byte loads and gathers from there (lane l of row
// k sits in bank l % 32: no conflicts); otherwise each lookup reads the table
// through L2. Indices outside [0, S) are clamped, in the plain version too,
// so a bad index cannot read outside the table. Bound: bytes (the indices,
// the output and the table elements the lookups touch); at R = 8 rows, a
// launch's latency.
//
// T2 replaces the kernel of tools/exp_round3.py::e3 (the pallas_call at
// :215): on a [G, 12, 128] buffer (row 0 the keys, rows 1..11 values), for
// each row-group and value row the 7 levels s = 1, 2, 4, ..., 64 run in
// order, each reading the previous level's values:
//
//   v[l] += (l < 128 - s && key[l + s] == key[l] ? 1 : 0) * v[(l + s) % 128]
//
// (the TPU rolls the lane vector by s, so lanes past 128 - s read the
// wrapped lane, times a zero mask). Output row 0 is 1.0, rows 1..11 the
// values. The multiply by the 0/1 mask is kept, not a select: the two differ
// on inf and NaN. The TPU grid covers (G / 16) * 16 groups; this kernel
// covers all G. Shape: one thread per (group, lane), two groups per block,
// each thread holding its lane's key and 11 values in registers; per level
// the values go through shared memory between two barriers, so a level reads
// only the previous level's values. Bound: bytes (the buffer read once and
// written once).
//
// Built with --fmad=false; the mask product is exact, so the sums round as
// the plain versions' elementwise torch ops.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;
constexpr int kSharedRowsMax = 96;  // 48 KB of static shared memory

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                 float* __restrict__ out, int S, int R) {
  __shared__ float4 stab[kShared ? kSharedRowsMax * kLanes / 4 : 1];
  const float* src = tab;
  if (kShared) {
    const float4* t4 = reinterpret_cast<const float4*>(tab);
    for (int i = threadIdx.x; i < S * (kLanes / 4); i += kThreads)
      stab[i] = t4[i];
    __syncthreads();
    src = reinterpret_cast<const float*>(stab);
  }
  const int lane = threadIdx.x % kLanes;
  const int r_end = min(R, (blockIdx.x + 1) * kRowsPerBlock);
  for (int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes; r < r_end;
       r += kThreads / kLanes) {
    const size_t o = (size_t)r * kLanes + lane;
    const int k = min(max(idx[o], 0), S - 1);
    out[o] = src[(size_t)k * kLanes + lane];
  }
}

constexpr int kRows = 12;
constexpr int kVals = kRows - 1;
constexpr int kGroups = kThreads / kLanes;

__global__ void __launch_bounds__(kThreads)
roll_merge_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int G) {
  __shared__ float sv[kGroups][kVals][kLanes];
  __shared__ float sk[kGroups][kLanes];
  const int gl = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int g = blockIdx.x * kGroups + gl;
  const bool live = g < G;  // every thread reaches every barrier
  const float* src = in + (size_t)g * kRows * kLanes;

  float key = 0.0f, v[kVals];
#pragma unroll
  for (int r = 0; r < kVals; ++r) v[r] = 0.0f;
  if (live) {
    key = src[l];
#pragma unroll
    for (int r = 0; r < kVals; ++r) v[r] = src[(1 + r) * kLanes + l];
  }
  sk[gl][l] = key;
#pragma unroll
  for (int s = 1; s < kLanes; s *= 2) {
#pragma unroll
    for (int r = 0; r < kVals; ++r) sv[gl][r][l] = v[r];
    __syncthreads();
    const int n = (l + s) % kLanes;
    const float ok = (l < kLanes - s && sk[gl][n] == key) ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < kVals; ++r) v[r] = v[r] + ok * sv[gl][r][n];
    __syncthreads();
  }
  if (!live) return;
  float* dst = out + (size_t)g * kRows * kLanes;
  dst[l] = 1.0f;
#pragma unroll
  for (int r = 0; r < kVals; ++r) dst[(1 + r) * kLanes + l] = v[r];
}

}  // namespace

// Launch T1 on `stream`: tab [S, 128] f32 (16-byte aligned), idx [R, 128]
// int32, out [R, 128] f32. Allocates nothing and does not synchronise.
// Returns the launch's cudaGetLastError().
extern "C" int take_rows(const void* tab, const void* idx, void* out, int S,
                         int R, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  if (S <= kSharedRowsMax)
    take_rows_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)tab, (const int*)idx, (float*)out, S, R);
  else
    take_rows_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)tab, (const int*)idx, (float*)out, S, R);
  return (int)cudaGetLastError();
}

// Launch T2 on `stream`: in, out [G, 12, 128] f32. Allocates nothing and
// does not synchronise. Returns the launch's cudaGetLastError().
extern "C" int roll_merge(const void* in, void* out, int G, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  roll_merge_kernel<<<(G + kGroups - 1) / kGroups, kThreads, 0,
                      (cudaStream_t)stream>>>((const float*)in, (float*)out,
                                              G);
  return (int)cudaGetLastError();
}
