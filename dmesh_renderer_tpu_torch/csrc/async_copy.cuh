// Asynchronous copies from device memory to shared memory (cp.async,
// sm_80 and later), shared by the kernels that stage table rows in rounds:
// K1 (tri_fwd.cu) and K3 (tet_fwd.cu). A thread starts copies, closes them
// into a group with cp_async_commit(), and cp_async_wait<n>() waits until
// at most n of its groups are still in flight; a __syncthreads() after the
// wait makes every thread's copies visible to the block.

#pragma once

#include <cuda_runtime.h>

namespace acopy {

// 4 bytes, through L1
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// 16 bytes, past L1 (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace acopy
