// What slstm.cu and slstm_bwd.cu share (each includes it; the kernel build
// hashes it into both libraries' names): the 16-byte cp.async, the
// per-head barrier's release arrive and acquire wait, and the refused
// launch's error.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// the release pattern: the fence releases the writes of every thread of the
// block made before the __syncthreads that precedes it
__device__ __forceinline__ void arrive(int* counter) {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(counter), "r"(1) : "memory");
}
__device__ __forceinline__ void wait_for(const int* counter, int target) {
  int seen;
  do {
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
  } while (seen < target);
}

// clears the pending error state so a refused launch is not reported again
// by the next kernel's cudaGetLastError()
cudaError_t fail(cudaError_t err) {
  cudaGetLastError();
  return err;
}

}  // namespace
