// Asynchronous 16-byte copies from global to shared memory (cp.async,
// sm_80 and later), for the pipelined loads of lstm_train.cu's dW kernel.
// The copies a thread starts between two commits form one group, and a
// wait blocks until at most N of its groups are still in flight; a
// __syncthreads after the wait makes the data visible to the whole block.

#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes from `src` to shared `dst` when `valid`, else 16 zero bytes
// (the copy's source size 0: nothing is read from `src`).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace
