// Helpers shared by the streaming kernels (window_diff.cu,
// median_binarize_close.cu): 16-byte asynchronous global -> shared copies
// and the 32-bit words of a uint4.
//
// ops/kernels.py hashes every .cuh of this directory into each library's
// name, so editing this file rebuilds the kernels that include it.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

}  // namespace
