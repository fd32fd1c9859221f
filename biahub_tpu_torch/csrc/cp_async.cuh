// Asynchronous copies from device memory into shared memory (cp.async, sm_80
// and later), shared by the kernels that stage their next tile while they
// compute on this one (fft.cu's B and Bc, deskew.cu's D, spectral.cu's M,
// warp.cu's E, multipass.cu's J).
// A copy with valid false writes zeros (the source is not read). A thread's
// copies land in order of their commit groups: cp_async_wait<N>() returns
// once at most N of its newest groups are still in flight, and a
// __syncthreads() after it makes every thread's landed copies visible.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// 16 bytes, bypassing L1 (dst and src 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 16 bytes, cached in L1 too (for data the block reads again soon).
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
