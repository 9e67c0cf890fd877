// Hough votes from compacted points: [T, N] xs, ys, valid -> [T, 180, n_rho]
// int32 counts.
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::hough_vote_pallas (:505,
// kernel _vote_kernel :465). Spec: metdetpy_tpu/ops/hough.py::_vote.
//
// Bound by bytes: the vote array written (180 * n_rho int32 per frame) is
// far larger than the point list read. One block per (frame, chunk of
// THETAS thetas) counts into a shared-memory histogram with integer
// atomicAdd -- integer atomics commute, so the counts are exact whatever
// the order -- then stores it coalesced. The point list is re-read (from
// L2) by every theta chunk of its frame.
//
// rho reproduces what XLA's CPU backend computes for cos*x + sin*y + off:
// the first product fused with the rounded second one, then the offset
// added: __fadd_rn(__fmaf_rn(c, x, __fmul_rn(s, y)), off). The explicit
// intrinsics keep nvcc from contracting it any other way. rintf rounds half
// to even like jnp.round. cos/sin come from the literal jnp tables.

#include <cuda_runtime.h>
#include <stdint.h>

#define THETAS 4
#define THREADS 256
#define N_THETA 180

__global__ void hough_vote_kernel(const float* __restrict__ xs,
                                  const float* __restrict__ ys,
                                  const uint8_t* __restrict__ valid,
                                  const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t,
                                  int* __restrict__ votes, int n, int n_rho,
                                  float off) {
  extern __shared__ int hist[];  // [THETAS][n_rho]
  const int t = blockIdx.y;
  const int c0 = blockIdx.x * THETAS;
  for (int i = threadIdx.x; i < THETAS * n_rho; i += THREADS) hist[i] = 0;
  float cs[THETAS], sn[THETAS];
#pragma unroll
  for (int j = 0; j < THETAS; ++j) {
    cs[j] = cos_t[c0 + j];
    sn[j] = sin_t[c0 + j];
  }
  __syncthreads();

  const long long base = (long long)t * n;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (!valid[base + i]) continue;
    const float x = xs[base + i], y = ys[base + i];
#pragma unroll
    for (int j = 0; j < THETAS; ++j) {
      const float rho =
          __fadd_rn(__fmaf_rn(cs[j], x, __fmul_rn(sn[j], y)), off);
      const int q = min(max((int)rintf(rho), 0), n_rho - 1);
      atomicAdd(&hist[j * n_rho + q], 1);
    }
  }
  __syncthreads();

  int* dst = votes + ((long long)t * N_THETA + c0) * n_rho;
  for (int i = threadIdx.x; i < THETAS * n_rho; i += THREADS) dst[i] = hist[i];
}

extern "C" int mdt_hough_vote(const void* xs, const void* ys,
                              const void* valid, const void* cos_t,
                              const void* sin_t, void* votes, int t_block,
                              int n, int n_rho, int rho_offset,
                              void* stream) {
  if (t_block <= 0) return 0;
  const size_t smem = (size_t)THETAS * n_rho * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hough_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N_THETA / THETAS, t_block);
  hough_vote_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)xs, (const float*)ys, (const uint8_t*)valid,
      (const float*)cos_t, (const float*)sin_t, (int*)votes, n, n_rho,
      (float)rho_offset);
  return (int)cudaGetLastError();
}
