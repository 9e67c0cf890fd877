// Peak ladder: the Hough peak find's 3x3 local-maximum test and the crowd
// guard's per-rung peak counts, in one pass over the vote plane.
//
// For votes [B, n_theta, n_rho] int32, a threshold and n_cuts ladder cuts:
//   is_peak[b, th * n_rho + rho] = v >= max(3x3 window, INT32_MIN outside
//                                  the plane) && v > threshold
//   count[b, r] = the peaks of frame b whose rung is r, a vote's rung being
//                 the number of cuts <= it (0..n_cuts)
// Ties count as peaks, as votes >= dilate3x3(votes) does. Spec:
// metdetpy_tpu_torch/ops/kernels.py::peak_ladder_plain; the crowd guard's
// tails (peaks at or above each cut) are the count's suffix sums. It takes
// the place of a [B, n_cuts, N] comparison and its int64 sum
// (metdetpy_tpu_torch/ops/hough.py::find_peaks_plain), which moved ~1 GB a
// chunk of 8 frames at N = 180 x 3072.
//
// Bound by bytes: the votes read once (17.7 MB for 8 frames at n_rho 3072)
// and the u8 mask written (4.4 MB): 0.0066 ms at 3.35 TB/s. A chunk's votes
// were just written by hough_vote and mostly sit in the 50 MB L2.
//
// Design: a thread owns kBins adjacent rho columns of a run of PL_ROWS theta
// rows. It loads the run's rows and the two rows around it, one 16-byte load
// a row, all issued before any is used; the columns left and right of its
// own come from the neighbouring lanes by warp shuffles, and the warp's edge
// lanes load theirs. The window max is a max over three rows per column,
// then over three columns. A peak (rare) counts its rung into a
// shared-memory histogram of n_cuts + 1 bins, and each block adds its
// non-zero bins into count with one global atomicAdd each: integer counts,
// exact and independent of order. count is zeroed by a memset on the launch
// stream, so a CUDA graph that captures the launch zeroes it on every
// replay. Where n_rho % 4 != 0 or a pointer is not aligned the same kernel
// runs with one column per thread.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#ifndef PL_ROWS
#define PL_ROWS 4  // theta rows a block takes
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCuts = 32;
constexpr unsigned kFull = 0xffffffffu;

template <int kBins>
__global__ void __launch_bounds__(kThreads)
    peak_ladder_kernel(const int* __restrict__ votes,
                       const int* __restrict__ cuts, int n_cuts,
                       int threshold, uint8_t* __restrict__ is_peak,
                       int* __restrict__ count, int n_theta, int n_rho) {
  __shared__ int s_cuts[kMaxCuts];
  __shared__ int hist[kMaxCuts + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < n_cuts) s_cuts[tid] = cuts[tid];
  if (tid <= n_cuts) hist[tid] = 0;

  const long long base = (long long)blockIdx.z * n_theta * n_rho;
  const int th0 = blockIdx.y * PL_ROWS;
  const int c0 = (blockIdx.x * kThreads + tid) * kBins;
  const bool active = c0 < n_rho;

  // v[i]: row th0 - 1 + i; [0] the column left of the thread's, [1..kBins]
  // its own, [kBins + 1] the one right of them; INT_MIN outside the plane
  constexpr int kR = PL_ROWS + 2;
  int v[kR][kBins + 2];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int j = 0; j < kBins + 2; ++j) v[i][j] = INT_MIN;
    const int th = th0 - 1 + i;
    if (th < 0 || th >= n_theta) continue;  // the same for the whole block
    const int* row = votes + base + (long long)th * n_rho;
    if (active) {
      if constexpr (kBins == 4) {
        const int4 w = __ldg((const int4*)(row + c0));
        v[i][1] = w.x, v[i][2] = w.y, v[i][3] = w.z, v[i][4] = w.w;
      } else {
        v[i][1] = __ldg(row + c0);
      }
    }
    if (lane == 0 && c0 > 0 && c0 <= n_rho) v[i][0] = __ldg(row + c0 - 1);
    if (lane == 31 && c0 + kBins < n_rho)
      v[i][kBins + 1] = __ldg(row + c0 + kBins);
  }
  // a lane's neighbour past the plane's end holds INT_MIN already
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int left = __shfl_up_sync(kFull, v[i][kBins], 1);
    const int right = __shfl_down_sync(kFull, v[i][1], 1);
    if (lane != 0) v[i][0] = left;
    if (lane != 31) v[i][kBins + 1] = right;
  }
  __syncthreads();  // s_cuts and hist

#pragma unroll
  for (int i = 1; i <= PL_ROWS; ++i) {
    const int th = th0 - 1 + i;
    if (th >= n_theta) break;  // the same for the whole block
    int col[kBins + 2];
#pragma unroll
    for (int j = 0; j < kBins + 2; ++j)
      col[j] = max(max(v[i - 1][j], v[i][j]), v[i + 1][j]);
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const int x = v[i][j + 1];
      const bool peak = active && x > threshold &&
                        x >= max(max(col[j], col[j + 1]), col[j + 2]);
      if (peak) {
        int rung = 0;
        for (int c = 0; c < n_cuts; ++c) rung += x >= s_cuts[c];
        atomicAdd(&hist[rung], 1);
      }
      bits |= (unsigned)peak << (8 * j);
    }
    if (active) {
      uint8_t* out = is_peak + base + (long long)th * n_rho + c0;
      if constexpr (kBins == 4)
        *(unsigned*)out = bits;
      else
        *out = (uint8_t)bits;
    }
  }
  __syncthreads();
  if (tid <= n_cuts && hist[tid] != 0)
    atomicAdd(count + (long long)blockIdx.z * (n_cuts + 1) + tid, hist[tid]);
}

}  // namespace

extern "C" int mdt_peak_ladder(const void* votes, const void* cuts,
                               int n_cuts, int threshold, void* is_peak,
                               void* count, int b, int n_theta, int n_rho,
                               void* stream) {
  if (n_cuts < 0 || n_cuts > kMaxCuts || b < 0 || b > 65535 || n_theta < 0 ||
      n_rho < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      count, 0, sizeof(int) * (size_t)b * (size_t)(n_cuts + 1), s);
  if (err != cudaSuccess) return (int)err;
  if (b == 0 || n_theta == 0 || n_rho == 0) return 0;
  const bool vec = n_rho % 4 == 0 && ((uintptr_t)votes & 15) == 0 &&
                   ((uintptr_t)is_peak & 3) == 0;
  const int per_block = kThreads * (vec ? 4 : 1);
  const dim3 grid((n_rho + per_block - 1) / per_block,
                  (n_theta + PL_ROWS - 1) / PL_ROWS, b);
  const auto kernel = vec ? peak_ladder_kernel<4> : peak_ladder_kernel<1>;
  kernel<<<grid, kThreads, 0, s>>>((const int*)votes, (const int*)cuts,
                                   n_cuts, threshold, (uint8_t*)is_peak,
                                   (int*)count, n_theta, n_rho);
  return (int)cudaGetLastError();
}
