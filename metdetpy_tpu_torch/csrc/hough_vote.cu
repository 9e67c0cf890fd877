// Hough votes from compacted points: [T, N] xs, ys, valid -> [T, 180, n_rho]
// int32 counts.
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::hough_vote_pallas (:505,
// kernel _vote_kernel :465). Spec: metdetpy_tpu/ops/hough.py::_vote.
//
// Bound by bytes: the vote array written (180 * n_rho int32 per frame,
// 17.7 MB for 8 frames at n_rho = 3072) is far larger than the point list
// read (9 bytes per point, 0.59 MB for 8 x 8192): 0.0055 ms at 3.35 TB/s.
// Its 3 float operations per (valid point, theta) take 0.0003 ms at
// 67 T operations/s. What the kernel is held by on the card, beside the
// stores, is shared memory: a vote is one access to a random bank, 32 of
// them take several turns of the shared-memory pipe (a plain store in the
// atomic's place takes as long), and that pipe is the one thing a vote
// needs. So the design keeps everything else out of shared memory.
//
// Design: about one persistent block per SM. A block owns one frame and a
// run of thetas [g * 180 / groups, (g + 1) * 180 / groups) and works
// through the run in passes of kTh thetas.
// - Points in registers. A thread holds kPts points of the frame (x, y and
//   the valid byte), loaded once with coalesced loads while the histograms
//   are zeroed, for every pass: the list is read from the L2 once per block
//   and never from shared memory. A list longer than kThreads * kPts points
//   is walked in rounds, loaded again in each pass.
// - Two histograms. A pass counts into one [kTh][n_rho] int32 histogram
//   with shared-memory atomicAdd (integer, so exact whatever the order).
//   After one barrier the block votes the next pass into the other one,
//   and between those votes each thread drains its words of the finished
//   histogram: atomicExch reads a word and leaves 0 in one access, and the
//   word goes to `votes` with a coalesced 4-byte store that nothing waits
//   for. The stores overlap the votes, the histogram is clean again one
//   barrier later, and no pointer needs any alignment.
// - The cos/sin tables are copied to shared memory once, so that a pass
//   does not begin with a miss.
//
// Measured and left out (PERF.md): asynchronous bulk stores
// (cp.async.bulk) of a pass, whose store engine was slower than plain
// stores and whose histogram needs a zeroing step of its own; points staged
// in shared memory; a warp's lanes dealt far apart in the list or equal bins
// of a warp merged with __match_any_sync, both against same-bin atomics of
// neighbours in the raster-ordered list, which turned out to cost nothing.
// HV_THETAS, HV_THREADS, HV_POINTS and HV_DRAIN are the sizes
// tools/torch_kernel_variants.py varies.
//
// rho reproduces what XLA's CPU backend computes for cos*x + sin*y + off:
// the first product fused with the rounded second one, then the offset
// added: __fadd_rn(__fmaf_rn(c, x, __fmul_rn(s, y)), off). The explicit
// intrinsics keep nvcc from contracting it any other way. rintf rounds half
// to even like jnp.round. cos/sin come from the literal jnp tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#ifndef HV_THETAS
#define HV_THETAS 4  // most thetas per pass; ops/kernels.py VOTE_THETAS
#endif
#ifndef HV_THREADS
#define HV_THREADS 1024
#endif
#ifndef HV_POINTS
#define HV_POINTS 8  // points a thread holds; ops/kernels.py VOTE_ROUND
#endif
#ifndef HV_DRAIN
#define HV_DRAIN 4  // words of the finished pass a thread stores per point
#endif

namespace {

constexpr int kThetas = HV_THETAS;
constexpr int kThreads = HV_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kPts = HV_POINTS;
constexpr int kRound = kThreads * kPts;  // points a block holds at a time
constexpr int kDrain = HV_DRAIN;
constexpr int kNTheta = 180;
constexpr int kMaxSmem = 232448;  // shared memory one block may use
// the tables' static shared memory, up to the alignment of the dynamic part
constexpr int kTrigSmem = (2 * kNTheta * 4 + 127) / 128 * 128;
constexpr int kMaxDevices = 64;

// devices on which the kernel of each thetas-per-pass has its attribute set
// (at its first launch there)
std::atomic<bool> g_attrs_set[kMaxDevices][kThetas + 1] = {};

// The points a thread holds: slot k is point (warp + k * kWarps) * 32 + lane
// of the round, so a warp's loads are coalesced.
struct Points {
  float x[kPts], y[kPts];
  uint8_t v[kPts];  // the valid byte, 0 for a slot past the end

  // the round's m points from the row pointers gx, gy, gv
  __device__ __forceinline__ void load(const float* gx, const float* gy,
                                       const uint8_t* gv, int m, int lane,
                                       int warp) {
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int i = (warp + k * kWarps) * 32 + lane;
      x[k] = i < m ? gx[i] : 0.0f;
      y[k] = i < m ? gy[i] : 0.0f;
      v[k] = i < m ? gv[i] : 0;
    }
  }
};

// A finished histogram on its way out: each step a thread takes its next
// kDrain words of src[0:end], leaving 0 there, and stores them to dst, so
// the histogram is clean once every thread has run out of steps.
struct Drain {
  int* src;
  int* dst;
  int at, end;

  __device__ __forceinline__ bool step() {
    if (at >= end) return false;
    int v[kDrain];
#pragma unroll
    for (int q = 0; q < kDrain; ++q)
      if (at + q * kThreads < end)
        v[q] = atomicExch(src + at + q * kThreads, 0);
#pragma unroll
    for (int q = 0; q < kDrain; ++q)
      if (at + q * kThreads < end) dst[at + q * kThreads] = v[q];
    at += kDrain * kThreads;
    return true;
  }
};

// The votes of the held points for kTh thetas from c0 on into
// h[kTh][n_rho]; after each point the drain takes a step, so the previous
// pass leaves between the votes of this one.
template <int kTh>
__device__ __forceinline__ void vote_points(const Points& pts, int* h,
                                            const float* cos_t,
                                            const float* sin_t, int c0,
                                            int n_rho, float off,
                                            Drain& drain) {
  float cs[kTh], sn[kTh];
#pragma unroll
  for (int j = 0; j < kTh; ++j) {
    cs[j] = cos_t[min(c0 + j, kNTheta - 1)];
    sn[j] = sin_t[min(c0 + j, kNTheta - 1)];
  }
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    if (pts.v[k]) {
#pragma unroll
      for (int j = 0; j < kTh; ++j) {
        const float rho = __fadd_rn(
            __fmaf_rn(cs[j], pts.x[k], __fmul_rn(sn[j], pts.y[k])), off);
        const int q = min(max((int)rintf(rho), 0), n_rho - 1);
        atomicAdd(h + j * n_rho + q, 1);
      }
    }
    drain.step();
  }
}

// kTh: thetas per pass (the plan's th_pass). A block's last pass may hold
// fewer; it then votes the missing ones into rows that are never stored.
template <int kTh>
__global__ void __launch_bounds__(kThreads, 1)
    hough_vote_kernel(const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      int* __restrict__ votes, int n, int n_rho, float off,
                      int groups) {
  extern __shared__ __align__(128) int hist[];  // [2][kTh * n_rho]
  // the tables, so that a pass does not start on a miss (kTrigSmem bytes)
  __shared__ float s_cos[kNTheta], s_sin[kNTheta];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x / groups, g = blockIdx.x % groups;
  const int th0 = g * kNTheta / groups, th1 = (g + 1) * kNTheta / groups;
  const long long row = (long long)t * n;
  const int n_rounds = (n + kRound - 1) / kRound;
  const int hist_words = kTh * n_rho;

  // the first round's points are on their way while the histograms are
  // zeroed
  Points pts;
  pts.load(xs + row, ys + row, valid + row, min(kRound, n), lane, warp);
  if (tid < kNTheta) s_cos[tid] = cos_t[tid], s_sin[tid] = sin_t[tid];
  for (int i = tid; i < 2 * hist_words; i += kThreads) hist[i] = 0;
  __syncthreads();

  Drain drain = {nullptr, nullptr, 0, 0};
  int pass = 0;
  for (int c0 = th0; c0 < th1; c0 += kTh, ++pass) {
    int* h = hist + (pass & 1) * hist_words;
    for (int r = 0; r < n_rounds; ++r) {
      // one round stays in the registers; more are loaded in every pass
      if (n_rounds > 1) {
        const long long at = row + (long long)r * kRound;
        pts.load(xs + at, ys + at, valid + at, min(kRound, n - r * kRound),
                 lane, warp);
      }
      vote_points<kTh>(pts, h, s_cos, s_sin, c0, n_rho, off, drain);
    }
    while (drain.step()) {
    }
    // this pass's votes are in and the histogram of the pass before is
    // clean again: hand this one to the drain, vote on in the other
    __syncthreads();
    drain = {h, votes + ((long long)t * kNTheta + c0) * n_rho, tid,
             min(kTh, th1 - c0) * n_rho};
  }
  while (drain.step()) {
  }
}

// launches the kernel whose thetas per pass are th_pass
template <int kTh>
cudaError_t launch(int th_pass, int dev, unsigned blocks, size_t smem,
                   cudaStream_t stream, const float* xs, const float* ys,
                   const uint8_t* valid, const float* cos_t,
                   const float* sin_t, int* votes, int n, int n_rho,
                   float off, int groups) {
  if constexpr (kTh > 1) {
    if (th_pass < kTh)
      return launch<kTh - 1>(th_pass, dev, blocks, smem, stream, xs, ys,
                             valid, cos_t, sin_t, votes, n, n_rho, off,
                             groups);
  }
  if (!(dev < kMaxDevices && g_attrs_set[dev][kTh].load())) {
    const cudaError_t err = cudaFuncSetAttribute(
        hough_vote_kernel<kTh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem - kTrigSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) g_attrs_set[dev][kTh].store(true);
  }
  hough_vote_kernel<kTh><<<blocks, kThreads, smem, stream>>>(
      xs, ys, valid, cos_t, sin_t, votes, n, n_rho, off, groups);
  return cudaGetLastError();
}

}  // namespace

// groups and th_pass are the launch plan of ops/kernels.py::vote_plan:
// blocks per frame and thetas per pass (at most HV_THETAS).
extern "C" int mdt_hough_vote(const void* xs, const void* ys,
                              const void* valid, const void* cos_t,
                              const void* sin_t, void* votes, int t_block,
                              int n, int n_rho, int rho_offset, int groups,
                              int th_pass, void* stream) {
  if (t_block <= 0) return 0;
  const long long smem = 8LL * th_pass * n_rho;
  if (n < 0 || n_rho < 1 || groups < 1 || groups > kNTheta || th_pass < 1 ||
      th_pass > kThetas || smem > kMaxSmem - kTrigSmem)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<kThetas>(
      th_pass, dev, (unsigned)(t_block * groups), (size_t)smem,
      (cudaStream_t)stream, (const float*)xs, (const float*)ys,
      (const uint8_t*)valid, (const float*)cos_t, (const float*)sin_t,
      (int*)votes, n, n_rho, (float)rho_offset, groups);
}
