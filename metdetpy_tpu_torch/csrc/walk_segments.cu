// The Hough segment walk around walk_pick: the corner planes it reads, the
// plane row of each walk column (its input), and the run analysis of its
// picks. Three kernels:
//
//   corner_planes: [T, H, W] 0/1 u8 frames -> [T, 2, S, S] u8 planes;
//     plane 0 row y, column x holds img[y-1, x-1] | img[y-1, x] << 1 |
//     img[y, x-1] << 2 | img[y, x] << 3 (0 outside the frame), plane 1 is
//     plane 0 transposed with bits 1 and 2 swapped, i.e. the same packing
//     of img.T. Spec: metdetpy_tpu_torch/ops/hough.py::corner_planes.
//   walk_geom: each peak's (theta_idx, rho_idx) -> r [T, K, S] i32, the
//     plane row of walk column c, and xmaj [T, K]. Spec: hough.walk_geom's
//     r and xmaj.
//   walk_finish: walk_pick's picks v [T, K, S], the peaks, peak_ok and the
//     frame's max_gap -> lines [T, K, 4] i32 (0 where not ok) and ok [T, K].
//     Spec: hough.finish_segments on hough.walk_geom, then the zeroing of
//     hough_lines_batch.
//
// They replace no TPU kernel: the JAX package leaves this glue to XLA
// (metdetpy_tpu/ops/hough.py::pack_corners :240, _walk_geom :354,
// _finish_segments :406), which fuses it. In plain PyTorch it was ~1,740
// records a 64-frame block, each an elementwise or scan pass over
// [8, 64, 1024]; here it is 3 launches a chunk of 8 frames beside
// walk_pick's one.
//
// Bounds at 960x540 (T = 8, K = 64, S = 1024), by bytes at 3.35 TB/s:
// corner_planes reads 4.15 MB and writes 16.8 MB (0.0062 ms); walk_geom
// writes r (2.10 MB) and reads 8 KB of peaks (0.0006 ms); walk_finish reads
// the picks of the in-range columns of ok peaks (at most 2.10 MB) and
// writes 8 KB of lines (at most 0.0006 ms). Their arithmetic (a few dozen
// f32 and two f64 operations a column) is far below the bytes' time. At
// these sizes the launches themselves, ~2 us each, are most of the time.
//
// Exactness: every result equals the spec bit for bit (and through it the
// JAX package). The spec's float arithmetic is written with the
// round-to-nearest intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn),
// which nvcc never contracts into a fused multiply-add, so the file needs
// no -fmad=false. f32.fma_f32 (a float64 product, a float64 sum and one
// cast to float32, i.e. two roundings) is __dmul_rn, __dadd_rn and
// __double2float_rn; torch.round is rintf (half to even); the constants
// are the float32 values torch compares with (0.05f, n_steps / 2); sin and
// cos come from the tables of f32.trig_tables, never recomputed. The
// per-peak geometry is one __device__ function (peak_geom) that walk_geom
// and walk_finish both call, so the two cannot disagree.
//
// Design. corner_planes: a block takes a 64 x 64 tile of plane 0 and the
// transposed tile of plane 1; the 65 x 65 input pixels it needs go to
// shared memory once (0 outside the frame, which gives the zero padding up
// to S for free), and both tiles are written row by row, 4 bytes a thread,
// so reads and writes stay coalesced. walk_geom: one block per (frame,
// peak); a thread works out 4 adjacent columns and stores them as one
// 16-byte word. walk_finish: one block per (frame, peak), so each block's
// peak is one set of scalars in registers; a block whose peak is not ok
// writes zeros and leaves. A thread takes `per` consecutive walk steps (step
// j is column S-1-j where the walk runs backwards: an index map, no flipped
// copy), works out each column's sample, bilinear fractions and range test
// again from the peak's scalars, and keeps its on/new-run flags as bit
// masks. The two running maxima of finish_segments (the last on step before
// each step, the start of its run) are block-wide exclusive max-scans: warp
// shuffles, then one shared-memory pass over the warps' totals. The longest
// run is a block argmax that takes the lowest walk step on ties, as
// torch.argmax does.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -1000000;       // finish_segments' "no step" index
constexpr float kWeight = 0.05f;     // the bilinear acceptance threshold
constexpr int kTile = 64;            // corner_planes' output tile side
constexpr int kPlaneThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 32;          // walk steps a thread, one bit each

// ---------------------------------------------------------------------------
// The spec's arithmetic

// f32.fma_f32: round_f32(float64(a) * float64(b) + float64(c))
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

struct PeakGeom {
  float vx, vy;    // unit L-inf direction
  float px, py;    // walk center
  float dirn;      // major-axis direction, exactly +-1
  float floor_a;   // floor of the major-axis coordinate of the center
  bool xmaj;       // the walk steps along x
};

// hough.walk_geom's per-peak scalars, operation by operation
__device__ PeakGeom peak_geom(const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t, long long th,
                              long long rh, int rho_offset, int h, int w) {
  const float c = __ldg(cos_t + th), s = __ldg(sin_t + th);
  const float rho = __fsub_rn((float)rh, (float)rho_offset);
  const float m = fmaxf(fabsf(s), fabsf(c));
  PeakGeom g;
  g.vx = __fdiv_rn(-s, m);
  g.vy = __fdiv_rn(c, m);
  const float cx = __fmul_rn(0.5f, (float)(w - 1));
  const float cy = __fmul_rn(0.5f, (float)(h - 1));
  const float fx = __fmul_rn(c, rho), fy = __fmul_rn(s, rho);
  const float proj_x =
      fma_f32(fma_f32(-s, rho, cy), c, __fmul_rn(__fsub_rn(cx, fx), -s));
  const float proj_y =
      fma_f32(__fsub_rn(cy, fy), c, __fmul_rn(fma_f32(-c, rho, cx), -s));
  g.px = fma_f32(proj_x, -s, fx);
  g.py = fma_f32(proj_y, c, fy);
  g.xmaj = fabsf(s) >= fabsf(c);
  g.dirn = g.xmaj ? g.vx : g.vy;
  g.floor_a = floorf(g.xmaj ? g.px : g.py);
  return g;
}

// the walk step t of plane column col: (col - 1 - floor(a)) * dirn
__device__ __forceinline__ float walk_t(const PeakGeom& g, int col) {
  return __fmul_rn(__fsub_rn(__fsub_rn((float)col, 1.0f), g.floor_a),
                   g.dirn);
}

struct Sample {
  float fx, fy;   // bilinear fractions
  int xi, yi;     // plane coordinates (floor + 1)
};

__device__ __forceinline__ Sample sample_at(const PeakGeom& g, float t) {
  const float x = fma_f32(t, g.vx, g.px), y = fma_f32(t, g.vy, g.py);
  const float x0 = floorf(x), y0 = floorf(y);
  return {__fsub_rn(x, x0), __fsub_rn(y, y0), (int)x0 + 1, (int)y0 + 1};
}

// ---------------------------------------------------------------------------
// corner_planes

template <bool kVec>
__device__ __forceinline__ void store_word(uint8_t* plane, int s, int row,
                                           int col, uint32_t word) {
  if (row >= s) return;
  uint8_t* p = plane + (long long)row * s + col;
  if constexpr (kVec) {
    if (col < s) *(uint32_t*)p = word;   // s % 4 == 0: all 4 or none
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < s) p[q] = (uint8_t)(word >> (8 * q));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kPlaneThreads)
    corner_planes_kernel(const uint8_t* __restrict__ imgs,
                         uint8_t* __restrict__ planes, int h, int w, int s) {
  // tile[i][j] = img[y0 - 1 + i, x0 - 1 + j] != 0, 0 outside the frame;
  // a row of 65 bytes keeps the transposed reads on distinct banks
  __shared__ uint8_t tile[kTile + 1][kTile + 1];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const long long b = blockIdx.z;
  const uint8_t* img = imgs + b * h * w;
  for (int i = threadIdx.x; i < (kTile + 1) * (kTile + 1);
       i += kPlaneThreads) {
    const int ti = i / (kTile + 1), tj = i % (kTile + 1);
    const int y = y0 - 1 + ti, x = x0 - 1 + tj;
    tile[ti][tj] =
        y >= 0 && y < h && x >= 0 && x < w && img[(long long)y * w + x];
  }
  __syncthreads();
  uint8_t* p0 = planes + b * 2 * s * s;
  uint8_t* p1 = p0 + (long long)s * s;
  const int g = (threadIdx.x & 15) * 4;   // the thread's first column
  for (int i = threadIdx.x >> 4; i < kTile; i += kPlaneThreads / 16) {
    uint32_t a = 0, t = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = g + q;
      // plane 0 at (y0 + i, x0 + j)
      a |= (uint32_t)(tile[i][j] | tile[i][j + 1] << 1 |
                      tile[i + 1][j] << 2 | tile[i + 1][j + 1] << 3)
           << (8 * q);
      // plane 1 at (x0 + i, y0 + j): plane 0 at (y0 + j, x0 + i), bits 1
      // and 2 swapped
      t |= (uint32_t)(tile[j][i] | tile[j + 1][i] << 1 |
                      tile[j][i + 1] << 2 | tile[j + 1][i + 1] << 3)
           << (8 * q);
    }
    store_word<kVec>(p0, s, y0 + i, x0 + g, a);
    store_word<kVec>(p1, s, x0 + i, y0 + g, t);
  }
}

// ---------------------------------------------------------------------------
// walk_geom

template <int kCols>
__global__ void __launch_bounds__(kMaxThreads)
    walk_geom_kernel(const long long* __restrict__ theta_idx,
                     const long long* __restrict__ rho_idx,
                     const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t, int* __restrict__ r,
                     uint8_t* __restrict__ xmaj, int s, int rho_offset, int h,
                     int w) {
  const int tk = blockIdx.x;   // frame * K + peak
  const PeakGeom g = peak_geom(cos_t, sin_t, theta_idx[tk], rho_idx[tk],
                               rho_offset, h, w);
  if (threadIdx.x == 0) xmaj[tk] = g.xmaj;
  int* row = r + (long long)tk * s;
  for (int c = threadIdx.x * kCols; c < s; c += blockDim.x * kCols) {
    int v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const Sample q = sample_at(g, walk_t(g, c + j));
      v[j] = g.xmaj ? q.yi : q.xi;
    }
    if constexpr (kCols == 4)
      *(int4*)(row + c) = make_int4(v[0], v[1], v[2], v[3]);
    else
      row[c] = v[0];
  }
}

// ---------------------------------------------------------------------------
// walk_finish

// max of x over the threads before this one, in thread order (kNeg for
// thread 0): a warp's inclusive scan by shuffles, then one pass of warp 0
// over the warps' totals in shared memory
__device__ int block_exclusive_max(int x, int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int a = lane < (int)(blockDim.x >> 5) ? tot[lane] : kNeg;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, a, d);
      if (lane >= d) a = max(a, y);
    }
    __syncwarp();
    tot[lane] = a;   // the max over warps 0..lane
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = kNeg;
  if (warp > 0) excl = max(excl, tot[warp - 1]);
  return excl;
}

// (len, step, start) of the longest run: the largest len, the lowest step
// among equals; the result in thread 0
__device__ __forceinline__ void take_better(int& len, int& step, int& start,
                                            int o_len, int o_step,
                                            int o_start) {
  if (o_len > len || (o_len == len && o_step < step)) {
    len = o_len;
    step = o_step;
    start = o_start;
  }
}

__device__ void block_argmax(int& len, int& step, int& start, int* s_len,
                             int* s_step, int* s_start) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    take_better(len, step, start, __shfl_down_sync(kFull, len, d),
                __shfl_down_sync(kFull, step, d),
                __shfl_down_sync(kFull, start, d));
  if (lane == 0) {
    s_len[warp] = len;
    s_step[warp] = step;
    s_start[warp] = start;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < (int)(blockDim.x >> 5);
    len = has ? s_len[lane] : INT_MIN;
    step = has ? s_step[lane] : INT_MAX;
    start = has ? s_start[lane] : kNeg;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      take_better(len, step, start, __shfl_down_sync(kFull, len, d),
                  __shfl_down_sync(kFull, step, d),
                  __shfl_down_sync(kFull, start, d));
  }
}

// finish_segments' endpoint of walk step j: the sample rounded half to
// even and clamped to the frame
__device__ __forceinline__ void endpoint(const PeakGeom& g, int j, int s,
                                         bool rev, int h, int w, int* out) {
  j = min(max(j, 0), s - 1);
  const float t = walk_t(g, rev ? s - 1 - j : j);
  out[0] = min(max((int)rintf(fma_f32(t, g.vx, g.px)), 0), w - 1);
  out[1] = min(max((int)rintf(fma_f32(t, g.vy, g.py)), 0), h - 1);
}

__global__ void __launch_bounds__(kMaxThreads)
    walk_finish_kernel(const int* __restrict__ v,
                       const long long* __restrict__ theta_idx,
                       const long long* __restrict__ rho_idx,
                       const uint8_t* __restrict__ peak_ok,
                       const float* __restrict__ max_gap,
                       const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t,
                       int* __restrict__ lines, uint8_t* __restrict__ ok,
                       int k, int s, int per, int rho_offset, int n_steps,
                       int h, int w, int min_len) {
  __shared__ int s_on[32], s_new[32], s_len[32], s_step[32], s_start[32];
  const int tk = blockIdx.x;   // frame * K + peak
  int* line = lines + 4LL * tk;
  if (!peak_ok[tk]) {          // the same for the whole block
    if (threadIdx.x < 4) line[threadIdx.x] = 0;
    if (threadIdx.x == 0) ok[tk] = 0;
    return;
  }
  const PeakGeom g = peak_geom(cos_t, sin_t, theta_idx[tk], rho_idx[tk],
                               rho_offset, h, w);
  const float half = __fmul_rn(0.5f, (float)n_steps);
  const float gap_max = max_gap[tk / k];
  const int* v_row = v + (long long)tk * s;
  const bool rev = g.dirn < 0.0f;   // walk order runs down the columns
  const int j0 = threadIdx.x * per;
  const int n = max(0, min(per, s - j0));

  // the accepted samples (p == 1) of the thread's walk steps
  unsigned on = 0;
  int last_on = kNeg;
  for (int i = 0; i < n; ++i) {
    const int col = rev ? s - 1 - (j0 + i) : j0 + i;
    const float t = walk_t(g, col);
    const Sample q = sample_at(g, t);
    if (q.xi < 0 || q.xi > w || q.yi < 0 || q.yi > h || !(t >= -half) ||
        !(t < half))
      continue;
    const int bits = v_row[col];
    const float wx0 = __fsub_rn(1.0f, q.fx), wy0 = __fsub_rn(1.0f, q.fy);
    const float w10 = __fmul_rn(q.fx, wy0);   // wx1 * wy0
    const float w01 = __fmul_rn(wx0, q.fy);   // wx0 * wy1
    // the transposed plane (y-major) has bits 1 and 2 swapped
    const bool p = ((bits & 1) && __fmul_rn(wx0, wy0) > kWeight) ||
                   ((bits & 2) && (g.xmaj ? w10 : w01) > kWeight) ||
                   ((bits & 4) && (g.xmaj ? w01 : w10) > kWeight) ||
                   ((bits & 8) && __fmul_rn(q.fx, q.fy) > kWeight);
    if (p) {
      on |= 1u << i;
      last_on = j0 + i;
    }
  }

  // a run starts at an on step more than max_gap after the previous on
  int prev = block_exclusive_max(last_on, s_on);
  unsigned fresh = 0;
  int last_new = kNeg;
  for (int i = 0; i < n; ++i) {
    if (!(on >> i & 1u)) continue;
    const int j = j0 + i;
    if ((float)(j - prev - 1) > gap_max) {
      fresh |= 1u << i;
      last_new = j;
    }
    prev = j;
  }

  // each on step's run length; the longest, the first among equals
  int start = block_exclusive_max(last_new, s_new);
  int best_len = INT_MIN, best_step = INT_MAX, best_start = kNeg;
  for (int i = 0; i < n; ++i) {
    const int j = j0 + i;
    if (fresh >> i & 1u) start = j;
    const int len = (on >> i & 1u) ? j - start : -1;
    if (len > best_len) {
      best_len = len;
      best_step = j;
      best_start = start;
    }
  }
  block_argmax(best_len, best_step, best_start, s_len, s_step, s_start);

  if (threadIdx.x == 0) {
    const bool good = best_len >= min_len;
    int out[4] = {0, 0, 0, 0};
    if (good) {
      endpoint(g, best_start, s, rev, h, w, out);
      endpoint(g, best_step, s, rev, h, w, out + 2);
    }
    *(int4*)line = make_int4(out[0], out[1], out[2], out[3]);
    ok[tk] = good;
  }
}

// threads a (frame, peak) block of walk_geom and walk_finish: 4 columns a
// thread, at least a warp, at most kMaxThreads
int row_threads(int s) {
  const int t = ((s + 3) / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

extern "C" int mdt_corner_planes(const void* imgs, void* planes, int t,
                                 int h, int w, int s, void* stream) {
  if (t < 0 || t > 65535 || h < 1 || w < 1 || h >= s || w >= s)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  const int tiles = (s + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, t);
  const auto kernel = (s % 4 == 0 && ((uintptr_t)planes & 3) == 0)
                          ? corner_planes_kernel<true>
                          : corner_planes_kernel<false>;
  kernel<<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)imgs, (uint8_t*)planes, h, w, s);
  return (int)cudaGetLastError();
}

extern "C" int mdt_walk_geom(const void* theta_idx, const void* rho_idx,
                             const void* cos_t, const void* sin_t, void* r,
                             void* xmaj, int t, int k, int s, int rho_offset,
                             int h, int w, void* stream) {
  if (t < 0 || k < 0 || s < 1) return (int)cudaErrorInvalidValue;
  if (t == 0 || k == 0) return 0;
  const auto kernel = (s % 4 == 0 && ((uintptr_t)r & 15) == 0)
                          ? walk_geom_kernel<4>
                          : walk_geom_kernel<1>;
  kernel<<<(unsigned)t * (unsigned)k, row_threads(s), 0,
           (cudaStream_t)stream>>>(
      (const long long*)theta_idx, (const long long*)rho_idx,
      (const float*)cos_t, (const float*)sin_t, (int*)r, (uint8_t*)xmaj, s,
      rho_offset, h, w);
  return (int)cudaGetLastError();
}

extern "C" int mdt_walk_finish(const void* v, const void* theta_idx,
                               const void* rho_idx, const void* peak_ok,
                               const void* max_gap, const void* cos_t,
                               const void* sin_t, void* lines, void* ok,
                               int t, int k, int s, int rho_offset,
                               int n_steps, int h, int w, int min_len,
                               void* stream) {
  if (t < 0 || k < 0 || s < 1 || ((uintptr_t)lines & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = row_threads(s);
  const int per = (s + threads - 1) / threads;
  if (per > kMaxPer) return (int)cudaErrorInvalidValue;
  if (t == 0 || k == 0) return 0;
  walk_finish_kernel<<<(unsigned)t * (unsigned)k, threads, 0,
                       (cudaStream_t)stream>>>(
      (const int*)v, (const long long*)theta_idx, (const long long*)rho_idx,
      (const uint8_t*)peak_ok, (const float*)max_gap, (const float*)cos_t,
      (const float*)sin_t, (int*)lines, (uint8_t*)ok, k, s, per, rho_offset,
      n_steps, h, w, min_len);
  return (int)cudaGetLastError();
}
