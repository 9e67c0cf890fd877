// Segment-walk row pick: v[t, k, c] = planes[t, xmaj[t, k] ? 0 : 1,
// r[t, k, c], c], and 0 where r is outside [0, S).
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::walk_pick_pallas (:402,
// kernel _walk_pick_kernel :357 with _pick_row_bands :331). Spec:
// metdetpy_tpu/ops/hough.py::_picks_onehot, which this equals on every
// column (the Pallas kernel only on the columns the walk keeps).
//
// Bound by bytes: the r indices read and the [T, K, S] int32 output written
// (2.1 MB each at T=8, K=64, S=1024), xmaj and one plane byte per in-range
// column: 0.0013 ms at 3.35 TB/s. No arithmetic to speak of. At this size
// an empty kernel of the same grid (mdt_walk_pick_floor) takes longer than
// that, and the kernel is that launch plus two dependent trips to memory
// (r, then the plane byte it names). A plane byte also brings its whole
// 32-byte sector, and on a steep walk every column's byte lies in a sector
// of its own, so from device memory the kernel moves several times the
// bytes the bound counts.
//
// Design: one block per (frame, peak) row, so a thread divides nothing but
// the block index by K, once, and xmaj and the plane's base are read once
// per block. A thread takes kCols adjacent columns: r comes in and the
// picks go out as 16-byte words, and the kCols plane bytes go through the
// read-only path (__ldg). Where S is not a multiple of kCols or r or out is
// not 16-byte aligned the same kernel runs with one column per thread. The
// one-hot row reduction and the row bands of the TPU kernel have no purpose
// on this card.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WP_COLS
#define WP_COLS 4  // columns per thread on the vector path: 4 or 8
#endif

namespace {

constexpr int kMaxThreads = 1024;

template <int kCols>
__global__ void __launch_bounds__(kMaxThreads)
    walk_pick_kernel(const uint8_t* __restrict__ planes,
                     const int* __restrict__ r,
                     const uint8_t* __restrict__ xmaj, int* __restrict__ out,
                     int k, int s) {
  const int tk = blockIdx.x;  // frame * k + peak
  const int t = tk / k;
  const uint8_t* plane =
      planes + ((long long)t * 2 + (xmaj[tk] ? 0 : 1)) * s * s;
  const int* r_row = r + (long long)tk * s;
  int* out_row = out + (long long)tk * s;
  for (int c = threadIdx.x * kCols; c < s; c += blockDim.x * kCols) {
    int row[kCols], v[kCols];
    if constexpr (kCols == 1) {
      row[0] = r_row[c];
    } else {
#pragma unroll
      for (int q = 0; q < kCols; q += 4) {
        const int4 w = *(const int4*)(r_row + c + q);
        row[q] = w.x, row[q + 1] = w.y, row[q + 2] = w.z, row[q + 3] = w.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      v[j] = (unsigned)row[j] < (unsigned)s
                 ? (int)__ldg(plane + (long long)row[j] * s + c + j)
                 : 0;
    if constexpr (kCols == 1) {
      out_row[c] = v[0];
    } else {
#pragma unroll
      for (int q = 0; q < kCols; q += 4)
        *(int4*)(out_row + c + q) =
            make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
  }
}

// the grid of walk_pick_kernel and nothing else: what a launch costs
__global__ void walk_pick_floor_kernel(const uint8_t*, const int*,
                                       const uint8_t*, int*, int, int) {}

template <bool kFloor>
int launch(const void* planes, const void* r, const void* xmaj, void* out,
           int t_block, int k, int s, void* stream) {
  if (t_block <= 0 || k <= 0 || s <= 0) return 0;
  const bool vec = s % WP_COLS == 0 && ((uintptr_t)r & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const int per_thread = vec ? WP_COLS : 1;
  int threads = ((s + per_thread - 1) / per_thread + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const unsigned blocks = (unsigned)t_block * (unsigned)k;
  const auto kernel = kFloor ? walk_pick_floor_kernel
                      : vec  ? walk_pick_kernel<WP_COLS>
                             : walk_pick_kernel<1>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)r, (const uint8_t*)xmaj, (int*)out,
      k, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdt_walk_pick(const void* planes, const void* r,
                             const void* xmaj, void* out, int t_block, int k,
                             int s, void* stream) {
  return launch<false>(planes, r, xmaj, out, t_block, k, s, stream);
}

// An empty kernel on the grid mdt_walk_pick would launch for these
// arguments: the least time any kernel of that grid takes.
extern "C" int mdt_walk_pick_floor(const void* planes, const void* r,
                                   const void* xmaj, void* out, int t_block,
                                   int k, int s, void* stream) {
  return launch<true>(planes, r, xmaj, out, t_block, k, s, stream);
}
