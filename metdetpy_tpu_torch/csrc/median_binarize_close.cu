// 3x3 median -> (> thr[t]) ? 255 : 0 -> 3x3 dilate -> 3x3 erode over a
// [T, H, W] uint8 block.
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::_fused_pallas (:126, kernel
// _kernel :71). Spec: filters.median3x3 -> binary_threshold -> close3x3,
// which equals cv2 (medianBlur with replicated borders; dilate reading 0 and
// erode reading 255 outside the frame, as _kernel :99-121).
//
// Bound by bytes: one u8 frame read and one written, 66 MB for a 64-frame
// 960x540 block, 0.0198 ms at 3.35 TB/s. The operations this design does,
// 14 per pixel (the threshold: 1; the 3x3 count of the pixels above it,
// separable: 4; count >= 5: 1; the close as OR/AND, separable: 8), take
// 0.0069 ms at 67 T operations/s.
//
// The median is never formed: only its threshold is kept, and the median of
// nine values exceeds thr exactly when at least five of them do. So the
// kernel thresholds each pixel first and counts, over the 3x3 window with
// the replicated border, the pixels above thr (tests/
// test_torch_port_kernel_algebra.py holds this against median3x3). All of
// it is packed byte arithmetic, four pixels to a 32-bit word:
// - threshold: x > thr is the carry out of x + (255 - thr), formed per byte
//   as majority(x7, c7, bit 7 of (x & 0x7F) + (c & 0x7F)) -- one LOP3;
// - count: the 0/1 bytes of three rows added (<= 3), then each byte and its
//   left and right neighbours added (<= 9); count >= 5 is bit 7 of
//   count + 123;
// - close: on bytes that are 0 or 0x80, dilate is the OR of the three rows
//   and of the word shifted one byte left and right, and erode the AND.
// Layout. One warp owns a strip of kStripCols = 480 columns and tile_rows
// rows of one frame; lane l holds the 16 columns starting at
// strip * 480 + 16 * (l - 1), so lanes 1..30 produce the output and lanes 0
// and 31 are the strip's halo. The host picks tile_rows so that every warp
// of the launch is resident at once (one wave). Each lane walks down its
// rows, two at a time: its 16-byte word of each input row (row clamped into
// the frame) arrives in its own slots of a shared-memory ring by cp.async,
// kStages rows ahead, so no barrier is needed; neighbour bytes come from
// byte permutes of the adjacent words, across lanes by one shuffle. The
// rows kept for the next step swap roles instead of moving.
// Borders: a lane whose columns leave the frame loads the clamped column
// (the median's replicated edge); thresholded bytes outside the frame count
// as the edge pixel's, binary bytes outside it are 0 and dilated bytes
// 0x80. Where w % 16 != 0 or a pointer is not 16-byte aligned, lanes load
// and store their bytes one by one.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "cp_async.cuh"

namespace {

constexpr int kStages = 4;      // rows in flight per lane
constexpr int kRing = 8;        // >= kStages + the two rows being read
constexpr int kOutLanes = 30;
constexpr int kStripCols = 16 * kOutLanes;
constexpr int kMinTileRows = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kLow7 = 0x7F7F7F7Fu;
constexpr uint32_t kHigh = 0x80808080u;
constexpr uint32_t kOnes = 0x01010101u;
constexpr int kMaxDevices = 64;

// warps of this kernel resident at once on each device (SMs x warps per
// SM), worked out at the first launch on it; 0 until then
std::atomic<int> g_resident[kMaxDevices] = {};

// 1 in each byte of x above the threshold whose complement 255 - thr is
// replicated in c (c_low = c & 0x7F7F7F7F): the carry out of x + c
__device__ __forceinline__ uint32_t above(uint32_t x, uint32_t c,
                                          uint32_t c_low) {
  const uint32_t s = (x & kLow7) + c_low;
  return (((x & c) | (x & s) | (c & s)) >> 7) & kOnes;
}

// the byte left (0x6543) or right (0x4321) of each byte of word c, with
// a = the word before it or b = the word after it
__device__ __forceinline__ uint32_t left_bytes(uint32_t a, uint32_t c) {
  return __byte_perm(a, c, 0x6543);
}
__device__ __forceinline__ uint32_t right_bytes(uint32_t c, uint32_t b) {
  return __byte_perm(c, b, 0x4321);
}

// each byte combined with its left and right neighbours along the row:
// sum (count), OR (dilate) or AND (erode)
enum class Along { kSum, kOr, kAnd };

template <Along kOp>
__device__ __forceinline__ void along(const uint32_t (&v)[4],
                                      uint32_t (&out)[4]) {
  const uint32_t prev = __shfl_up_sync(kFull, v[3], 1);
  const uint32_t next = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t l = left_bytes(k ? v[k - 1] : prev, v[k]);
    const uint32_t r = right_bytes(v[k], k < 3 ? v[k + 1] : next);
    out[k] = kOp == Along::kSum  ? v[k] + l + r
             : kOp == Along::kOr ? (v[k] | l | r)
                                 : (v[k] & l & r);
  }
}

}  // namespace

__global__ void __launch_bounds__(32)
    median_binarize_close_kernel(const uint8_t* __restrict__ in,
                                 const uint8_t* __restrict__ thr,
                                 uint8_t* __restrict__ out, int h, int w,
                                 int n_strips, int n_tiles, int tile_rows,
                                 bool vec) {
  __shared__ uint4 ring[kRing][32];
  const int lane = threadIdx.x;
  int task = blockIdx.x;
  const int tile = task % n_tiles;
  task /= n_tiles;
  const int strip = task % n_strips;
  const int t = task / n_strips;
  const int y0 = tile * tile_rows;
  const int y1 = min(y0 + tile_rows, h);
  const int c0 = strip * kStripCols + 16 * (lane - 1);  // first column
  const long long frame = (long long)t * h * w;
  const uint8_t* src = in + frame;
  uint8_t* dst = out + frame;
  const bool inside = c0 >= 0 && c0 + 16 <= w;
  const bool outside = c0 + 16 <= 0 || c0 >= w;
  const bool wide = vec && inside;
  const bool writes = lane >= 1 && lane <= kOutLanes && c0 < w;

  // bit 7 of the bytes whose column lies in the frame (in) or not (out)
  uint32_t col_in[4], col_out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col_in[k] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + 4 * k + b;
      if (c >= 0 && c < w) col_in[k] |= 0x80u << (8 * b);
    }
    col_out[k] = col_in[k] ^ kHigh;
  }
  const uint32_t c_thr = (255u - thr[t]) * kOnes;
  const uint32_t c_low = c_thr & kLow7;

  const int r_first = y0 - 3;
  const int n_rows = (y1 - y0) + 6;
  auto fetch = [&](int i) {
    if (i < n_rows) {
      const int gy = min(max(r_first + i, 0), h - 1);
      const uint8_t* row = src + (long long)gy * w;
      uint4* slot = &ring[i % kRing][lane];
      if (wide) {
        cp_async16(slot, row + c0);
      } else if (outside) {
        const uint32_t v = row[min(max(c0, 0), w - 1)] * kOnes;
        *slot = make_uint4(v, v, v, v);
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          v[b >> 2] |= (uint32_t)row[min(max(c0 + b, 0), w - 1)]
                       << (8 * (b & 3));
        *slot = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    cp_async_commit();  // one group per row, empty past the end
  };

  // Step i: input row r = r_first + i arrives as v; ga / gb hold the 0/1
  // bytes above thr of the older / newer row before it, p / q the binary
  // rows m-2 / m-1 of count row m = r - 1, d0 / d1 the dilated rows m-3 /
  // m-2. The step overwrites the older of each pair with its new row. The
  // first six steps fill the pipeline: 0-1 only threshold, 2-3 also count,
  // 4-5 also dilate.
  auto step = [&](int i, const uint4& v, uint32_t (&ga)[4],
                  const uint32_t (&gb)[4], uint32_t (&p)[4],
                  const uint32_t (&q)[4], uint32_t (&d0)[4],
                  const uint32_t (&d1)[4]) {
    uint32_t vert[4], cnt[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t g = above(word(v, k), c_thr, c_low);
      vert[k] = ga[k] + gb[k] + g;  // column counts of rows r-2 .. r
      ga[k] = g;
    }
    if (i < 2) return;

    // count row m -> binary, 0x80 where at least 5 of the 9 are above thr
    // (0 outside the frame)
    const int m = r_first + i - 1;
    const bool m_in = m >= 0 && m < h;
    along<Along::kSum>(vert, cnt);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = m_in ? (cnt[k] + 0x7B7B7B7Bu) & col_in[k] : 0u;
      vert[k] = p[k] | q[k] | b;
      p[k] = b;
    }
    if (i < 4) return;

    // dilated row m - 1 (0x80 outside the frame)
    uint32_t dw[4];
    along<Along::kOr>(vert, dw);
    const bool d_in = m - 1 >= 0 && m - 1 < h;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dw[k] = d_in ? dw[k] | col_out[k] : kHigh;
      vert[k] = d0[k] & d1[k] & dw[k];
      d0[k] = dw[k];
    }
    if (i < 6) return;

    // eroded row m - 2 = r - 3: the output, 0x80 -> 255
    uint32_t ew[4];
    along<Along::kAnd>(vert, ew);
    if (i < n_rows && writes) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ew[k] = (ew[k] >> 7) * 0xFFu;
      uint8_t* row = dst + (long long)(m - 2) * w + c0;
      if (wide) {
        *reinterpret_cast<uint4*>(row) = make_uint4(ew[0], ew[1], ew[2], ew[3]);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (c0 + b < w) row[b] = (uint8_t)(ew[b >> 2] >> (8 * (b & 3)));
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) fetch(i);

  uint32_t ga[4] = {}, gb[4] = {};  // thresholded rows
  uint32_t pa[4] = {}, pb[4] = {};  // binary rows
  uint32_t da[4] = {}, db[4] = {};  // dilated rows
  // an odd row count (a short last tile) gets one more step, not stored
  for (int i = 0; i < n_rows; i += 2) {
    cp_async_wait<kStages - 2>();  // rows i and i + 1 have landed
    const uint4 v0 = ring[i % kRing][lane];
    const uint4 v1 = ring[(i + 1) % kRing][lane];
    fetch(i + kStages);
    fetch(i + 1 + kStages);
    step(i, v0, ga, gb, pa, pb, da, db);
    step(i + 1, v1, gb, ga, pb, pa, db, da);
  }
}

extern "C" int mdt_median_binarize_close(const void* in, const void* thr,
                                         void* out, int t_block, int h,
                                         int w, void* stream) {
  if (t_block <= 0 || h <= 0 || w <= 0) return 0;
  const int n_strips = (w + kStripCols - 1) / kStripCols;
  // tiles per frame strip: as many as fit one wave of resident warps
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < kMaxDevices ? g_resident[dev].load() : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, median_binarize_close_kernel, 32, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
    if (dev < kMaxDevices) g_resident[dev].store(resident);
  }
  const long long columns = (long long)t_block * n_strips;
  long long tiles = resident / columns;
  tiles = tiles < 1 ? 1 : tiles;
  int tile_rows = (int)((h + tiles - 1) / tiles);
  tile_rows = tile_rows < kMinTileRows ? kMinTileRows : tile_rows;
  tile_rows += tile_rows & 1;  // an even row count: no idle step
  const int n_tiles = (h + tile_rows - 1) / tile_rows;
  const long long tasks = columns * n_tiles;
  if (tasks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const bool vec = w % 16 == 0 && ((uintptr_t)in & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  median_binarize_close_kernel<<<(unsigned)tasks, 32, 0,
                                 (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const uint8_t*)thr, (uint8_t*)out, h, w, n_strips,
      n_tiles, tile_rows, vec);
  return (int)cudaGetLastError();
}
