// Native host runtime for MetDetPy-TPU: uint8 preprocess/merge kernels.
//
// Role parity: the reference runs per-frame preprocess (resize, gray
// conversion, exposure merge) through Python/OpenCV calls in its loader
// threads (reference MetLib/videoloader.py:497-631, MetLib/imgproc.py:
// 70-158). Here the whole decode chunk is resized, gray-converted and
// exposure-max-merged into TPU-ready [T, H, W] block slots in ONE C call
// with the GIL released -- under active TPU-client streaming, per-frame
// Python work measured 10-40x slower than the same work batched in C.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------
// Exact 2:1 u8 downscale fast path
// ---------------------------------------------------------------------
//
// At an exact 2:1 ratio cv2's INTER_LINEAR fixed-point math collapses to
// the 2x2 box average (a+b+c+d+2)>>2 (coefficients 1024/1024 on both
// axes: ((1024*((a+b)*1024>>4))>>16) = a+b exactly), so the generic
// two-pass resize can be replaced by one fused pass. The AVX2 variant
// processes 16 output pixels per iteration via pairwise maddubs sums;
// bit-exactness vs cv2 is pinned in tests/test_native_resize.py.

void resize_half_u8_scalar(const uint8_t* src, int sw, uint8_t* dst,
                           int dh, int dw) {
  for (int dy = 0; dy < dh; ++dy) {
    const uint8_t* r0 = src + static_cast<size_t>(2 * dy) * sw;
    const uint8_t* r1 = r0 + sw;
    uint8_t* d = dst + static_cast<size_t>(dy) * dw;
    for (int dx = 0; dx < dw; ++dx) {
      d[dx] = static_cast<uint8_t>(
          (r0[2 * dx] + r0[2 * dx + 1] + r1[2 * dx] + r1[2 * dx + 1] + 2)
          >> 2);
    }
  }
}

#if defined(__AVX2__)
void resize_half_u8(const uint8_t* src, int sw, uint8_t* dst,
                    int dh, int dw) {
  const __m256i ones = _mm256_set1_epi8(1);
  const __m256i two = _mm256_set1_epi16(2);
  for (int dy = 0; dy < dh; ++dy) {
    const uint8_t* r0 = src + static_cast<size_t>(2 * dy) * sw;
    const uint8_t* r1 = r0 + sw;
    uint8_t* d = dst + static_cast<size_t>(dy) * dw;
    int dx = 0;
    for (; dx + 32 <= dw; dx += 32) {
      __m256i a0 = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(r0 + 2 * dx));
      __m256i a1 = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(r0 + 2 * dx + 32));
      __m256i b0 = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(r1 + 2 * dx));
      __m256i b1 = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(r1 + 2 * dx + 32));
      __m256i s0 = _mm256_srli_epi16(
          _mm256_add_epi16(
              _mm256_add_epi16(_mm256_maddubs_epi16(a0, ones),
                               _mm256_maddubs_epi16(b0, ones)),
              two),
          2);
      __m256i s1 = _mm256_srli_epi16(
          _mm256_add_epi16(
              _mm256_add_epi16(_mm256_maddubs_epi16(a1, ones),
                               _mm256_maddubs_epi16(b1, ones)),
              two),
          2);
      __m256i packed = _mm256_permute4x64_epi64(
          _mm256_packus_epi16(s0, s1), 0xD8);
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(d + dx), packed);
    }
    for (; dx + 16 <= dw; dx += 16) {
      __m256i a = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(r0 + 2 * dx));
      __m256i b = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(r1 + 2 * dx));
      __m256i s = _mm256_add_epi16(
          _mm256_add_epi16(_mm256_maddubs_epi16(a, ones),
                           _mm256_maddubs_epi16(b, ones)),
          two);
      s = _mm256_srli_epi16(s, 2);
      __m128i packed = _mm_packus_epi16(_mm256_castsi256_si128(s),
                                        _mm256_extracti128_si256(s, 1));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(d + dx), packed);
    }
    for (; dx < dw; ++dx) {
      d[dx] = static_cast<uint8_t>(
          (r0[2 * dx] + r0[2 * dx + 1] + r1[2 * dx] + r1[2 * dx + 1] + 2)
          >> 2);
    }
  }
}
#else
void resize_half_u8(const uint8_t* src, int sw, uint8_t* dst,
                    int dh, int dw) {
  resize_half_u8_scalar(src, sw, dst, dh, dw);
}
#endif

// ---------------------------------------------------------------------
// Bilinear u8 resize, bit-exact with cv2 INTER_LINEAR (1 or 3 channels)
// ---------------------------------------------------------------------
//
// Replicates OpenCV's fixed-point bilinear path for 8u (imgproc
// resize.cpp): 11-bit coefficients (INTER_RESIZE_COEF_SCALE = 2048),
// horizontal pass accumulating int rows, vertical combine
//   dst = uchar((((b0*(r0>>4)) >> 16) + ((b1*(r1>>4)) >> 16) + 2) >> 2)
// with the same src-coordinate mapping and border clamping. Exactness is
// asserted against cv2 in tests/test_native_resize.py.

struct ResizePlan {
  std::vector<int> xofs;       // src column index per dst column
  std::vector<short> xcoef;    // 2 coefficients per dst column
  std::vector<int> yofs;       // src row index per dst row
  std::vector<short> ycoef;    // 2 coefficients per dst row
};

inline short sat_short(float v) {
  // cv::saturate_cast<short>(float) = cvRound = round-half-to-EVEN
  long iv = std::lrintf(v);  // FE_TONEAREST (ties to even), like cvRound
  if (iv < -32768) return -32768;
  if (iv > 32767) return 32767;
  return static_cast<short>(iv);
}

void build_axis(int ssize, int dsize, std::vector<int>& ofs,
                std::vector<short>& coef) {
  ofs.resize(dsize);
  coef.resize(2 * dsize);
  const double scale = static_cast<double>(ssize) / dsize;
  for (int d = 0; d < dsize; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    // OpenCV border clamp (resize.cpp): the LAST source column carries
    // full weight, fx forced to 0 (not sx=ssize-2 with fx=1)
    if (s < 0) { s = 0; f = 0.f; }
    if (s >= ssize - 1) { s = ssize - 1; f = 0.f; }
    ofs[d] = s;
    coef[2 * d] = sat_short((1.f - f) * 2048.f);
    coef[2 * d + 1] = sat_short(f * 2048.f);
  }
}

// Interleaved-channel resize (cn = 1 or 3), cv2-INTER_LINEAR bit-exact.
void resize_linear_u8_cn(const uint8_t* src, int sh, int sw, uint8_t* dst,
                         int dh, int dw, int cn) {
  if (cn == 1 && sh == 2 * dh && sw == 2 * dw && dh > 0 && dw > 0) {
    resize_half_u8(src, sw, dst, dh, dw);
    return;
  }
  ResizePlan p;
  build_axis(sw, dw, p.xofs, p.xcoef);
  build_axis(sh, dh, p.yofs, p.ycoef);
  const int rowlen = dw * cn;
  std::vector<int> row0(rowlen), row1(rowlen);
  int cached_sy0 = -1, cached_sy1 = -1;
  for (int dy = 0; dy < dh; ++dy) {
    const int sy = p.yofs[dy];
    const int b0 = p.ycoef[2 * dy], b1 = p.ycoef[2 * dy + 1];
    const int sy1 = (sy + 1 < sh) ? sy + 1 : sh - 1;
    // horizontal pass for the two source rows (reuse across dst rows)
    auto hresize = [&](int srow, std::vector<int>& out) {
      const uint8_t* s = src + static_cast<size_t>(srow) * sw * cn;
      for (int dx = 0; dx < dw; ++dx) {
        const int sx = p.xofs[dx];
        const int sx1 = (sx + 1 < sw) ? sx + 1 : sw - 1;
        const int a0 = p.xcoef[2 * dx], a1 = p.xcoef[2 * dx + 1];
        for (int c = 0; c < cn; ++c)
          out[dx * cn + c] = s[sx * cn + c] * a0 + s[sx1 * cn + c] * a1;
      }
    };
    if (sy == cached_sy1) {
      row0.swap(row1);
      cached_sy0 = sy;
      cached_sy1 = -1;
    }
    if (cached_sy0 != sy) { hresize(sy, row0); cached_sy0 = sy; }
    if (cached_sy1 != sy1) { hresize(sy1, row1); cached_sy1 = sy1; }
    uint8_t* d = dst + static_cast<size_t>(dy) * rowlen;
    for (int j = 0; j < rowlen; ++j) {
      d[j] = static_cast<uint8_t>(
          (((b0 * (row0[j] >> 4)) >> 16) +
           ((b1 * (row1[j] >> 4)) >> 16) + 2) >> 2);
    }
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// uint8 kernels (autovectorized)
// ---------------------------------------------------------------------

// dst = max(dst, src) elementwise.
void metring_u8_max_inplace(uint8_t* dst, const uint8_t* src, size_t n) {
  for (size_t i = 0; i < n; ++i) dst[i] = dst[i] > src[i] ? dst[i] : src[i];
}

// BT.601 BGR -> gray (y = 0.299R + 0.587G + 0.114B), bit-exact with
// OpenCV >= 4.x's "bit-exact" u8 path: 15-bit fixed-point coefficients
// summing to exactly 1<<15 (verified against cv2 5.0 over 6M random
// pixels in tests/test_misc_components.py).
void metring_bgr2gray(const uint8_t* bgr, size_t n_pixels, uint8_t* gray) {
  constexpr uint32_t kB = 3735, kG = 19235, kR = 9798;  // 0.114/0.587/0.299
  constexpr uint32_t kHalf = 1 << 14;
  for (size_t i = 0; i < n_pixels; ++i) {
    const uint8_t* p = bgr + 3 * i;
    gray[i] = static_cast<uint8_t>(
        (kB * p[0] + kG * p[1] + kR * p[2] + kHalf) >> 15);
  }
}

// Resize one u8 gray image src[sh, sw] -> dst[dh, dw], cv2-INTER_LINEAR
// bit-exact.
void metring_resize_linear_u8(const uint8_t* src, int sh, int sw,
                              uint8_t* dst, int dh, int dw) {
  resize_linear_u8_cn(src, sh, sw, dst, dh, dw, 1);
}

// Batched GIL-free block assembly: resize+assemble n gray frames into
// consecutive slots of a [*, dh, dw] u8 block, max-merging every
// exp_frame inputs into one slot. srcs: array of n frame pointers (each
// [sh, sw] u8 contiguous); writes n/exp_frame slots starting at
// dst_block. Called once per decode chunk with the GIL released
// (ctypes), so the Python interpreter never blocks on per-frame work.
void metring_resize_assemble_u8(const uint8_t** srcs, int n, int sh, int sw,
                                uint8_t* dst_block, int dh, int dw,
                                int exp_frame, uint8_t* scratch) {
  const size_t slot = static_cast<size_t>(dh) * dw;
  int out_idx = 0;
  for (int i = 0; i < n; ++i) {
    const int in_group = i % exp_frame;
    uint8_t* target = dst_block + static_cast<size_t>(out_idx) * slot;
    if (in_group == 0) {
      resize_linear_u8_cn(srcs[i], sh, sw, target, dh, dw, 1);
    } else {
      resize_linear_u8_cn(srcs[i], sh, sw, scratch, dh, dw, 1);
      metring_u8_max_inplace(target, scratch, slot);
    }
    if (in_group == exp_frame - 1) ++out_idx;
  }
}

// Color variant: resize interleaved BGR frames, convert to gray (same
// resize-then-gray order as HostPreprocess.into), exposure-max-merge
// into consecutive gray block slots. color_scratch: [dh, dw, 3] u8;
// gray_scratch: [dh, dw] u8 (only used when exp_frame > 1). When the
// source is already runtime-sized (sh == dh && sw == dw), the resize is
// skipped and conversion reads straight from the source frame.
void metring_resize_bgr2gray_assemble_u8(const uint8_t** srcs, int n,
                                         int sh, int sw, uint8_t* dst_block,
                                         int dh, int dw, int exp_frame,
                                         uint8_t* color_scratch,
                                         uint8_t* gray_scratch) {
  const size_t slot = static_cast<size_t>(dh) * dw;
  const bool same_size = (sh == dh && sw == dw);
  int out_idx = 0;
  for (int i = 0; i < n; ++i) {
    const int in_group = i % exp_frame;
    uint8_t* target = dst_block + static_cast<size_t>(out_idx) * slot;
    const uint8_t* color = srcs[i];
    if (!same_size) {
      resize_linear_u8_cn(srcs[i], sh, sw, color_scratch, dh, dw, 3);
      color = color_scratch;
    }
    if (in_group == 0) {
      metring_bgr2gray(color, slot, target);
    } else {
      metring_bgr2gray(color, slot, gray_scratch);
      metring_u8_max_inplace(target, gray_scratch, slot);
    }
    if (in_group == exp_frame - 1) ++out_idx;
  }
}

}  // extern "C"
