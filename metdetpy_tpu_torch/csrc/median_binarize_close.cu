// 3x3 median -> (> thr[t]) ? 255 : 0 -> 3x3 dilate -> 3x3 erode over a
// [T, H, W] uint8 block.
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::_fused_pallas (:126, kernel
// _kernel :71). Spec: filters.median3x3 -> binary_threshold -> close3x3,
// which equals cv2 (medianBlur with replicated borders; dilate reading 0 and
// erode reading 255 outside the frame).
//
// Bound by bytes: one u8 frame read and one written. One block per TW x TH
// tile of one frame. The tile plus a 3-pixel halo is read once into shared
// memory with frame-edge clamping (the median's replicate border); each
// later stage keeps its intermediate tile in shared memory and shrinks the
// halo by one pixel: binary on TH+4 x TW+4 (0 outside the frame), dilate on
// TH+2 x TW+2 (255 outside the frame), erode on the TH x TW output.

#include <cuda_runtime.h>
#include <stdint.h>

#define TW 64
#define TH 16
#define THREADS 256

__device__ __forceinline__ void sort2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

__global__ void median_binarize_close_kernel(const uint8_t* __restrict__ in,
                                             const uint8_t* __restrict__ thr,
                                             uint8_t* __restrict__ out,
                                             int h, int w) {
  __shared__ uint8_t s_in[TH + 6][TW + 6];
  __shared__ uint8_t s_bin[TH + 4][TW + 4];
  __shared__ uint8_t s_dil[TH + 2][TW + 2];
  const int t = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const uint8_t* src = in + (long long)t * h * w;
  uint8_t* dst = out + (long long)t * h * w;

  for (int i = threadIdx.x; i < (TH + 6) * (TW + 6); i += THREADS) {
    const int ly = i / (TW + 6), lx = i % (TW + 6);
    const int gy = min(max(y0 - 3 + ly, 0), h - 1);
    const int gx = min(max(x0 - 3 + lx, 0), w - 1);
    s_in[ly][lx] = src[(long long)gy * w + gx];
  }
  __syncthreads();

  const int th = thr[t];
  for (int i = threadIdx.x; i < (TH + 4) * (TW + 4); i += THREADS) {
    const int ly = i / (TW + 4), lx = i % (TW + 4);
    const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
    uint8_t b = 0;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      int v[9];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[dy * 3 + dx] = s_in[ly + dy][lx + dx];
      // Paeth's 19-exchange median-of-9 network (as filters.median3x3)
      sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
      sort2(v[0], v[1]); sort2(v[3], v[4]); sort2(v[6], v[7]);
      sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
      sort2(v[0], v[3]); sort2(v[5], v[8]); sort2(v[4], v[7]);
      sort2(v[3], v[6]); sort2(v[1], v[4]); sort2(v[2], v[5]);
      sort2(v[4], v[7]); sort2(v[4], v[2]); sort2(v[6], v[4]);
      sort2(v[4], v[2]);
      b = v[4] > th ? 255 : 0;
    }
    s_bin[ly][lx] = b;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (TH + 2) * (TW + 2); i += THREADS) {
    const int ly = i / (TW + 2), lx = i % (TW + 2);
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    int d = 255;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      d = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          d = max(d, (int)s_bin[ly + dy][lx + dx]);
    }
    s_dil[ly][lx] = (uint8_t)d;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    const int ly = i / TW, lx = i % TW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= h || gx >= w) continue;
    int e = 255;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) e = min(e, (int)s_dil[ly + dy][lx + dx]);
    dst[(long long)gy * w + gx] = (uint8_t)e;
  }
}

extern "C" int mdt_median_binarize_close(const void* in, const void* thr,
                                         void* out, int t_block, int h,
                                         int w, void* stream) {
  if (t_block <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, t_block);
  median_binarize_close_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const uint8_t*)thr, (uint8_t*)out, h, w);
  return (int)cudaGetLastError();
}
