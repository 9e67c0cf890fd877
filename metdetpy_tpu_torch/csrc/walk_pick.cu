// Segment-walk row pick: v[t, k, c] = planes[t, xmaj[t, k] ? 0 : 1,
// r[t, k, c], c], and 0 where r is outside [0, S).
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::walk_pick_pallas (:402,
// kernel _walk_pick_kernel :357 with _pick_row_bands :331). Spec:
// metdetpy_tpu/ops/hough.py::_picks_onehot, which this equals on every
// column (the Pallas kernel only on the columns the walk keeps).
//
// Bound by bytes: the [T, K, S] int32 output and the r indices, plus the
// plane rows the walks touch. One thread per (frame, peak, column) does one
// direct indexed u8 load: the one-hot row reduction and the row bands of the
// TPU kernel have no purpose on this card. Neighbouring threads take
// neighbouring columns, so r loads and output stores are coalesced, and the
// plane loads of a warp fall in at most a few rows (a walk's row moves by at
// most one per column).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__global__ void walk_pick_kernel(const uint8_t* __restrict__ planes,
                                 const int* __restrict__ r,
                                 const uint8_t* __restrict__ xmaj,
                                 int* __restrict__ out, long long total,
                                 int k, int s) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % s);
  const long long tk = i / s;  // frame * k + peak
  const long long t = tk / k;
  const int row = r[i];
  const int plane = xmaj[tk] ? 0 : 1;
  int v = 0;
  if (row >= 0 && row < s) v = planes[((t * 2 + plane) * s + row) * s + c];
  out[i] = v;
}

extern "C" int mdt_walk_pick(const void* planes, const void* r,
                             const void* xmaj, void* out, int t_block, int k,
                             int s, void* stream) {
  const long long total = (long long)t_block * k * s;
  if (total <= 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  walk_pick_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)r, (const uint8_t*)xmaj,
      (int*)out, total, k, s);
  return (int)cudaGetLastError();
}
