// Trailing-window (max - integer mean) over a frame block, carrying history.
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::_wd_pallas (:281, kernel
// _wd_kernel_stream :234). Spec: windows.window_stats(...).diff.
//
// Bound by bytes: each of the n-1+T input frames is read once and the T diff
// frames and n-1 new-history frames written once. One thread per pixel
// streams over time: the running window sum stays in a register, the last n
// values in a per-thread column of a shared-memory ring, so every input byte
// leaves device memory exactly once. The window max rescans the ring (n
// shared loads per output). Neighbouring threads own neighbouring pixels, so
// every global load and store of a warp is one contiguous 32-byte run.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void window_diff_kernel(const uint8_t* __restrict__ hist,
                                   const uint8_t* __restrict__ frames,
                                   uint8_t* __restrict__ diff,
                                   uint8_t* __restrict__ new_hist,
                                   long long hw, int n, int t_block,
                                   int timer0) {
  extern __shared__ uint8_t ring[];  // [n][blockDim.x]
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;  // no block-wide barrier below
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int n_total = n - 1 + t_block;
  int sum = 0;
  int slot = 0;
  for (int i = 0; i < n_total; ++i) {
    const uint8_t v = i < n - 1 ? hist[(long long)i * hw + p]
                                : frames[(long long)(i - (n - 1)) * hw + p];
    uint8_t* cell = ring + slot * bd + tid;
    if (i >= n) sum -= *cell;  // the value leaving the window
    *cell = v;
    sum += v;
    if (++slot == n) slot = 0;
    if (i >= t_block) new_hist[(long long)(i - t_block) * hw + p] = v;
    if (i >= n - 1) {
      const int t = i - (n - 1);
      int mx = 0;
      for (int j = 0; j < n; ++j) mx = max(mx, (int)ring[j * bd + tid]);
      const int len = min(timer0 + 1 + t, n);
      diff[(long long)t * hw + p] = (uint8_t)(mx - sum / len);
    }
  }
}

extern "C" int mdt_window_diff(const void* hist, const void* frames,
                               void* diff, void* new_hist, long long hw,
                               int n, int t_block, int timer0,
                               void* stream) {
  if (hw <= 0 || t_block <= 0) return 0;
  // ring of n bytes per thread within the default 48 KB of shared memory
  int threads = 256;
  while (threads > 32 && (long long)threads * n > 48 * 1024) threads /= 2;
  const unsigned blocks = (unsigned)((hw + threads - 1) / threads);
  window_diff_kernel<<<blocks, threads, (size_t)threads * n,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)hist, (const uint8_t*)frames, (uint8_t*)diff,
      (uint8_t*)new_hist, hw, n, t_block, timer0);
  return (int)cudaGetLastError();
}
