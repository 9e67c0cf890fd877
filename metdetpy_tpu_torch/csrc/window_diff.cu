// Trailing-window (max - integer mean) over a frame block, carrying history.
//
// Replaces metdetpy_tpu/ops/pallas_kernels.py::_wd_pallas (:281, kernel
// _wd_kernel_stream :234). Spec: windows.window_stats(...).diff.
//
// Bound by bytes: each of the n-1+T input frames is read once and the T diff
// frames written once (78.8 MB at 960x540, T=64, n=25: 0.0235 ms at
// 3.35 TB/s); its 7 operations per output pixel (van Herk max 3, running
// sum 2, floor mean 1, subtract 1) take 0.0035 ms at 67 T operations/s.
// The new history is the window's last n-1 frames. Where n-1 <= T they lie
// in `frames` and the wrapper returns them as a view, so the kernel writes
// the history (new_hist != nullptr) only when it is longer than the block;
// that write is n-1 more frames, beyond the bound above.
//
// Design. Each thread owns 16 adjacent pixels of the flattened H*W axis (one
// 16-byte word per frame) and walks over the n-1+T frames; a block owns
// blockDim.x such words. Nothing is shared between threads, so there is no
// block barrier anywhere:
// - Streaming: each thread fills its own column of a shared-memory ring of
//   frames with 16-byte cp.async copies, kStages frames ahead of the one it
//   works on (about 20 KB in flight per SM at n=25). A ring of n+kStages+1
//   frames keeps the current window, the frame leaving it and those in
//   flight.
// - Max: van Herk/Gil-Werman over segments of n outputs, as the TPU kernel.
//   At a segment's first output the window is exactly one segment of frames:
//   its suffix maxima go to a second shared array (n words per thread); each
//   later output of the segment is max(suffix[j], running prefix max of the
//   frames that entered since). About 3 max operations per output, whatever
//   n is. Maxima are taken on byte pairs held in 16-bit lanes (max.u16x2).
// - Mean: the 16 window sums stay in registers (+ entering - leaving byte);
//   floor(sum / len) is the high word of sum * ceil(2^32 / len) (one
//   multiply), exact for every sum <= 1536 * 255 and 2 <= len <= 1536
//   (tests/test_torch_port_kernel_algebra.py); len == 1 takes the sum.
// - Edges: where hw % 16 != 0 or a pointer is not 16-byte aligned (and for
//   the last, partial word) a thread loads and stores its bytes one by one.
// - Streams: one launch takes S independent blocks (S camera feeds, or S
//   consecutive time shards), frames [S, T, H, W] with history
//   [S, n-1, H, W]; blockIdx.y is the stream. Each stream's history is
//   contiguous, the streams hist_ss bytes apart: where the caller passes
//   the previous block's last n-1 frames as a view, that is T*H*W, not
//   (n-1)*H*W. Stream s starts at frame timer0 + s * timer_step. The stream
//   offsets are a template flag: a launch of one stream compiles to the
//   single-stream kernel (its pointers stay kernel parameters; with the
//   offsets the kernel holds them in registers: 117 against 80).
// - Timer: the frame timer is the block step's device carry (a 0-dim int32
//   the step advances on the card), so the kernel reads timer0 through a
//   pointer and clamps it to n itself: no host value of it is needed to
//   launch, and one launch (or a captured graph of it) serves every block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "cp_async.cuh"

namespace {

constexpr int kStages = 5;          // frames in flight per thread
constexpr int kMaxThreads = 128;
constexpr int kMaxSmem = 232448;    // shared memory one block may use
constexpr int kMaxDevices = 64;

// devices whose kernels' attributes are set (at the first launch on each)
std::atomic<bool> g_attrs_set[kMaxDevices] = {};

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// bytes 0 and 2 (even) or 1 and 3 (odd) of x in the two 16-bit lanes
__device__ __forceinline__ uint32_t even_bytes(uint32_t x) {
  return __byte_perm(x, 0, 0x4240);
}
__device__ __forceinline__ uint32_t odd_bytes(uint32_t x) {
  return __byte_perm(x, 0, 0x4341);
}
__device__ __forceinline__ uint32_t join_bytes(uint32_t e, uint32_t o) {
  return __byte_perm(e, o, 0x6240);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t x, int b) {
  return __byte_perm(x, 0, 0x4440 + b);
}

// per-byte (a - b) mod 256
__device__ __forceinline__ uint32_t sub_bytes(uint32_t a, uint32_t b) {
  return ((a | 0x80808080u) - (b & 0x7F7F7F7Fu)) ^
         ((a ^ ~b) & 0x80808080u);
}

}  // namespace

template <bool kStreams>
__global__ void __launch_bounds__(kMaxThreads)
    window_diff_kernel(const uint8_t* __restrict__ hist,
                       const uint8_t* __restrict__ frames,
                       uint8_t* __restrict__ diff,
                       uint8_t* __restrict__ new_hist, long long hw, int n,
                       int t_block, const int* __restrict__ timer0_ptr,
                       int timer_step, long long hist_ss, bool vec) {
  extern __shared__ uint4 smem[];
  // the window length only needs min(timer, n)
  long long timer0 = min((long long)__ldg(timer0_ptr), (long long)n);
  if (kStreams) {
    const long long stream = blockIdx.y;
    hist += stream * hist_ss;
    frames += stream * t_block * hw;
    diff += stream * t_block * hw;
    if (new_hist != nullptr) new_hist += stream * (n - 1) * hw;
    timer0 = min(timer0 + stream * timer_step, (long long)n);
  }
  const int bd = blockDim.x;
  const int ring = n + kStages + 1;
  uint4* raw = smem + threadIdx.x;               // frame slot s: raw[s * bd]
  uint4* sfx = smem + ring * bd + threadIdx.x;   // suffix max j: sfx[j * bd]
  const long long p0 = ((long long)blockIdx.x * bd + threadIdx.x) * 16;
  if (p0 >= hw) return;
  const bool wide = vec && p0 + 16 <= hw;
  const int n_total = n - 1 + t_block;
  const bool write_hist = new_hist != nullptr;

  auto src = [&](int i) -> const uint8_t* {
    return i < n - 1 ? hist + (long long)i * hw + p0
                     : frames + (long long)(i - (n - 1)) * hw + p0;
  };
  auto fetch = [&](int i, int slot) {
    if (i < n_total) {
      uint4* dst = raw + slot * bd;
      const uint8_t* s = src(i);
      if (wide) {
        cp_async16(dst, s);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (p0 + b < hw) w[b >> 2] |= (uint32_t)s[b] << (8 * (b & 3));
        *dst = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_commit();  // one group per frame, empty past the end
  };
  auto store = [&](uint8_t* dst, const uint4& v) {
    if (wide) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (p0 + b < hw) dst[b] = (uint8_t)(word(v, b >> 2) >> (8 * (b & 3)));
    }
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) fetch(i, i);

  uint32_t sum[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) sum[b] = 0;
  uint32_t pe[4] = {0, 0, 0, 0}, po[4] = {0, 0, 0, 0};  // prefix maxima
  int slot_x = 0;                      // slot of frame e
  int slot_l = ring - n;               // slot of frame e - n
  int slot_f = kStages;                // slot of frame e + kStages
  int j = 0;                           // output's place in its segment
  uint32_t cur_len = 0, mul = 0;

  for (int e = 0; e < n_total; ++e) {
    cp_async_wait<kStages - 1>();  // frame e has landed
    const uint4 xv = raw[slot_x * bd];
    const uint4 lv = e >= n ? raw[slot_l * bd] : make_uint4(0, 0, 0, 0);
    fetch(e + kStages, slot_f);
    if (write_hist && e >= t_block)
      store(new_hist + (long long)(e - t_block) * hw + p0, xv);
#pragma unroll
    for (int b = 0; b < 16; ++b)
      sum[b] += byte_of(word(xv, b >> 2), b & 3) -
                byte_of(word(lv, b >> 2), b & 3);

    if (e >= n - 1) {
      const int t = e - (n - 1);
      uint32_t me[4], mo[4];
      if (j == 0) {
        // the window is one segment: its suffix maxima, newest frame first
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          me[k] = even_bytes(word(xv, k));
          mo[k] = odd_bytes(word(xv, k));
          pe[k] = po[k] = 0;
        }
        sfx[(n - 1) * bd] = xv;
        int s = slot_x;
        for (int q = n - 2; q >= 0; --q) {
          s = s == 0 ? ring - 1 : s - 1;
          const uint4 r = raw[s * bd];
          uint32_t m[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            me[k] = max_u16x2(me[k], even_bytes(word(r, k)));
            mo[k] = max_u16x2(mo[k], odd_bytes(word(r, k)));
            m[k] = join_bytes(me[k], mo[k]);
          }
          sfx[q * bd] = make_uint4(m[0], m[1], m[2], m[3]);
        }
      } else {
        const uint4 sv = sfx[j * bd];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pe[k] = max_u16x2(pe[k], even_bytes(word(xv, k)));
          po[k] = max_u16x2(po[k], odd_bytes(word(xv, k)));
          me[k] = max_u16x2(even_bytes(word(sv, k)), pe[k]);
          mo[k] = max_u16x2(odd_bytes(word(sv, k)), po[k]);
        }
      }
      if (++j == n) j = 0;

      const uint32_t len =
          (uint32_t)min(timer0 + 1 + t, (long long)n);
      if (len != cur_len) {
        cur_len = len;
        // ceil(2^32 / len); len == 1 takes the sum itself
        mul = len > 1 ? (uint32_t)((0x100000000ULL + len - 1) / len) : 0u;
      }
      uint32_t q[16];
#pragma unroll
      for (int b = 0; b < 16; ++b)
        q[b] = len > 1 ? __umulhi(sum[b], mul) : sum[b];
      uint32_t d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t qw =
            __byte_perm(__byte_perm(q[4 * k], q[4 * k + 1], 0x0040),
                        __byte_perm(q[4 * k + 2], q[4 * k + 3], 0x0040),
                        0x5410);
        d[k] = sub_bytes(join_bytes(me[k], mo[k]), qw);
      }
      store(diff + (long long)t * hw + p0, make_uint4(d[0], d[1], d[2], d[3]));
    }
    if (++slot_x == ring) slot_x = 0;
    if (++slot_l == ring) slot_l = 0;
    if (++slot_f == ring) slot_f = 0;
  }
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, uint8_t*, uint8_t*,
                       long long, int, int, const int*, int, long long,
                       bool);
// the single-stream kernel and the one with stream offsets
const Kernel kKernels[2] = {window_diff_kernel<false>,
                            window_diff_kernel<true>};

// new_hist: nullptr where the caller takes the new history as a view of
// frames (n - 1 <= t_block). frames, diff and new_hist are contiguous
// [n_streams, ...]; hist_ss is the distance in bytes between two streams'
// histories. timer0 points to the frame timer of stream 0, a non-negative
// int32 on the device; timer_step is at most n (the window length only
// needs min(timer, n)).
extern "C" int mdt_window_diff(const void* hist, const void* frames,
                               void* diff, void* new_hist, long long hw,
                               int n, int t_block, const void* timer0,
                               int n_streams, long long hist_ss,
                               int timer_step, void* stream) {
  if (hw <= 0 || t_block <= 0 || n_streams <= 0) return 0;
  if (n_streams > 65535) return (int)cudaErrorInvalidValue;
  // per thread: a ring of n + kStages + 1 frames and n suffix maxima
  const long long per_thread = (2LL * n + kStages + 1) * 16;
  long long threads = kMaxSmem / per_thread;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads >= 32) threads -= threads % 32;
  if (threads < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool cached = dev < kMaxDevices && g_attrs_set[dev].load();
  if (!cached) {
    for (Kernel kernel : kKernels) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
      if (err != cudaSuccess) return (int)err;
    }
    if (dev < kMaxDevices) g_attrs_set[dev].store(true);
  }
  const auto aligned = [](const void* p) {
    return ((uintptr_t)p & 15) == 0;
  };
  const bool vec = hw % 16 == 0 && aligned(frames) && aligned(diff) &&
                   (n == 1 || (aligned(hist) && aligned(new_hist) &&
                               hist_ss % 16 == 0));
  const long long words = (hw + 15) / 16;
  const unsigned blocks = (unsigned)((words + threads - 1) / threads);
  const dim3 grid(blocks, (unsigned)n_streams);
  const Kernel kernel = kKernels[n_streams > 1];
  kernel<<<grid, (unsigned)threads, (size_t)(threads * per_thread),
           (cudaStream_t)stream>>>(
      (const uint8_t*)hist, (const uint8_t*)frames, (uint8_t*)diff,
      (uint8_t*)new_hist, hw, n, t_block, (const int*)timer0, timer_step,
      hist_ss, vec);
  return (int)cudaGetLastError();
}
