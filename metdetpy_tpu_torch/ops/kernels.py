"""The four hand-written CUDA kernels of the M3 path, their wrappers and
their plain PyTorch versions.

Counterpart of ``metdetpy_tpu/ops/pallas_kernels.py``. Each wrapper:

- takes the plain version for CPU tensors, and only for them;
- launches its CUDA kernel for CUDA tensors, or raises (there is no
  fallback from the card to the plain version);
- checks device, dtype, shape and contiguity of what it is given;
- adds one to ``LAUNCHES[name]`` where it launches its kernel.

The kernels (``csrc/*.cu``) are compiled for ``sm_90a`` at first use, one
``nvcc`` process per source, all started together, into shared libraries
with a plain C interface under ``csrc/build/`` (keyed by a hash of the
source and flags) and bound with ``ctypes``. Each C entry point launches
on the caller's stream and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from . import filters, windows
from .f32 import fma_f32, trig_tables

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# kernel name -> (source file, C entry point, argtypes)
SOURCES = {
    "window_diff": ("window_diff.cu", "mdt_window_diff",
                    [_P, _P, _P, _P, _L, _I, _I, _I, _P]),
    "median_binarize_close": ("median_binarize_close.cu",
                              "mdt_median_binarize_close",
                              [_P, _P, _P, _I, _I, _I, _P]),
    "hough_vote": ("hough_vote.cu", "mdt_hough_vote",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "walk_pick": ("walk_pick.cu", "mdt_walk_pick",
                  [_P, _P, _P, _P, _I, _I, _I, _P]),
}

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {name: 0 for name in SOURCES}

_LIBS: dict = {}
_BUILD_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for path in cand:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(src: str) -> str:
    with open(os.path.join(_CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_kernels() -> dict:
    """Compile every kernel source not yet built (in parallel) and bind
    them. Returns {name: ctypes function}. Raises with nvcc's output if a
    build fails. The ``-Xptxas -v`` report of each build (registers,
    shared memory, spills) is kept beside its library as ``.log``."""
    with _BUILD_LOCK:
        if len(_LIBS) == len(SOURCES):
            return _LIBS
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, (src, _, _) in SOURCES.items():
            out = _lib_path(src)
            if os.path.isfile(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(os.path.splitext(out)[0] + ".log", "w")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)],
                stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
        failed = []
        for name, (proc, tmp, out, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    failed.append(f"{name} (rc={rc}):\n{f.read()}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for name, (src, sym, argtypes) in SOURCES.items():
            fn = getattr(ctypes.CDLL(_lib_path(src)), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = fn
        return _LIBS


def _launch(name: str, ref: torch.Tensor, *args) -> None:
    fn = build_kernels()[name]
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    with torch.cuda.device(ref.device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, device,
           shape=None) -> None:
    if x.device != device:
        raise ValueError(f"{name}: tensor on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


# -- 1. window diff -----------------------------------------------------------
#
# Replaces metdetpy_tpu/ops/pallas_kernels.py::_wd_pallas (:281, kernel
# _wd_kernel_stream :234). Bound by bytes: each of the n-1+T input frames is
# read once and the T diff and n-1 history frames written once. One thread
# per pixel streams over time with the running sum in a register and the
# last n values in a shared-memory ring, so each input byte is read from
# device memory exactly once; the window max rescans the ring (n shared
# loads per output).


def window_diff_plain(history: torch.Tensor, frames: torch.Tensor, n: int,
                      timer0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Spec: ``windows.window_stats(...).diff`` and the new history."""
    stats, new_hist = windows.window_stats(history, frames, n, timer0)
    return stats.diff, new_hist


def window_diff(history: torch.Tensor, frames: torch.Tensor, n: int,
                timer0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Trailing-window (max - integer mean) over a [T, H, W] u8 block with
    an [n-1, H, W] u8 history carried in. Returns (diff [T, H, W] u8,
    new_history [n-1, H, W] u8)."""
    if not _on_card(frames, "window_diff"):
        return window_diff_plain(history, frames, n, timer0)
    t_block, h, w = frames.shape
    dev = frames.device
    _check("window_diff", frames, torch.uint8, dev)
    _check("window_diff", history, torch.uint8, dev, (n - 1, h, w))
    if n < 1 or n > 1536:
        raise ValueError(f"window_diff: window n={n} outside [1, 1536]")
    diff = torch.empty_like(frames)
    new_hist = torch.empty_like(history)
    _launch("window_diff", frames, history.data_ptr(), frames.data_ptr(),
            diff.data_ptr(), new_hist.data_ptr(), h * w, n, t_block,
            int(timer0))
    return diff, new_hist


# -- 2. median -> binarize -> close -------------------------------------------
#
# Replaces metdetpy_tpu/ops/pallas_kernels.py::_fused_pallas (:126, kernel
# _kernel :71). Bound by bytes (one u8 frame read, one written). One block
# per 64x16 tile of one frame: the tile and a 3-pixel halo (replicated at
# the frame edge) go to shared memory once, and the median, threshold,
# dilate (out-of-frame reads 0) and erode (out-of-frame reads 255) stages
# each keep their intermediate tile in shared memory.


def median_binarize_close_plain(diff: torch.Tensor,
                                thr: torch.Tensor) -> torch.Tensor:
    """Spec: the ``filters`` chain median3x3 -> > thr[t] -> close3x3."""
    binary = filters.binary_threshold(filters.median3x3(diff),
                                      thr[:, None, None])
    return filters.close3x3(binary)


def median_binarize_close(diff: torch.Tensor,
                          thr: torch.Tensor) -> torch.Tensor:
    """median3x3 -> (x > thr[t]) * 255 -> close3x3 over a [T, H, W] u8
    block with a [T] u8 threshold."""
    if not _on_card(diff, "median_binarize_close"):
        return median_binarize_close_plain(diff, thr)
    t_block, h, w = diff.shape
    _check("median_binarize_close", diff, torch.uint8, diff.device)
    _check("median_binarize_close", thr, torch.uint8, diff.device,
           (t_block,))
    out = torch.empty_like(diff)
    _launch("median_binarize_close", diff, diff.data_ptr(), thr.data_ptr(),
            out.data_ptr(), t_block, h, w)
    return out


# -- 3. Hough vote ------------------------------------------------------------
#
# Replaces metdetpy_tpu/ops/pallas_kernels.py::hough_vote_pallas (:505,
# kernel _vote_kernel :465). Bound by bytes: the [T, 180, n_rho] i32 vote
# array it writes dwarfs the point list it reads. One block per (frame,
# 4-theta chunk) counts into a shared-memory histogram with integer
# atomicAdd (order-independent, so exact) and stores it coalesced; the
# point list is re-read from L2 by each theta chunk. rho is
# __fadd_rn(__fmaf_rn(c, x, __fmul_rn(s, y)), off), the contraction XLA's
# CPU backend applies to cos*x + sin*y + off, then rintf and a clip.


# 4 theta histograms of n_rho int32 in the 227 KB of shared memory a block
# may use (csrc/hough_vote.cu THETAS)
MAX_VOTE_RHO = 232448 // (4 * 4)


def hough_vote_plain(xs: torch.Tensor, ys: torch.Tensor, valid: torch.Tensor,
                     n_rho: int, rho_offset: int) -> torch.Tensor:
    """Spec: ``metdetpy_tpu/ops/hough.py::_vote`` as a scatter-add."""
    t, n = xs.shape
    cos_t, sin_t = trig_tables(xs.device)
    rho = fma_f32(cos_t[None, :, None], xs[:, None, :],
                  sin_t[None, :, None] * ys[:, None, :]) + float(rho_offset)
    q = torch.clamp(torch.round(rho).to(torch.int64), 0, n_rho - 1)
    base = (torch.arange(t * 180, device=xs.device) * n_rho).view(t, 180, 1)
    votes = torch.zeros(t * 180 * n_rho, dtype=torch.int32, device=xs.device)
    weight = valid[:, None, :].expand(t, 180, n).to(torch.int32)
    votes.scatter_add_(0, (base + q).reshape(-1), weight.reshape(-1))
    return votes.view(t, 180, n_rho)


def hough_vote(xs: torch.Tensor, ys: torch.Tensor, valid: torch.Tensor,
               n_rho: int, rho_offset: int) -> torch.Tensor:
    """Hough votes from compacted points: [T, N] f32 xs, ys and bool valid
    -> [T, 180, n_rho] i32 counts."""
    if not _on_card(xs, "hough_vote"):
        return hough_vote_plain(xs, ys, valid, n_rho, rho_offset)
    t, n = xs.shape
    dev = xs.device
    _check("hough_vote", xs, torch.float32, dev)
    _check("hough_vote", ys, torch.float32, dev, (t, n))
    _check("hough_vote", valid, torch.bool, dev, (t, n))
    if n_rho > MAX_VOTE_RHO:
        raise ValueError(f"hough_vote: n_rho={n_rho} needs more shared "
                         f"memory than a block has (max {MAX_VOTE_RHO})")
    cos_t, sin_t = trig_tables(dev)
    votes = torch.empty((t, 180, n_rho), dtype=torch.int32, device=dev)
    _launch("hough_vote", xs, xs.data_ptr(), ys.data_ptr(), valid.data_ptr(),
            cos_t.data_ptr(), sin_t.data_ptr(), votes.data_ptr(), t, n,
            n_rho, rho_offset)
    return votes


# -- 4. segment-walk pick -----------------------------------------------------
#
# Replaces metdetpy_tpu/ops/pallas_kernels.py::walk_pick_pallas (:402,
# kernel _walk_pick_kernel :357 with _pick_row_bands :331). Bound by bytes:
# the [T, K, S] i32 output plus the plane rows the walks touch. One thread
# per (frame, peak, column) does one direct indexed u8 load; a row outside
# [0, S) gives 0, so the kernel equals the one-hot form on every column.
# The one-hot reduction and the row bands existed only for the TPU.


def walk_pick_plain(planes: torch.Tensor, r: torch.Tensor,
                    xmaj: torch.Tensor) -> torch.Tensor:
    """Spec: ``metdetpy_tpu/ops/hough.py::_picks_onehot`` (batched):
    v[b, k, c] = planes[b, 0 if xmaj[b, k] else 1, r[b, k, c], c], and 0
    where r[b, k, c] is outside [0, S)."""
    b, k, s = r.shape
    plane = torch.where(xmaj, 0, 1).to(torch.int64)
    row = r.to(torch.int64)
    inside = (row >= 0) & (row < s)
    col = torch.arange(s, device=r.device)
    lin = (((torch.arange(b, device=r.device)[:, None] * 2 + plane)[..., None]
            * s + row.clamp(0, s - 1)) * s + col)
    v = planes.reshape(-1)[lin].to(torch.int32)
    return torch.where(inside, v, 0)


def walk_pick(planes: torch.Tensor, r: torch.Tensor,
              xmaj: torch.Tensor) -> torch.Tensor:
    """Batched per-column row pick from the packed corner planes:
    planes [T, 2, S, S] u8, r [T, K, S] i32, xmaj [T, K] bool ->
    [T, K, S] i32."""
    if not _on_card(planes, "walk_pick"):
        return walk_pick_plain(planes, r, xmaj)
    t, k, s = r.shape
    dev = planes.device
    _check("walk_pick", planes, torch.uint8, dev, (t, 2, s, s))
    _check("walk_pick", r, torch.int32, dev)
    _check("walk_pick", xmaj, torch.bool, dev, (t, k))
    out = torch.empty((t, k, s), dtype=torch.int32, device=dev)
    _launch("walk_pick", planes, planes.data_ptr(), r.data_ptr(),
            xmaj.data_ptr(), out.data_ptr(), t, k, s)
    return out
