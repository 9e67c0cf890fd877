"""The five hand-written CUDA kernels of the M3 path, their wrappers and
their plain PyTorch versions.

Counterpart of ``metdetpy_tpu/ops/pallas_kernels.py``, and of the plain
peak find of ``metdetpy_tpu/ops/hough.py`` (``peak_ladder``). Each wrapper:

- takes the plain version for CPU tensors, and only for them;
- launches its CUDA kernel for CUDA tensors, or raises (there is no
  fallback from the card to the plain version);
- checks device, dtype, shape and contiguity of what it is given;
- adds one to ``LAUNCHES[name]`` where it launches its kernel.

The kernels (``csrc/*.cu``) are compiled for ``sm_90a`` at first use, one
``nvcc`` process per source, all started together, into shared libraries
with a plain C interface under ``csrc/build/`` (keyed by a hash of the
source and flags; ``~/.cache/metdetpy_tpu_torch/csrc/build/`` where the
package is read-only) and bound with ``ctypes``. Each C entry point launches
on the caller's stream and returns ``cudaGetLastError()``. ``variant``
swaps in a build of one source with extra ``-D`` flags, for timing a
kernel at other sizes than the package builds it with.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..utils import build_root
from . import filters, windows
from .f32 import fma_f32, trig_tables

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(build_root(_CSRC), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# kernel name -> (source file, C entry point, argtypes)
SOURCES = {
    "window_diff": ("window_diff.cu", "mdt_window_diff",
                    [_P, _P, _P, _P, _L, _I, _I, _P, _I, _L, _I, _P]),
    "median_binarize_close": ("median_binarize_close.cu",
                              "mdt_median_binarize_close",
                              [_P, _P, _P, _I, _I, _I, _P]),
    "hough_vote": ("hough_vote.cu", "mdt_hough_vote",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "walk_pick": ("walk_pick.cu", "mdt_walk_pick",
                  [_P, _P, _P, _P, _I, _I, _I, _P]),
    "peak_ladder": ("peak_ladder.cu", "mdt_peak_ladder",
                    [_P, _P, _I, _I, _P, _P, _I, _I, _I, _P]),
}
# every C entry point bound: the kernels, and the empty kernel on
# walk_pick's grid that walk_pick_floor launches
ENTRIES = {**SOURCES,
           "walk_pick_floor": ("walk_pick.cu", "mdt_walk_pick_floor",
                               SOURCES["walk_pick"][2])}

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


def _lib_path(src: str, defines: tuple = ()) -> str:
    """The library built from ``src`` with the extra flags ``defines``,
    named by a hash of the flags, the source and every header of ``csrc/``
    (so editing either rebuilds)."""
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for name in (src, *headers):
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def _compile(todo) -> None:
    """One nvcc per (source, defines) of ``todo`` whose library is not
    built yet, all started together. Raises with nvcc's output if a build
    fails. The ``-Xptxas -v`` report of each build (registers, shared
    memory, spills) is kept beside its library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src, defines in todo:
        out = _lib_path(src, defines)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(os.path.splitext(out)[0] + ".log", "w")
        procs.append((src, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *defines, "-o", tmp,
             os.path.join(_CSRC, src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log))
    failed = []
    for src, proc, tmp, out, log in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(log.name) as f:
                failed.append(f"{src} (rc={rc}):\n{f.read()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def _bind(name: str, defines: tuple = ()):
    src, sym, argtypes = ENTRIES[name]
    fn = getattr(ctypes.CDLL(_lib_path(src, defines)), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_kernels() -> dict:
    """Compile every kernel source not yet built (in parallel) and bind
    its entry points. Returns {name: ctypes function}."""
    with _BUILD_LOCK:
        if len(_LIBS) < len(ENTRIES):
            _compile({(src, ()) for src, _, _ in ENTRIES.values()})
            for name in ENTRIES:
                _LIBS[name] = _bind(name)
        return _LIBS


@contextlib.contextmanager
def variant(name: str, defines):
    """Within the block, the entry points of kernel ``name``'s source come
    from a build with the extra nvcc flags ``defines`` (such as
    ``["-DHV_THETAS=6"]``): how ``tools/torch_kernel_variants.py`` times a
    kernel at the sizes its source takes as ``-D`` flags."""
    libs = build_kernels()
    src, defines = SOURCES[name][0], tuple(defines)
    with _BUILD_LOCK:
        _compile([(src, defines)])
    kept = dict(libs)
    libs.update({e: _bind(e, defines) for e, (s, _, _) in ENTRIES.items()
                 if s == src})
    try:
        yield
    finally:
        libs.update(kept)


def _launch(name: str, ref: torch.Tensor, *args) -> None:
    fn = build_kernels()[name]
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    with torch.cuda.device(ref.device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    if name in LAUNCHES:
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
# read once and the T diff frames written once (78.8 MB at 960x540, T=64,
# n=25, 0.0235 ms at 3.35 TB/s); its 7 operations per output take
# 0.0035 ms at 67 T/s. Where n-1 <= T the new history is the last n-1
# frames of the block and is returned as a view of them, as the TPU kernel
# returns seq[t_block:]; only a history longer than the block is written by
# the kernel. Each thread owns 16 adjacent pixels and streams over time:
# frames arrive in its own slots of a shared-memory ring by 16-byte
# cp.async copies, kStages frames ahead; the window max is van
# Herk/Gil-Werman (segment suffix maxima in shared memory, a running prefix
# max in registers, ~3 max per output on byte pairs); the 16 window sums
# stay in registers and the floor mean is a reciprocal multiply, exact in
# range. A leading stream axis (S feeds, or S time shards) is the grid's
# second dimension: one launch for all streams, each stream's history read
# at its own offset (a view of the previous block's frames lies T frames
# apart from stream to stream, not n-1), so no history is copied. The
# frame timer is read from the device (a 0-dim int32, the step's carry) and
# clamped to n in the kernel, so the launch holds no host value of it.


def window_diff_plain(history: torch.Tensor, frames: torch.Tensor, n: int,
                      timer0, timer_step: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spec: ``windows.window_stats(...).diff`` and the new history."""
    stats, new_hist = windows.window_stats(history, frames, n, timer0,
                                           timer_step)
    return stats.diff, new_hist


def window_diff(history: torch.Tensor, frames: torch.Tensor, n: int,
                timer0, timer_step: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Trailing-window (max - integer mean) over a [T, H, W] u8 block with
    an [n-1, H, W] u8 history carried in, or over S streams at once:
    frames [S, T, H, W] with history [S, n-1, H, W], stream s starting at
    frame timer0 + s * timer_step. ``timer0`` is a 0-dim int32 tensor on
    the frames' device (the kernel reads it there), or a host int, which
    becomes one. Returns (diff, new_history) of the frames' and the
    history's shapes. ``frames`` is contiguous; each stream's history is
    contiguous, the streams any distance apart.

    On the card, where n-1 <= T, new_history is a view of the last n-1
    frames of each stream of ``frames``: the caller must not write to
    ``frames`` while it holds the history."""
    if not _on_card(frames, "window_diff"):
        return window_diff_plain(history, frames, n, timer0, timer_step)
    streams = frames.dim() == 4
    f4 = frames if streams else frames[None]
    h4 = history if streams else history[None]
    n_streams, t_block, h, w = f4.shape
    dev = frames.device
    _check("window_diff", frames, torch.uint8, dev)
    if history.device != dev or history.dtype != torch.uint8:
        raise TypeError(f"window_diff: history is {history.dtype} on "
                        f"{history.device}, expected torch.uint8 on {dev}")
    if tuple(h4.shape) != (n_streams, n - 1, h, w):
        raise ValueError(f"window_diff: history shape "
                         f"{tuple(history.shape)} does not fit frames "
                         f"{tuple(frames.shape)} and n={n}")
    if n_streams and not h4[0].is_contiguous():
        raise ValueError("window_diff: each stream's history must be "
                         "contiguous")
    if n < 1 or n > 1536:
        raise ValueError(f"window_diff: window n={n} outside [1, 1536]")
    if timer_step < 0 or (not isinstance(timer0, torch.Tensor)
                          and timer0 < 0):
        raise ValueError(f"window_diff: timer0={timer0}, timer_step="
                         f"{timer_step}: negative")
    timer0 = windows.as_timer(timer0, dev)
    diff = torch.empty_like(frames)
    if n - 1 <= t_block:
        new_hist, hist_ptr = frames[..., t_block - (n - 1):, :, :], 0
    else:
        new_hist = torch.empty(tuple(history.shape), dtype=torch.uint8,
                               device=dev)
        hist_ptr = new_hist.data_ptr()
    # len = min(timer + 1 + t, n): timers past n all give n (the kernel
    # clamps timer0 itself)
    _launch("window_diff", frames, h4.data_ptr(), frames.data_ptr(),
            diff.data_ptr(), hist_ptr, h * w, n, t_block,
            timer0.data_ptr(), n_streams, h4.stride(0),
            int(min(timer_step, n)))
    return diff, new_hist


# -- 2. median -> binarize -> close -------------------------------------------
#
# Replaces metdetpy_tpu/ops/pallas_kernels.py::_fused_pallas (:126, kernel
# _kernel :71). Bound by bytes: one u8 frame read and one written (66 MB per
# 64-frame 960x540 block, 0.0198 ms at 3.35 TB/s); its 14 operations per
# pixel (threshold 1, separable 3x3 count 4, count >= 5 1, separable close
# 8) take 0.0069 ms at 67 T/s. The median is never formed: the median of
# nine exceeds thr exactly when five of them do, so each pixel is
# thresholded first and the pixels above thr are counted over the 3x3
# window (replicated border). One warp per 480-column tile of a frame, 16
# columns per lane, four pixels per 32-bit word: rows arrive by 16-byte
# cp.async copies into each lane's shared-memory slots; threshold, count
# and close (OR/AND of shifted words) are packed byte arithmetic. Borders as
# _kernel :99-121: replicated for the median, 0 outside the frame for
# dilate, 255 for erode.


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
# array it writes (17.7 MB for 8 frames at n_rho 3072) dwarfs the point
# list it reads (9 bytes a point, 0.59 MB): 0.0055 ms at 3.35 TB/s; the 3
# float operations per (valid point, theta) take 0.0003 ms at 67 T/s. On
# the card it is held by those stores and by shared memory: a vote is one
# access to a random bank. About one persistent block per SM takes one
# frame and a run of thetas. Its threads hold the frame's points in
# registers (8 each, read once), each pass of up to 4 thetas counts into
# one of two shared histograms with integer atomicAdd (order-independent,
# so exact), and between the votes of the next pass, which go to the other
# histogram, each thread drains its words of the finished one (atomicExch
# reads and zeroes a word in one access) to `votes` with plain coalesced
# stores. rho is __fadd_rn(__fmaf_rn(c, x, __fmul_rn(s, y)), off), the
# contraction XLA's CPU backend applies to cos*x + sin*y + off, then rintf
# and a clip.


# shared memory a block may use, less the kernel's copy of the cos/sin tables
# (1440 bytes, up to the next multiple of 128)
VOTE_SMEM = 232448 - 1536
VOTE_THETAS = 4      # most thetas per pass (csrc/hough_vote.cu HV_THETAS)
VOTE_ROUND = 8192    # points a block holds in registers at a time
# two histograms of one theta at least
MAX_VOTE_RHO = VOTE_SMEM // 8

_SM_COUNT: dict = {}


def vote_plan(t: int, n_rho: int, n_sm: int) -> tuple[int, int]:
    """Launch plan of the vote kernel: (blocks per frame, thetas per pass).

    About one block per SM: each frame's 180 thetas are split into
    ``n_sm // t`` runs (block g takes thetas [g*180//groups,
    (g+1)*180//groups)), and a block works through its run in passes of as
    many thetas, up to VOTE_THETAS, as two histograms of them fit in its
    shared memory."""
    if not 1 <= n_rho <= MAX_VOTE_RHO:
        raise ValueError(f"hough_vote: n_rho={n_rho} needs more shared "
                         f"memory than a block has (max {MAX_VOTE_RHO})")
    groups = max(1, min(180, n_sm // max(t, 1)))
    return groups, min(VOTE_THETAS, VOTE_SMEM // (8 * n_rho))


def hough_vote_plain(xs: torch.Tensor, ys: torch.Tensor, valid: torch.Tensor,
                     n_rho: int, rho_offset: int) -> torch.Tensor:
    """Spec: ``metdetpy_tpu/ops/hough.py::_vote`` as a scatter-add. On
    the CPU the columns that are invalid in every frame are left out
    first: they add nothing, and the main path's compacted lists are
    mostly such columns."""
    if xs.device.type == "cpu":
        keep = valid.any(dim=0)
        if not bool(keep.all()):
            xs, ys, valid = xs[:, keep], ys[:, keep], valid[:, keep]
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
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    plan = vote_plan(t, n_rho, _SM_COUNT[dev])
    cos_t, sin_t = trig_tables(dev)
    votes = torch.empty((t, 180, n_rho), dtype=torch.int32, device=dev)
    _launch("hough_vote", xs, xs.data_ptr(), ys.data_ptr(), valid.data_ptr(),
            cos_t.data_ptr(), sin_t.data_ptr(), votes.data_ptr(), t, n,
            n_rho, rho_offset, *plan)
    return votes


# -- 4. segment-walk pick -----------------------------------------------------
#
# Replaces metdetpy_tpu/ops/pallas_kernels.py::walk_pick_pallas (:402,
# kernel _walk_pick_kernel :357 with _pick_row_bands :331). Bound by bytes:
# r read and the [T, K, S] i32 output written (2.1 MB each at T=8, K=64,
# S=1024), xmaj and one plane byte per in-range column: 0.0013 ms at
# 3.35 TB/s; an empty kernel of the same grid takes longer than that
# (walk_pick_floor), and the kernel is that launch plus two dependent trips
# to memory. One block per (frame, peak) row, so no thread divides and xmaj
# and the plane base are read once per block; a thread takes 4 adjacent
# columns (r in and picks out as 16-byte words, the plane bytes through the
# read-only path), or one column where S % 4 != 0 or a pointer is not
# 16-byte aligned. A row
# outside [0, S) gives 0, so the kernel equals the one-hot form on every
# column. The one-hot reduction and the row bands existed only for the TPU.


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


def walk_pick_floor(planes: torch.Tensor, r: torch.Tensor,
                    xmaj: torch.Tensor) -> None:
    """Launch an empty kernel on the grid ``walk_pick`` takes for these
    card tensors: timed, it is the least any kernel of that grid costs."""
    t, k, s = r.shape
    _launch("walk_pick_floor", planes, planes.data_ptr(), r.data_ptr(),
            xmaj.data_ptr(), 0, t, k, s)


# -- 5. peak ladder -----------------------------------------------------------
#
# The Hough peak find's 3x3 local-maximum test and the crowd guard's counts
# (metdetpy_tpu/ops/hough.py::_find_peaks, plain XLA there: no Pallas
# kernel) in one pass. Bound by bytes: the [T, 180, n_rho] i32 votes read
# once (17.7 MB for 8 frames at n_rho 3072) and the u8 mask written
# (4.4 MB): 0.0066 ms at 3.35 TB/s; the window max's 8 and the test's 2
# operations per bin take 0.0007 ms at 67 T/s (a rung is counted per peak). A thread takes 4 adjacent
# rho columns of a run of theta rows (16-byte loads of the run's rows and
# the two around it; the halo columns from the neighbouring lanes by warp
# shuffles); each peak counts into its rung, the number of cuts <= its vote,
# in a shared-memory histogram, and a block adds its non-zero bins to the
# [T, n_cuts + 1] i32 count with global atomicAdd. The entry point zeroes
# the count with a memset on the launch stream first, so a graph that
# captures the launch zeroes it again on every replay.

MAX_LADDER_CUTS = 32  # csrc/peak_ladder.cu kMaxCuts


def peak_ladder_plain(votes: torch.Tensor, threshold: int,
                      cuts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Spec: ``hough.find_peaks_plain``'s peak test, ``votes >=
    dilate3x3(votes)`` and ``votes > threshold``, as a [T, n_theta * n_rho]
    u8 mask, and each peak counted into its rung, the number of cuts <= its
    vote: a [T, len(cuts) + 1] i32 count."""
    t = votes.shape[0]
    flat = votes.reshape(t, -1)
    is_peak = ((votes >= filters.dilate3x3(votes))
               & (votes > threshold)).reshape(t, -1)
    rung = torch.zeros_like(flat)
    for c in cuts.tolist():
        rung += flat >= c
    count = torch.zeros((t, len(cuts) + 1), dtype=torch.int32,
                        device=votes.device)
    count.scatter_add_(1, rung.to(torch.int64), is_peak.to(torch.int32))
    return is_peak.to(torch.uint8), count


def peak_ladder(votes: torch.Tensor, threshold: int,
                cuts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 local maxima above ``threshold`` of [T, n_theta, n_rho] i32
    votes and their counts by rung of the ladder ``cuts`` (1-D i32, at most
    MAX_LADDER_CUTS) -> (is_peak [T, n_theta * n_rho] u8,
    count [T, len(cuts) + 1] i32)."""
    if not _on_card(votes, "peak_ladder"):
        return peak_ladder_plain(votes, threshold, cuts)
    t, n_theta, n_rho = votes.shape
    dev = votes.device
    _check("peak_ladder", votes, torch.int32, dev)
    _check("peak_ladder", cuts, torch.int32, dev)
    n_cuts = cuts.numel()
    if cuts.dim() != 1 or not 1 <= n_cuts <= MAX_LADDER_CUTS:
        raise ValueError(f"peak_ladder: cuts of shape {tuple(cuts.shape)}, "
                         f"expected 1 to {MAX_LADDER_CUTS} in one dimension")
    if t > 65535:
        raise ValueError(f"peak_ladder: {t} frames, at most 65535")
    is_peak = torch.empty((t, n_theta * n_rho), dtype=torch.uint8,
                          device=dev)
    count = torch.empty((t, n_cuts + 1), dtype=torch.int32, device=dev)
    _launch("peak_ladder", votes, votes.data_ptr(), cuts.data_ptr(), n_cuts,
            int(threshold), is_peak.data_ptr(), count.data_ptr(), t,
            n_theta, n_rho)
    return is_peak, count
