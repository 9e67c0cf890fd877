"""Video loaders: mask loading, resize parsing, preprocess, exposure-time
estimation, and frame/block delivery (host side of the port).

A copy of the JAX package's ``io/videoloader.py`` reduced to the
host-preprocess path: API parity with reference
MetLib/videoloader.py:48-192 (start / pop / reset / stop / release /
summary + exp-time estimation), with two delivery models:

  - ``VanillaVideoLoader``: per-frame ``pop()`` with decode inside it.
  - ``BlockVideoLoader``: the device feed. The decode thread assembles
    preprocessed frames into contiguous uint8 blocks of ``block_frames``
    exposure-merged frames; ``pop_block()`` hands whole ``[T, H, W]``
    arrays to the consumer, which uploads each with one host->device copy.
    When recheck is enabled it also maintains per-chunk color max-stacks so
    the recheck stage needs no second decode pass (the reference re-decodes
    every clip, MetLib/collector.py:789-792).
"""

from __future__ import annotations

import os
import queue
import threading
from abc import ABCMeta, abstractmethod
from math import floor
from typing import Any, Optional, Type, Union

import cv2
import numpy as np

from ..log import get_default_logger
from ..structs import BasicInfo
from ..utils import (frame2time, parse_resize_param, sigma_clip, time2frame,
                     timestr2int)
from ..native import resize_assemble_u8 as _resize_assemble_u8
from ..native import \
    resize_bgr2gray_assemble_u8 as _resize_bgr2gray_assemble_u8
from ..native import u8_max_inplace as _u8_max_inplace
from .fileio import load_mask
from .videowrapper import BaseVideoWrapper

UP_EXPOSURE_BOUND = 0.5
DEFAULT_EXPOSURE_FRAME = 1
SHORT_LENGTH_THRESHOLD = 300
RF_ESTIMATE_LENGTH = 100
SLOW_EXP_TIME = 1 / 4
GET_TIMEOUT = 10
PUT_TIMEOUT = 10
FAILED_FLAG = "failed"
DEFAULT_BLOCK_FRAMES = 64
RECHECK_CHUNK = 16

_ASSEMBLE_PROBE_CACHE: dict = {}


def _native_assemble_wins(src_shape: tuple, dst_hw: tuple) -> bool:
    """Start-time probe: fused-C chunk assembly vs cv2's SIMD per-frame
    kernels (resize [+ gray]) for this (source shape -> block shape).

    cv2's hand-vectorized resize measured 10-14x faster than the scalar
    fixed-point C loop on an uncontended core (2026-08-17, 1080p ->
    960x540), while the C path's one-GIL-release-per-chunk advantage has
    measured wins on this host under heavy allocator/THP contention — so
    measure at loader start instead of hard-coding either. Both paths are
    cv2-bit-exact, so the choice never changes results. Env override:
    METDETPY_TPU_NATIVE_ASSEMBLE=0|1."""
    env = os.environ.get("METDETPY_TPU_NATIVE_ASSEMBLE")
    if env in ("0", "1"):
        return env == "1"
    key = (tuple(src_shape), tuple(dst_hw))
    if key in _ASSEMBLE_PROBE_CACHE:
        return _ASSEMBLE_PROBE_CACHE[key]
    import time as _time
    dh, dw = dst_hw
    color = len(src_shape) == 3
    n = 4
    frames = [np.full(src_shape, 128, np.uint8) for _ in range(n)]
    block = np.zeros((n, dh, dw), np.uint8)
    if color:
        cscratch = np.zeros((dh, dw, 3), np.uint8)

        def native():
            _resize_bgr2gray_assemble_u8(frames, block, 0, 1,
                                         color_scratch=cscratch,
                                         gray_scratch=None)

        def cv2_path():
            for i, f in enumerate(frames):
                cv2.resize(f, (dw, dh), dst=cscratch,
                           interpolation=cv2.INTER_LINEAR)
                cv2.cvtColor(cscratch, cv2.COLOR_BGR2GRAY, dst=block[i])
    else:

        def native():
            _resize_assemble_u8(frames, block, 0, 1, None)

        def cv2_path():
            for i, f in enumerate(frames):
                cv2.resize(f, (dw, dh), dst=block[i],
                           interpolation=cv2.INTER_LINEAR)

    cv2_path()  # touch pages / warm caches for both paths
    native()
    # interleaved min-of-3 per path: this host's CPU stalls come in
    # multi-ms episodes (THP/steal), so alternating samples keeps one
    # episode from poisoning a single path's whole measurement; min takes
    # each path's cleanest sample
    t_native = t_cv2 = float("inf")
    for _ in range(3):
        t0 = _time.perf_counter()
        native()
        t_native = min(t_native, _time.perf_counter() - t0)
        t0 = _time.perf_counter()
        cv2_path()
        t_cv2 = min(t_cv2, _time.perf_counter() - t0)
    win = t_native < t_cv2
    _ASSEMBLE_PROBE_CACHE[key] = win
    return win


class MergeFunction:
    """Frame merge functions (reference MetLib/utils.py:194-222)."""

    @staticmethod
    def not_merge(stack):
        return stack[0]

    @staticmethod
    def max(stack):
        return np.max(stack, axis=0)

    @staticmethod
    def m3func(stack):
        s = np.sort(stack, axis=0)
        return s[-1] - s[len(s) // 2]

    @staticmethod
    def mix_max_median_stacker(stack, threshold: int = 80):
        img_mean = np.mean(stack, axis=0)
        img_max = np.max(stack, axis=0)
        sel = img_max < threshold
        img_max[sel] = img_mean[sel]
        return img_max


class HostPreprocess:
    """Per-frame host preprocess: resize -> (debayer) -> (grayscale) -> mask.

    Mirrors the Transform pipeline built by the reference loader
    (MetLib/videoloader.py:298-308) using cv2 kernels; kept on host so the
    device receives small uint8 frames (runtime-size grayscale), minimizing
    host->HBM transfer.
    """

    def __init__(self, raw_size, runtime_size, grayscale, debayer,
                 debayer_pattern, mask, masked: bool,
                 interpolation=cv2.INTER_LINEAR):
        self.resize = list(raw_size) != list(runtime_size)
        self.dsize = tuple(runtime_size)
        self.grayscale = grayscale
        self.debayer = debayer
        self.pattern = {"BGGR": cv2.COLOR_BAYER_BGGR2BGR,
                        "RGGB": cv2.COLOR_BAYER_RGGB2BGR}.get(debayer_pattern)
        self.mask = mask
        self.masked = masked
        self.interpolation = interpolation

    def __call__(self, frame: np.ndarray, keep_color: bool = False):
        if self.resize:
            frame = cv2.resize(frame, self.dsize,
                               interpolation=self.interpolation)
        if self.debayer:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            frame = cv2.cvtColor(frame, self.pattern, dstCn=3)
        color = frame if keep_color else None
        if self.grayscale and frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if self.masked:
            frame = frame * self.mask
        return (frame, color) if keep_color else frame

    def into(self, frame: np.ndarray, out: np.ndarray,
             scratch: Optional[np.ndarray] = None) -> None:
        """Preprocess ``frame`` directly into the caller's buffer.

        Math-identical to ``__call__`` (same resize-then-gray order) but
        allocation-free: every fresh 0.5MB output allocation measured up
        to seconds of mmap/THP stall while the TPU client streams, so the
        hot block-assembly path writes into pre-faulted pool buffers via
        cv2's dst= argument instead. Debayer falls back to __call__.
        """
        if self.debayer:
            np.copyto(out, self(frame))
            return
        if frame.ndim == 3:
            if self.resize and not self.grayscale and out.ndim == 3:
                # color destination: resize straight into the block slot
                cv2.resize(frame, self.dsize, dst=out,
                           interpolation=self.interpolation)
                if self.masked:
                    np.multiply(out, self.mask, out=out)
                return
            if self.resize:
                if scratch is None:
                    frame = cv2.resize(frame, self.dsize,
                                       interpolation=self.interpolation)
                else:
                    cv2.resize(frame, self.dsize, dst=scratch,
                               interpolation=self.interpolation)
                    frame = scratch
            if self.grayscale:
                cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY, dst=out)
            elif frame is not out:
                np.copyto(out, frame)
        else:
            if self.resize:
                cv2.resize(frame, self.dsize, dst=out,
                           interpolation=self.interpolation)
            else:
                np.copyto(out, frame)
        if self.masked:
            np.multiply(out, self.mask, out=out)


class BaseVideoLoader(metaclass=ABCMeta):
    """Abstract loader; see module docstring for the contract."""

    def __init__(self) -> None:
        self.start_frame = 0
        self.end_frame = 0
        self.start_time = 0
        self.end_time = 0
        self.runtime_size: list[int] = []
        self.exp_time: float = 0
        self.exp_frame: int = 0
        self.cur_frame: Optional[np.ndarray] = None
        self.mask: Optional[np.ndarray] = None

    @abstractmethod
    def start(self):
        ...

    @abstractmethod
    def reset(self, start_frame=None, end_frame=None):
        ...

    @abstractmethod
    def pop(self) -> Optional[np.ndarray]:
        ...

    @abstractmethod
    def stop(self):
        ...

    @abstractmethod
    def release(self):
        ...

    @property
    @abstractmethod
    def stopped(self) -> bool:
        ...

    @property
    @abstractmethod
    def video_total_frames(self) -> int:
        ...

    @property
    @abstractmethod
    def raw_size(self) -> list[int]:
        ...

    @property
    @abstractmethod
    def fps(self) -> float:
        ...

    @property
    def iterations(self) -> int:
        return self.end_frame - self.start_frame

    @property
    def eq_fps(self) -> float:
        return 1 / self.exp_time

    @property
    def eq_int_fps(self) -> int:
        return floor(self.eq_fps)

    def summary(self) -> BasicInfo:
        return BasicInfo(loader=self.__class__.__name__, video="", mask=None,
                         start_time=self.start_time, end_time=self.end_time,
                         resolution=self.raw_size,
                         runtime_resolution=self.runtime_size,
                         exp_time=self.exp_time, total_frames=self.iterations,
                         fps=self.fps)


class VanillaVideoLoader(BaseVideoLoader):
    """Synchronous loader: decode happens inside ``pop()``
    (reference MetLib/videoloader.py:195-494)."""

    def __init__(self, video_wrapper: Type[BaseVideoWrapper], video_name: str,
                 mask_name: Optional[str] = None,
                 resize_option: Union[int, list, str, None] = None,
                 hwaccel: Optional[str] = None,
                 start_time: Optional[str] = None,
                 end_time: Optional[str] = None, grayscale: bool = False,
                 debayer: bool = False, debayer_pattern: str = "BGGR",
                 exp_option: Union[int, float, str] = "auto",
                 exp_upper_bound: Optional[float] = None,
                 merge_func: str = "not_merge", continue_on_err: bool = False,
                 **kwargs: Any) -> None:
        self.video_wrapper = video_wrapper
        self.video_name = video_name
        self.mask_name = mask_name
        self.grayscale = grayscale
        self.logger = get_default_logger()
        self.status = True
        self.read_stopped = True
        self.debayer = debayer
        self.debayer_pattern = debayer_pattern
        self.continue_on_err = continue_on_err
        self.hwaccel = hwaccel

        self.video = video_wrapper(video_name, hwaccel=hwaccel)
        self.runtime_size = parse_resize_param(resize_option, self.raw_size)
        self.decode_size = self._maybe_scaled_decode()
        self.mask = load_mask(self.mask_name, self.runtime_size,
                              self.grayscale)

        sf = time2frame(timestr2int(start_time), self.fps) if start_time else 0
        ef = (time2frame(timestr2int(end_time), self.fps)
              if end_time else self.video_total_frames)
        self.reset(sf, ef, exp_frame=DEFAULT_EXPOSURE_FRAME)

        self.merge_func = getattr(MergeFunction, merge_func, None)
        if not callable(self.merge_func):
            raise NameError(f"Unsupported merge function name: {merge_func}.")

        self.preprocess = HostPreprocess(
            self.decode_size, self.runtime_size, grayscale, debayer,
            debayer_pattern, self.mask, masked=bool(mask_name),
            interpolation=kwargs.get("resize_interpolation",
                                     cv2.INTER_LINEAR))

        upper = exp_upper_bound if exp_upper_bound is not None \
            else UP_EXPOSURE_BOUND
        self.exp_time = self.init_exp_time(exp_option, upper)
        self.exp_frame = int(round(self.exp_time * self.fps))
        assert not (self.merge_func is MergeFunction.not_merge
                    and self.exp_frame != 1), (
            "Cannot \"not_merge\" frames when exp_frame > 1; specify a merge "
            "function.")

    def _maybe_scaled_decode(self) -> list[int]:
        """Decode-at-analysis-resolution upgrade (size of delivered frames).

        When the runtime resolution is a >=2x downscale of the source and
        the source is an MJPG AVI, frames are demuxed directly and decoded
        by libjpeg AT (or near) the analysis resolution -- the DCT-domain
        1/2^k decode skips most of the IDCT work the decode-full-then-
        resize path pays (measured ~3x less host CPU per 2160p frame).
        Replaces the reference's decode-then-preprocess flow
        (MetLib/videoloader.py:360-388); detection parity with the
        full-decode path is pinned by tests/test_mjpg_scaled.py. Pixel
        values shift slightly (different downsample filter), so opt out
        with METDETPY_TPU_SCALED_DECODE=0 for bit-stable archival runs.
        """
        if os.environ.get("METDETPY_TPU_SCALED_DECODE", "1") == "0":
            return list(self.raw_size)
        dec = getattr(self.video, "set_decode_scale", None)
        if dec is not None:  # wrapper already supports scaled decode
            return list(dec(self.runtime_size))
        rw, rh = self.raw_size
        w, h = self.runtime_size
        if (rw < 2 * w or rh < 2 * h
                or not isinstance(self.video_name, str)):
            return list(self.raw_size)
        from .mjpgavi import MJPGAVIVideoWrapper
        from .videowrapper import OpenCVVideoWrapper
        if not isinstance(self.video, OpenCVVideoWrapper) \
                or not MJPGAVIVideoWrapper.sniff(self.video_name):
            return list(self.raw_size)
        try:
            alt = MJPGAVIVideoWrapper(self.video_name)
        except Exception as exc:
            self.logger.debug(f"scaled-decode upgrade skipped: {exc!r}")
            return list(self.raw_size)
        n_cv = self.video_total_frames
        if alt.num_frames < int(0.98 * n_cv) or list(alt.size) != [rw, rh]:
            self.logger.warning(
                f"scaled-decode upgrade skipped: demuxer sees "
                f"{alt.num_frames} frames / {alt.size}, OpenCV {n_cv} / "
                f"{[rw, rh]}")
            alt.release()
            return list(self.raw_size)
        ds = alt.set_decode_scale(self.runtime_size)
        if ds == [rw, rh]:
            alt.release()
            return list(self.raw_size)
        self.video.release()
        self.video = alt
        self.logger.info(
            f"MJPG scaled decode: {rw}x{rh} source decoded at "
            f"{ds[0]}x{ds[1]} (1/{alt._reduce}) for the {w}x{h} analysis "
            "resolution")
        return list(ds)

    # -- lifecycle -----------------------------------------------------

    def start(self):
        self.cur_iter = self.iterations
        self.read_stopped = False
        self.video.set_to(self.start_frame)

    def reset(self, start_frame=None, end_frame=None, exp_frame=None,
              reset_time_attr: bool = True):
        assert self.read_stopped, \
            f"Cannot reset a running {self.__class__.__name__}."
        if start_frame is not None:
            self.start_frame = max(0, start_frame)
        if end_frame is not None:
            self.end_frame = min(end_frame, self.video_total_frames)
        assert 0 <= self.start_frame <= self.end_frame
        if exp_frame is not None:
            self.exp_frame = exp_frame
        if reset_time_attr:
            self.start_time = frame2time(self.start_frame, self.fps)
            self.end_time = frame2time(self.end_frame, self.fps)
        self.read_stopped = True

    def pop(self) -> Optional[np.ndarray]:
        frames = []
        for i in range(self.exp_frame):
            status, self.cur_frame = self.video.read()
            if status and self.cur_frame is not None:
                frames.append(self.preprocess(self.cur_frame))
            else:
                self.logger.warning(
                    f"Load frame failed at {self.start_frame + i}")
                if not self.continue_on_err:
                    self.stop()
                    break
        self.cur_iter -= self.exp_frame
        if self.cur_iter <= 0:
            self.stop()
        if not frames:
            return None
        if self.exp_frame == 1:
            return frames[0]
        return self.merge_func(frames)

    def stop(self):
        self.read_stopped = True

    def release(self):
        if not self.stopped:
            self.stop()
        self.video.release()

    @property
    def stopped(self) -> bool:
        return self.read_stopped

    @property
    def fps(self) -> float:
        return self.video.fps

    @property
    def video_total_frames(self) -> int:
        return self.video.num_frames

    @property
    def raw_size(self) -> list[int]:
        return self.video.size

    @property
    def _video_desc(self) -> str:
        """Loggable video identity: the path, or a shape summary for
        in-memory array sources (never the full array repr)."""
        if isinstance(self.video_name, np.ndarray):
            return ("ndarray["
                    + "x".join(map(str, self.video_name.shape)) + "]")
        return repr(self.video_name)

    def summary(self) -> BasicInfo:
        info = super().summary()
        info.video = (self.video_name
                      if not isinstance(self.video_name, np.ndarray)
                      else self._video_desc)
        info.mask = self.mask_name
        return info

    def __repr__(self) -> str:
        dec = (f" decode={self.decode_size}"
               if list(self.decode_size) != list(self.raw_size) else "")
        return (f"{self.__class__.__name__}: video={self._video_desc} "
                f"mask={self.mask_name!r} frames={self.video_total_frames} "
                f"raw={self.raw_size}{dec} runtime={self.runtime_size} "
                f"gray={self.grayscale} exp_time={self.exp_time:.2f}s "
                f"fps={self.fps:.2f} (eq_fps={self.eq_fps:.2f})")

    # -- exposure estimation -------------------------------------------

    def init_exp_time(self, exp_option, upper_bound: float) -> float:
        """Resolve the exposure option (reference
        MetLib/videoloader.py:440-494)."""
        fps = self.video.fps
        self.logger.info(f"Parsing \"exp_option\"={exp_option}; "
                         f"metainfo FPS={fps:.2f}")
        if fps <= int(1 / upper_bound):
            self.logger.warning(f"Slow FPS detected. Use {1/fps:.2f}s.")
            return 1 / fps
        if isinstance(exp_option, str):
            if exp_option == "real-time":
                return 1 / fps
            if exp_option == "slow":
                return SLOW_EXP_TIME
            if exp_option == "auto":
                rf = rf_estimator(self)
                if rf / fps >= upper_bound:
                    self.logger.warning(
                        f"Exposure too long ({rf/fps:.2f}s); clamped to "
                        f"{upper_bound:.2f}s.")
                return min(rf / fps, upper_bound)
            try:
                exp_time = float(exp_option)
            except ValueError as e:
                raise ValueError(
                    f"{e!r}: invalid exp_time; use a number or one of "
                    f"real-time/auto/slow, got {exp_option}.")
        else:
            exp_time = exp_option
        if exp_time * fps < 1:
            self.logger.warning(f"Exposure too short; using {1/fps:.2f}s.")
            return 1 / fps
        return float(exp_time)


_POOL_LOCK = threading.Lock()
_POOL_CACHE: dict[tuple, list] = {}


def _lease_block_pool(shape: tuple, n: int) -> list:
    """Check out a pre-faulted block-buffer pool for `shape`.

    Faulting in fresh anonymous memory measured as low as ~6 MB/s while
    the TPU client streams (mmap + THP compaction pathology on this
    host), so buffer pools are allocated once per process and leased
    across loader instances/passes instead of reallocated per run.
    """
    with _POOL_LOCK:
        pools = _POOL_CACHE.setdefault(shape, [])
        if pools:
            pool = pools.pop()
            if len(pool) >= n:
                return pool
            pool.extend(np.zeros(shape, np.uint8)
                        for _ in range(n - len(pool)))
            return pool
    return [np.zeros(shape, np.uint8) for _ in range(n)]


def _return_block_pool(shape: tuple, pool: list) -> None:
    with _POOL_LOCK:
        _POOL_CACHE.setdefault(shape, []).append(pool)


class BlockVideoLoader(VanillaVideoLoader):
    """Block-oriented loader for the device pipeline.

    The decode thread preprocesses frames on the host, merges every
    ``exp_frame`` raw frames (uint8 max, same as MergeFunction.max) and
    appends the merged frame to the current block; completed
    ``[block_frames, H, W]`` blocks go into a bounded queue, and the
    consumer uploads each with one host->device copy. ``pop()`` still
    yields single frames for API compatibility.

    Blocks are views of a pool of reused host buffers: a consumer must
    finish its copy of a block before it pops ``pool_size - 1`` more.

    With ``keep_color_stacks=True`` the thread additionally maintains a
    color max-stack per RECHECK_CHUNK merged frames, giving the recheck
    stage its stacked images without a second decode of the video.
    """

    def __init__(self, *args: Any, block_frames: Optional[int] = None,
                 maxsize: int = 4, keep_color_stacks: bool = False,
                 **kwargs: Any) -> None:
        import os
        if block_frames is None:
            block_frames = int(os.environ.get("METDETPY_TPU_BLOCK_FRAMES",
                                              DEFAULT_BLOCK_FRAMES))
        self.block_frames = block_frames
        self.block_queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.keep_color_stacks = keep_color_stacks
        self.color_stacks: dict[int, np.ndarray] = {}
        # decode-thread stage accounting (read/preproc/merge/qput),
        # surfaced into the pipeline performance dict
        self.stage_stats: dict = {}
        self._stop_requested = False
        super().__init__(*args, **kwargs)

    def clear_queue(self):
        while not self.block_queue.empty():
            self.block_queue.get()

    def start(self):
        self.clear_queue()
        self.color_stacks.clear()
        self.stage_stats.clear()
        self._pending = []
        self._peeked = None
        self._thread_exc = None
        self.read_stopped = False
        self._stop_requested = False
        self.status = True
        self.video.set_to(self.start_frame)
        self.thread = threading.Thread(target=self._blockloop, daemon=True)
        self.thread.start()

    PREPROC_CHUNK = 16  # raw frames preprocessed in parallel per batch

    def _read_raw_chunk(self, want: int) -> list:
        """Sequentially decode up to `want` raw frames (decoder state is
        not thread-safe; only the preprocess fans out)."""
        if self._peeked is not None:
            out, self._peeked = self._peeked, None
            return out
        out = []
        while len(out) < want:
            if self.read_stopped:
                break
            self.status, raw = self.video.read()
            if not self.status or raw is None:
                if not self.continue_on_err:
                    self.read_stopped = True
                    break
                continue
            out.append(raw)
        return out

    def _blockloop(self):
        import os as _os
        import time as _time
        from concurrent.futures import ThreadPoolExecutor
        stats = self.stage_stats
        stats.update({"read": 0.0, "preproc": 0.0, "merge": 0.0,
                      "qput": 0.0})
        loop_t0 = _time.perf_counter()
        e = self.exp_frame
        w, h = self.runtime_size
        n_raw_total = (self.iterations // e) * e
        # Pre-allocated, PRE-FAULTED pool of block buffers, reused
        # round-robin. Allocating a fresh 33MB block per 64 frames looks
        # harmless but measured 0.7-6 s per np.empty while the TPU client
        # streams previous blocks (fresh mmap + first-touch faults + THP
        # compaction contending with the transfer pump) -- it was 75-85%
        # of e2e wall time. A buffer re-enters use only after
        # pool_size-1 newer blocks were queued/dispatched/collected, by
        # which point its device transfer has long completed. Color
        # loaders (grayscale=False, e.g. MLDetector) carry 3 channels.
        block_shape = (self.block_frames, h, w) if self.grayscale \
            else (self.block_frames, h, w, 3)
        pool_size = self.block_queue.maxsize + int(
            _os.environ.get("METDETPY_TPU_PIPELINE_DEPTH", 6)) + 2
        block_pool = _lease_block_pool(block_shape, pool_size)
        # returned to the cache in release(), once the consumer has
        # drained the queue (queued blocks alias these buffers)
        self._leased_pool = (block_shape, block_pool)
        pool_idx = 0
        block = block_pool[pool_idx]
        n_in_block = 0
        color_acc: Optional[np.ndarray] = None
        merged_idx = 0
        pending_gray: list[np.ndarray] = []
        pending_color: list[np.ndarray] = []
        # direct path: preprocess straight into the block slot (zero
        # per-frame allocations -- fresh 0.5MB resize outputs showed the
        # same mmap/THP stalls as fresh blocks; and one GIL handoff per
        # frame instead of pool-scheduling churn on this 1-core host)
        direct = not self.keep_color_stacks and not self.debayer
        if direct and e > 1:
            merge_scratch = np.zeros(block_shape[1:], np.uint8)
        resize_scratch = None
        pool = None if direct else ThreadPoolExecutor(max_workers=4)
        try:
            raw_left = n_raw_total
            while raw_left > 0 and not self.read_stopped:
                t0 = _time.perf_counter() if stats is not None else 0.0
                chunk = self._read_raw_chunk(min(self.PREPROC_CHUNK,
                                                 raw_left))
                if stats is not None:
                    stats["read"] += _time.perf_counter() - t0
                if not chunk:
                    break
                raw_left -= len(chunk)
                t0 = _time.perf_counter() if stats is not None else 0.0
                if direct:
                    # unmasked chunks headed for a gray block can assemble
                    # through ONE native call (cv2-bit-exact INTER_LINEAR
                    # resize + BT.601 gray conversion for color sources +
                    # exposure merge, GIL released for the whole chunk) --
                    # but only when the start-time probe says the fused C
                    # loop actually beats cv2's SIMD per-frame kernels on
                    # this host (see _native_assemble_wins); anything else
                    # -- color output blocks, masks, non-linear
                    # interpolation -- goes through the per-frame into()
                    # path
                    native_ok = (self.grayscale
                                 and chunk[0].ndim in (2, 3)
                                 and not self.preprocess.masked
                                 and self.preprocess.interpolation
                                 == cv2.INTER_LINEAR
                                 and _native_assemble_wins(
                                     chunk[0].shape, (h, w)))
                    if (resize_scratch is None and chunk[0].ndim == 3
                            and self.preprocess.resize):
                        resize_scratch = np.zeros((h, w, 3), np.uint8)
                    if native_ok:
                        if chunk[0].ndim == 3:
                            assemble = _resize_bgr2gray_assemble_u8
                            if (resize_scratch is None
                                    and self.preprocess.resize):
                                resize_scratch = np.zeros((h, w, 3),
                                                          np.uint8)
                        else:
                            assemble = _resize_assemble_u8
                        pending_gray.extend(chunk)
                        while len(pending_gray) >= e:
                            g = min(len(pending_gray) // e,
                                    self.block_frames - n_in_block)
                            take = pending_gray[:g * e]
                            pending_gray = pending_gray[g * e:]
                            scratch = merge_scratch if e > 1 else None
                            if assemble is _resize_bgr2gray_assemble_u8:
                                assemble(take, block, n_in_block, e,
                                         color_scratch=resize_scratch,
                                         gray_scratch=scratch)
                            else:
                                assemble(take, block, n_in_block, e,
                                         scratch)
                            n_in_block += g
                            merged_idx += g
                            if n_in_block == self.block_frames:
                                if stats is not None:
                                    stats["merge"] += (_time.perf_counter()
                                                       - t0)
                                    t0 = _time.perf_counter()
                                self._put_block(block)
                                pool_idx = (pool_idx + 1) % pool_size
                                block = block_pool[pool_idx]
                                n_in_block = 0
                                if stats is not None:
                                    stats["qput"] += (_time.perf_counter()
                                                      - t0)
                                    t0 = _time.perf_counter()
                        if stats is not None:
                            stats["merge"] += _time.perf_counter() - t0
                        continue
                    for raw in chunk:
                        slot = block[n_in_block]
                        if e == 1:
                            self.preprocess.into(raw, slot, resize_scratch)
                        else:
                            pos = len(pending_gray)
                            if pos == 0:
                                self.preprocess.into(raw, slot,
                                                     resize_scratch)
                            else:
                                self.preprocess.into(raw, merge_scratch,
                                                     resize_scratch)
                                _u8_max_inplace(slot, merge_scratch)
                            pending_gray.append(None)
                            if len(pending_gray) < e:
                                continue
                            pending_gray.clear()
                        n_in_block += 1
                        merged_idx += 1
                        if n_in_block == self.block_frames:
                            if stats is not None:
                                stats["merge"] += _time.perf_counter() - t0
                                t0 = _time.perf_counter()
                            self._put_block(block)
                            pool_idx = (pool_idx + 1) % pool_size
                            block = block_pool[pool_idx]
                            n_in_block = 0
                            if stats is not None:
                                stats["qput"] += _time.perf_counter() - t0
                                t0 = _time.perf_counter()
                    if stats is not None:
                        stats["merge"] += _time.perf_counter() - t0
                    continue
                # pooled path (color recheck stacks / debayer)
                if self.keep_color_stacks:
                    results = list(pool.map(
                        lambda r: self.preprocess(r, keep_color=True),
                        chunk))
                    pending_gray.extend(g for g, _ in results)
                    pending_color.extend(c for _, c in results)
                else:
                    pending_gray.extend(pool.map(self.preprocess, chunk))
                if stats is not None:
                    stats["preproc"] += _time.perf_counter() - t0
                    t0 = _time.perf_counter()
                # merge complete exposure groups into the block buffer
                while len(pending_gray) >= e:
                    group, pending_gray = pending_gray[:e], pending_gray[e:]
                    slot = block[n_in_block]
                    np.copyto(slot, group[0])
                    for f in group[1:]:
                        _u8_max_inplace(slot, f)
                    n_in_block += 1
                    if self.keep_color_stacks:
                        cgroup = pending_color[:e]
                        pending_color = pending_color[e:]
                        # a copy: an in-memory source hands out views of
                        # the caller's frames, which the in-place maxima
                        # below must not write to
                        color = np.array(cgroup[0])
                        for f in cgroup[1:]:
                            _u8_max_inplace(color, f)
                        if color_acc is None:
                            color_acc = color
                        else:
                            _u8_max_inplace(color_acc, color)
                        if (merged_idx + 1) % RECHECK_CHUNK == 0:
                            self.color_stacks[merged_idx // RECHECK_CHUNK] \
                                = color_acc
                            color_acc = None
                    merged_idx += 1
                    if n_in_block == self.block_frames:
                        if stats is not None:
                            stats["merge"] += _time.perf_counter() - t0
                            t0 = _time.perf_counter()
                        self._put_block(block)
                        pool_idx = (pool_idx + 1) % pool_size
                        block = block_pool[pool_idx]
                        n_in_block = 0
                        if stats is not None:
                            stats["qput"] += _time.perf_counter() - t0
                            t0 = _time.perf_counter()
                if stats is not None:
                    stats["merge"] += _time.perf_counter() - t0
            if n_in_block:
                self._put_block(block[:n_in_block].copy())
            if self.keep_color_stacks and color_acc is not None:
                self.color_stacks[merged_idx // RECHECK_CHUNK] = color_acc
        except BaseException as exc:  # surface decode-thread failures
            self._thread_exc = exc
        finally:
            stats["loop_wall"] = _time.perf_counter() - loop_t0
            if _os.environ.get("METDETPY_TPU_LOADER_STATS"):
                self.logger.info("loader stats: " + ", ".join(
                    f"{k}={v:.2f}" for k, v in stats.items()))
            if pool is not None:
                pool.shutdown(wait=False)
            self.read_stopped = True
            self._put_eos()

    def _put_block(self, block: np.ndarray) -> None:
        """Queue a completed block with indefinite backpressure: the
        consumer can legitimately stall (a first kernel build takes
        seconds), so a bounded put timeout must retry, not kill the decode
        thread. Stops promptly when the loader is stopped."""
        while True:
            try:
                self.block_queue.put(block, timeout=PUT_TIMEOUT)
                return
            except queue.Full:
                if self.read_stopped:
                    raise

    def _put_eos(self):
        """Deliver the end-of-stream sentinel. It must not be dropped:
        with a fast producer the queue is routinely full here, and a
        lost None makes the consumer eat the full pop timeout at end of
        stream."""
        for _ in range(120):
            try:
                self.block_queue.put(None, timeout=PUT_TIMEOUT)
                return
            except queue.Full:
                continue

    def pop_block(self):
        """Return the next [T, H, W(, 3)] uint8 block of merged frames, or
        None at end of stream. Re-raises any decode-thread failure instead
        of silently ending the stream."""
        try:
            item = self.block_queue.get(timeout=GET_TIMEOUT * 6)
        except queue.Empty:
            item = None
        if item is None and getattr(self, "_thread_exc", None) is not None:
            exc, self._thread_exc = self._thread_exc, None
            raise RuntimeError("video decode thread failed") from exc
        return item

    def recheck_stack(self, start_merged: int, end_merged: int
                      ) -> Optional[np.ndarray]:
        """Color max-stack covering merged-frame range [start, end].

        Uses chunk-aligned boundaries (the stack may cover up to
        RECHECK_CHUNK-1 extra merged frames on each side), trading exact
        clip bounds for the elimination of the reference's second decode
        pass (MetLib/collector.py:789-792).
        """
        if not self.color_stacks:
            return None
        c0 = max(0, start_merged // RECHECK_CHUNK)
        c1 = end_merged // RECHECK_CHUNK
        acc = None
        for c in range(c0, c1 + 1):
            chunk = self.color_stacks.get(c)
            if chunk is None:
                continue
            acc = chunk if acc is None else np.maximum(acc, chunk)
        return acc

    def pop(self):
        """Single merged frame, assembled from block reads (compat path)."""
        if not hasattr(self, "_pending"):
            self._pending: list[np.ndarray] = []
        while not self._pending:
            blk = self.pop_block()
            if blk is None:
                self.read_stopped = True
                return None
            self._pending = list(blk)
        return self._pending.pop(0)

    def stop(self):
        self._stop_requested = True
        self.read_stopped = True

    def release(self):
        super().release()
        self.clear_queue()
        leased = getattr(self, "_leased_pool", None)
        if leased is not None:
            self._leased_pool = None
            _return_block_pool(*leased)

    @property
    def stopped(self) -> bool:
        return self.read_stopped and self.block_queue.empty()


# ---------------------------------------------------------------------------
# Real-exposure ("real FPS") estimator
# (reference MetLib/videoloader.py:796-870)
# ---------------------------------------------------------------------------


def _rf_est_kernel(video_loader: BaseVideoLoader) -> np.ndarray:
    """Frame-sum curvature analysis on a window of frames: positions where
    the pixel-sum second difference flips (a fresh exposure began) give the
    real inter-exposure intervals."""
    try:
        n_frames = video_loader.iterations
        video_loader.start()
        f_sum = np.zeros((n_frames,), dtype=float)
        for i in range(n_frames):
            if video_loader.stopped:
                f_sum = f_sum[:i]
                break
            frame = video_loader.pop()
            if frame is not None:
                f_sum[i] = np.sum(frame)
        a0, a1, a2, a3 = f_sum[:-3], f_sum[1:-2], f_sum[2:-1], f_sum[3:]
        diff = f_sum[1:] - f_sum[:-1]
        rmax_pos = np.where((2 * a2 - (a1 + a3) > 0)
                            & (2 * a1 - (a0 + a2) < 0)
                            & (np.abs(diff[1:-1]) > 0.01))[0]
    finally:
        video_loader.stop()
    return rmax_pos[1:] - rmax_pos[:-1]


def rf_estimator(video_loader: BaseVideoLoader) -> Union[float, int]:
    """Estimate the real exposure interval (in frames) of a slow-shutter
    video; samples 3x100-frame chunks for long videos."""
    start_frame, end_frame = video_loader.start_frame, video_loader.end_frame
    iteration_frames = video_loader.iterations
    raw_exp_frame = video_loader.exp_frame
    video_loader.exp_frame = 1

    if iteration_frames < SHORT_LENGTH_THRESHOLD:
        intervals = _rf_est_kernel(video_loader)
    else:
        video_loader.reset(end_frame=start_frame + RF_ESTIMATE_LENGTH)
        i1 = _rf_est_kernel(video_loader)
        video_loader.reset(
            start_frame=start_frame + (iteration_frames
                                       - RF_ESTIMATE_LENGTH) // 2,
            end_frame=start_frame + (iteration_frames
                                     + RF_ESTIMATE_LENGTH) // 2)
        i2 = _rf_est_kernel(video_loader)
        video_loader.reset(start_frame=end_frame - RF_ESTIMATE_LENGTH,
                           end_frame=end_frame)
        i3 = _rf_est_kernel(video_loader)
        intervals = np.concatenate([i1, i2, i3])

    video_loader.exp_frame = raw_exp_frame
    video_loader.reset(start_frame, end_frame)

    if len(intervals) == 0:
        return 1
    return np.round(np.min([np.median(intervals),
                            np.mean(sigma_clip(intervals))]))
