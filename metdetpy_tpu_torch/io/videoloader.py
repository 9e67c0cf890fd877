"""Video loaders: mask loading, resize parsing, preprocess, exposure-time
estimation, and frame/block delivery (host side of the port).

A copy of the JAX package's ``io/videoloader.py`` (API parity with
reference MetLib/videoloader.py:48-192: start / pop / reset / stop /
release / summary + exp-time estimation), with the upload written for
PyTorch. Delivery models:

  - ``VanillaVideoLoader`` / ``ThreadVideoLoader``: per-frame ``pop()``,
    the reference's pipeline (decode inside ``pop``, or a decode thread
    and a bounded queue, reference MetLib/videoloader.py:497-631).
  - ``BlockVideoLoader``: the device feed. The decode thread assembles
    preprocessed frames into contiguous uint8 blocks of ``block_frames``
    exposure-merged frames; ``pop_block()`` hands whole ``[T, H, W]``
    blocks to the consumer, or, in device-put mode, tensors the loader has
    already uploaded from pinned memory on a stream of its own (and, where
    it is exact, preprocessed on the device). When recheck is enabled it
    also maintains per-chunk color max-stacks so the recheck stage needs no
    second decode pass (the reference re-decodes every clip,
    MetLib/collector.py:789-792).
  - ``ProcessVideoLoader``: the block feed decoded in a child process
    through a shared-memory ring.

``torch`` is imported only inside the functions that upload, so the
decode worker process stays host-only.
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
from ..profiling import StageTimer
from ..structs import BasicInfo
from ..utils import (frame2time, parse_resize_param, sigma_clip, time2frame,
                     timestr2int)
from ..native import resize_assemble_u8 as _resize_assemble_u8
from ..native import \
    resize_bgr2gray_assemble_u8 as _resize_bgr2gray_assemble_u8
from ..native import u8_max_inplace as _u8_max_inplace
from .fileio import load_mask
from .videowrapper import BaseVideoWrapper, NumpyVideoWrapper

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
# blocks the detect loop keeps in flight (``api._run_block_loop``); a
# decode loop's block pool holds the block queue's, these and two more
PIPELINE_DEPTH = 6

_ASSEMBLE_PROBE_CACHE: dict = {}


def _native_assemble_wins(src_shape: tuple, dst_hw: tuple) -> bool:
    """Start-time probe: fused-C chunk assembly vs cv2's SIMD per-frame
    kernels (resize [+ gray]) for this (source shape -> block shape).

    cv2's hand-vectorized resize measured 10-14x faster than the scalar
    fixed-point C loop on an uncontended core (1080p -> 960x540), while
    the C path's one-GIL-release-per-chunk advantage has measured wins on
    a host under heavy allocator/THP contention -- so measure at loader
    start instead of hard-coding either. Both paths are cv2-bit-exact, so
    the choice never changes results."""
    key = (tuple(src_shape), tuple(dst_hw))
    if key in _ASSEMBLE_PROBE_CACHE:
        return _ASSEMBLE_PROBE_CACHE[key]
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
    # interleaved min-of-3 per path: a shared host's CPU stalls come in
    # multi-ms episodes (THP, steal), so alternating samples keeps one
    # episode from poisoning a single path's whole measurement; min takes
    # each path's cleanest sample
    t_native = t_cv2 = float("inf")
    for _ in range(3):
        t_native = min(t_native, _timeit(native))
        t_cv2 = min(t_cv2, _timeit(cv2_path))
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
        allocation-free: a fresh 0.5MB output faults in new pages, which
        under allocator/THP contention stalled for up to seconds, so the
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


class ThreadVideoLoader(VanillaVideoLoader):
    """Decode-thread loader with a bounded frame queue
    (reference MetLib/videoloader.py:497-631)."""

    def __init__(self, *args: Any, maxsize: int = 32, **kwargs: Any) -> None:
        self.maxsize = maxsize
        self.queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        super().__init__(*args, **kwargs)

    def clear_queue(self):
        while not self.queue.empty():
            self.queue.get()

    def start(self):
        self.clear_queue()
        self.read_stopped = False
        self.status = True
        self.video.set_to(self.start_frame)
        self.thread = threading.Thread(target=self._videoloop, daemon=True)
        self.thread.start()

    def pop(self):
        if self.stopped:
            self.thread.join()
            raise Exception(f"Attempt to read from an ended "
                            f"{self.__class__.__name__}.")
        ret = []
        try:
            for _ in range(self.exp_frame):
                if self.stopped:
                    break
                frame = self.queue.get(timeout=GET_TIMEOUT)
                if isinstance(frame, str):
                    raise queue.Empty()
                ret.append(frame)
        except queue.Empty:
            if not self.read_stopped:
                raise
        if not ret:
            return None
        return self.merge_func(ret)

    def _put_wait(self, item) -> bool:
        """Put with indefinite backpressure while the loader is live: the
        consumer can legitimately stall far past one PUT_TIMEOUT (a first
        kernel build), and a decode thread that dies on queue.Full silently
        truncates the stream. Returns False once the loader is stopped."""
        while True:
            try:
                self.queue.put(item, timeout=PUT_TIMEOUT)
                return True
            except queue.Full:
                if self.read_stopped:
                    return False

    def _videoloop(self):
        try:
            for i in range(self.iterations):
                if self.read_stopped or not self.status:
                    if not self.continue_on_err:
                        break
                self.status, self.cur_frame = self.video.read()
                if self.status and self.cur_frame is not None:
                    if not self._put_wait(self.preprocess(self.cur_frame)):
                        break
                else:
                    self.logger.warning(
                        f"Load frame failed at {self.start_frame + i}")
                    if not self.continue_on_err:
                        self.stop()
                        self._put_wait(FAILED_FLAG)
                        break
        finally:
            self.stop()

    def stop(self):
        if not self.read_stopped:
            super().stop()

    def release(self):
        super().release()
        self.clear_queue()

    @property
    def stopped(self) -> bool:
        return self.read_stopped and self.queue.empty()


_POOL_LOCK = threading.Lock()
_POOL_CACHE: dict[tuple, list] = {}


def _timeit(fn) -> float:
    import time
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _lease_block_pool(shape: tuple, n: int, pinned: bool = False) -> list:
    """Check out a pre-faulted block-buffer pool for ``shape``.

    Buffers are allocated once per process and leased across loader
    instances and passes: faulting in (or pinning) hundreds of MB per run
    costs seconds. With ``pinned`` the buffers are page-locked host memory
    (``torch.empty(..., pin_memory=True)`` viewed as numpy), so the card's
    copy engine reads them directly and the upload does not wait for the
    host.
    """
    def alloc():
        if pinned:
            import torch
            return torch.empty(shape, dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.zeros(shape, np.uint8)

    key = (shape, pinned)
    with _POOL_LOCK:
        pools = _POOL_CACHE.setdefault(key, [])
        if pools:
            pool = pools.pop()
            if len(pool) >= n:
                return pool
            pool.extend(alloc() for _ in range(n - len(pool)))
            return pool
    return [alloc() for _ in range(n)]


def _return_block_pool(shape: tuple, pool: list, pinned: bool) -> None:
    with _POOL_LOCK:
        _POOL_CACHE.setdefault((shape, pinned), []).append(pool)


# pinned host memory a staging ring may hold (one allocation of its slots)
_STAGE_RING_BYTES = 1 << 30


class _StagingRing:
    """The slots an in-memory feed's blocks are staged in before their
    upload: ``slots[i]`` is one block buffer. A slot goes back to the free
    list through ``freer(i)``, which the uploader calls once the copy
    out of the slot has completed (after its event), so a slot is
    refilled only then, however many newer blocks were queued."""

    def __init__(self, slots: np.ndarray) -> None:
        self.slots = slots
        self._free: "queue.Queue[int]" = queue.Queue()
        for i in range(len(slots)):
            self._free.put(i)

    def take(self, stopped) -> Optional[int]:
        """A free slot's index; None once ``stopped()`` is true (polled
        every 50 ms, so a stopped loader's decode thread ends promptly)."""
        while True:
            try:
                return self._free.get(timeout=0.05)
            except queue.Empty:
                if stopped():
                    return None

    def freer(self, i: int):
        return lambda: self._free.put(i)


class BlockVideoLoader(VanillaVideoLoader):
    """Block-oriented loader for the device pipeline.

    The decode thread preprocesses frames on the host, merges every
    ``exp_frame`` raw frames (uint8 max, same as MergeFunction.max) and
    appends the merged frame to the current block; completed
    ``[block_frames, H, W]`` blocks go into a bounded queue. ``pop()``
    still yields single frames for API compatibility.

    In host mode (``device_put=False``) ``pop_block`` returns the blocks
    themselves: views of a pool of reused host buffers, so a consumer must
    finish its copy of a block before it pops ``pool_size - 1`` more.

    In device-put mode the loader uploads: an uploader thread copies each
    completed block from the pinned pool to ``device`` on a stream of its
    own, pads a short tail block there by repeating its last frame, and
    hands ``(device tensor, n_real)`` pairs to ``pop_block``. The slot goes
    back to the decode thread only once its copy has completed (the
    uploader waits for the copy's event), and each tensor is marked as used
    on the consumer's stream (``record_stream``), so the caching allocator
    does not hand its memory to a later upload while the consumer's work
    still reads it. The decode loop follows from the input alone
    (``_device_preproc_gate``): where the runtime frame is the raw frame
    or exactly half of it (gray target, no mask, single-frame exposure)
    and the source is gray, the preprocess runs on the device
    (``_rawblockloop``): the decode thread then only assembles raw frames,
    and the uploader runs the cv2-exact downscale and gray conversion
    after the copy; every other input, a colour source too, takes the
    host preprocess (``_blockloop``). An
    in-memory gray source is staged block by block into a leased ring
    (``_StagingRing``) whose slots are refilled only once their upload has
    completed, so every upload to a card reads pinned memory, a short
    tail block too.

    With ``keep_color_stacks=True`` the thread additionally maintains a
    color max-stack per RECHECK_CHUNK merged frames, giving the recheck
    stage its stacked images without a second decode of the video (span
    ``loader.color_stack``, inside ``loader.merge``; counter
    ``loader.color_stack_bytes``, the colour frames merged).
    """

    def __init__(self, *args: Any, block_frames: Optional[int] = None,
                 maxsize: int = 4, keep_color_stacks: bool = False,
                 device_put: bool = False, device="cpu",
                 spans: Optional[StageTimer] = None, **kwargs: Any) -> None:
        if block_frames is None:
            block_frames = int(os.environ.get("METDETPY_TPU_BLOCK_FRAMES",
                                              DEFAULT_BLOCK_FRAMES))
        self.block_frames = block_frames
        self.block_queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.keep_color_stacks = keep_color_stacks
        self.color_stacks: dict[int, np.ndarray] = {}
        # host frames while the constructor estimates the exposure (an
        # "auto" exposure pops frames); device-put mode is set after it
        self.device_put_mode = False
        self.device = device
        # the span recorder of the decode and uploader threads (the call's
        # own, where detect_video hands it in), and what the loader found
        # out besides: the placement
        self.spans = StageTimer() if spans is None else spans
        self.stage_stats: dict = {}
        self._stop_requested = False
        self._upload_queue = None
        self._upload_thread = None
        self._upload_stop = None
        self._upload_stream = None
        super().__init__(*args, **kwargs)
        # device-put mode: blocks are uploaded by the loader (see the class
        # docstring) and the queue carries (device tensor, n_real) pairs
        self.device_put_mode = device_put

    @property
    def _pinned(self) -> bool:
        """Block buffers are pinned where the loader uploads to a card."""
        return self.device_put_mode and str(self.device).startswith("cuda")

    def clear_queue(self):
        while not self.block_queue.empty():
            self.block_queue.get()

    def start(self):
        # retire any uploader from a previous start() before resetting
        # state. The uploader takes its queues and stop event as arguments,
        # so even a stale thread that outlives the join can never forward
        # blocks or an EOS into the fresh run's queues; it may still read
        # pooled buffers though, so if it survives the bounded join the old
        # buffer lease is abandoned rather than returned (see release()).
        old_up = self._upload_thread
        if old_up is not None and old_up.is_alive():
            if self._upload_stop is not None:
                self._upload_stop.set()
            self._stop_requested = True
            self.clear_queue()
            old_up.join(timeout=PUT_TIMEOUT)
            if old_up.is_alive() and getattr(self, "_leased_pool",
                                             None) is not None:
                self._leased_pool = None  # leak, don't alias
        self.clear_queue()
        self.color_stacks.clear()
        self.stage_stats.clear()
        self._pending = []
        self._peeked = None
        self._dev_preproc_fn = None
        self._thread_exc = None
        self.read_stopped = False
        self._stop_requested = False
        self.status = True
        self.video.set_to(self.start_frame)
        if self.device_put_mode and str(self.device).startswith("cuda"):
            import torch
            if self._upload_stream is None:
                self._upload_stream = torch.cuda.Stream(device=self.device)
        target = (self._blockloop if self._device_preproc_gate() is None
                  else self._rawblockloop)
        # device-put mode: the decode thread hands completed blocks to the
        # uploader thread, so decode and the upload overlap. Bounded to
        # UPLOAD_DEPTH (3) queued blocks: a pooled slot is reused only
        # after pool_size (>= 12) newer blocks, so 3 queued + 1 staging can
        # never alias a slot the decoder is refilling (a staging ring's
        # slot only after its upload has completed).
        self._upload_queue = None
        self._upload_thread = None
        self._upload_stop = None
        if self.device_put_mode:
            self._upload_queue = queue.Queue(maxsize=self.UPLOAD_DEPTH)
            self._upload_stop = threading.Event()
            self._upload_thread = threading.Thread(
                target=self._uploadloop,
                args=(self._upload_queue, self.block_queue,
                      self._upload_stop),
                name="loader.upload", daemon=True)
            self._upload_thread.start()
        self.thread = threading.Thread(target=target, name="loader.decode",
                                       daemon=True)
        self.thread.start()

    def _device_preproc_gate(self) -> Optional[bool]:
        """Whether the whole preprocess runs on the device (cv2-exact:
        2:1 downscale + BT.601 gray, ops.transforms.make_block_preprocess),
        letting the decode thread assemble raw blocks (the host does only
        the codec decode). Returns the down2 flag, or None for the host
        path; the same on every device.

        Conditions: device-put mode, gray target, no mask/debayer/colour
        stacks, single-frame exposure, linear interpolation, and the
        runtime size either equal to or exactly half the raw size. A
        colour source still goes to the host path (``_rawblockloop`` sees
        it in its first frames)."""
        if not self.device_put_mode or self.keep_color_stacks:
            return None
        if (not self.grayscale or self.preprocess.masked or self.debayer
                or self.exp_frame != 1
                or self.preprocess.interpolation != cv2.INTER_LINEAR):
            return None
        rw, rh = self.decode_size
        w, h = self.runtime_size
        if (rw, rh) == (w, h):
            return False
        if (rw, rh) == (2 * w, 2 * h):
            return True
        return None

    PREPROC_CHUNK = 16  # raw frames preprocessed in parallel per batch
    UPLOAD_DEPTH = 3  # blocks queued for the uploader thread

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

    def _lease(self, block_shape: tuple, pool_size: int) -> list:
        """Lease the block pool for this run, to be returned in
        release()."""
        pool = _lease_block_pool(block_shape, pool_size, self._pinned)
        # returned to the cache in release(), once the consumer has
        # drained the queue (queued blocks alias these buffers)
        self._leased_pool = (block_shape, pool, self._pinned)
        return pool

    def _lease_ring(self, frame_shape: tuple) -> _StagingRing:
        """Lease the staging ring of an in-memory feed: one buffer of
        ``UPLOAD_DEPTH + 2`` block slots (the queued uploads, the one being
        copied and the one being filled), at most ``_STAGE_RING_BYTES``
        and at least two slots; pinned where the loader uploads to a
        card."""
        block = (self.block_frames,) + tuple(frame_shape)
        n = max(2, min(self.UPLOAD_DEPTH + 2,
                       _STAGE_RING_BYTES // int(np.prod(block))))
        return _StagingRing(self._lease((n,) + block, 1)[0])

    def _rawblockloop(self):
        """Raw-block decode loop of the device preprocess: gray frames are
        copied verbatim into raw-size block buffers; the upload runs the
        exact resize and gray conversion on the device after its copy.
        A colour source, seen in its first frames, goes to the
        host-preprocess loop instead."""
        from ..ops.transforms import make_block_preprocess
        spans = self.spans
        loop = spans.span("loader.loop")
        loop.__enter__()
        merge = spans.span("loader.merge")
        handed_off = False  # to _blockloop, which ends the stream itself
        try:
            down2 = self._device_preproc_gate()
            src = getattr(self.video, "frames", None)
            if (isinstance(self.video, NumpyVideoWrapper)
                    and isinstance(src, np.ndarray) and src.ndim == 3
                    and src.dtype == np.uint8 and src.flags.c_contiguous):
                # in-memory gray sources: no decode, no merge; each
                # block's frames are staged into a slot of the leased
                # ring (torch's CPU copy on its intra-op pool, the lock
                # released), so the upload reads pinned memory on a card
                # and runs beside the consumer's work. The slot is
                # refilled once its upload has completed; nothing of the
                # caller's array is kept from one call to the next.
                import torch
                self._dev_preproc_fn = make_block_preprocess(
                    bool(down2), color=False)
                self.stage_stats["placement"] = "device"
                start = self.video.get_video_pos()
                total = min(self.iterations, src.shape[0] - start)
                bf = self.block_frames
                ring = self._lease_ring(src.shape[1:])
                for a in range(start, start + total, bf):
                    if self.read_stopped:
                        break
                    i = ring.take(lambda: self.read_stopped)
                    if i is None:
                        break
                    frames = src[a:min(a + bf, start + total)]
                    block = ring.slots[i][:len(frames)]
                    with spans.span("loader.stage"):
                        torch.from_numpy(block).copy_(
                            torch.from_numpy(frames))
                    spans.count("loader.stage_bytes", block.nbytes)
                    self._put_block(block, ring.freer(i))
                self.video.set_to(start + total)
                return
            with spans.span("loader.read"):
                first = self._read_raw_chunk(self.PREPROC_CHUNK)
            if not first:
                return
            if first[0].ndim == 3:   # colour: the host preprocess
                self._peeked = first
                handed_off = True
                loop.__exit__(None, None, None)
                self._blockloop()
                return
            self._dev_preproc_fn = make_block_preprocess(bool(down2),
                                                         color=False)
            self.stage_stats["placement"] = "device"
            rw, rh = self.decode_size
            block_shape = (self.block_frames, rh, rw)
            pool_size = self.block_queue.maxsize + PIPELINE_DEPTH + 2
            block_pool = self._lease(block_shape, pool_size)
            pool_idx = 0
            block = block_pool[pool_idx]
            n_in_block = 0
            raw_left = self.iterations - len(first)
            chunk = first
            while True:
                merge.__enter__()
                for raw in chunk:
                    np.copyto(block[n_in_block], raw)
                    n_in_block += 1
                    if n_in_block == self.block_frames:
                        merge.__exit__(None, None, None)
                        self._put_block(block)
                        pool_idx = (pool_idx + 1) % pool_size
                        block = block_pool[pool_idx]
                        n_in_block = 0
                        merge.__enter__()
                merge.__exit__(None, None, None)
                if raw_left <= 0 or self.read_stopped:
                    break
                with spans.span("loader.read"):
                    chunk = self._read_raw_chunk(min(self.PREPROC_CHUNK,
                                                     raw_left))
                if not chunk:
                    break
                raw_left -= len(chunk)
            if n_in_block:
                # the tail block from its slot: the upload has completed
                # before the block goes on, and the pool is refilled only
                # by a later lease, after release()
                self._put_block(block[:n_in_block])
        except BaseException as exc:  # surface decode-thread failures
            self._thread_exc = exc
        finally:
            if not handed_off:
                loop.__exit__(None, None, None)
                self.read_stopped = True
                self._put_eos()

    def _blockloop(self):
        from concurrent.futures import ThreadPoolExecutor
        spans = self.spans
        loop = spans.span("loader.loop")
        loop.__enter__()
        # paused while a full block is queued (``_put_block``'s own span)
        merge = spans.span("loader.merge")
        e = self.exp_frame
        w, h = self.runtime_size
        n_raw_total = (self.iterations // e) * e
        # Pre-allocated, PRE-FAULTED pool of block buffers, reused
        # round-robin (leased across calls, pinned where the loader uploads
        # to a card). A fresh 33MB block per 64 frames means a fresh mmap
        # and first-touch faults for every block, which under THP
        # compaction measured 0.7-6 s per np.empty while earlier blocks
        # streamed to the device. A buffer re-enters use only after
        # pool_size-1 newer blocks were queued/dispatched/collected, by
        # which point its device transfer has long completed. Color
        # loaders (grayscale=False, e.g. MLDetector) carry 3 channels.
        block_shape = (self.block_frames, h, w) if self.grayscale \
            else (self.block_frames, h, w, 3)
        pool_size = self.block_queue.maxsize + PIPELINE_DEPTH + 2
        block_pool = self._lease(block_shape, pool_size)
        self.stage_stats["placement"] = "host"
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
        # frame instead of a thread pool's scheduling churn)
        direct = not self.keep_color_stacks and not self.debayer
        if direct and e > 1:
            merge_scratch = np.zeros(block_shape[1:], np.uint8)
        resize_scratch = None
        pool = None if direct else ThreadPoolExecutor(max_workers=4)
        try:
            raw_left = n_raw_total
            while raw_left > 0 and not self.read_stopped:
                with spans.span("loader.read"):
                    chunk = self._read_raw_chunk(min(self.PREPROC_CHUNK,
                                                     raw_left))
                if not chunk:
                    break
                raw_left -= len(chunk)
                if direct:
                    merge.__enter__()
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
                                merge.__exit__(None, None, None)
                                self._put_block(block)
                                pool_idx = (pool_idx + 1) % pool_size
                                block = block_pool[pool_idx]
                                n_in_block = 0
                                merge.__enter__()
                        merge.__exit__(None, None, None)
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
                            merge.__exit__(None, None, None)
                            self._put_block(block)
                            pool_idx = (pool_idx + 1) % pool_size
                            block = block_pool[pool_idx]
                            n_in_block = 0
                            merge.__enter__()
                    merge.__exit__(None, None, None)
                    continue
                # pooled path (color recheck stacks / debayer)
                with spans.span("loader.preproc"):
                    if self.keep_color_stacks:
                        results = list(pool.map(
                            lambda r: self.preprocess(r, keep_color=True),
                            chunk))
                        pending_gray.extend(g for g, _ in results)
                        pending_color.extend(c for _, c in results)
                    else:
                        pending_gray.extend(pool.map(self.preprocess, chunk))
                merge.__enter__()
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
                        with spans.span("loader.color_stack"):
                            # a copy: an in-memory source hands out views
                            # of the caller's frames, which the in-place
                            # maxima below must not write to
                            color = np.array(cgroup[0])
                            for f in cgroup[1:]:
                                _u8_max_inplace(color, f)
                            if color_acc is None:
                                color_acc = color
                            else:
                                _u8_max_inplace(color_acc, color)
                            if (merged_idx + 1) % RECHECK_CHUNK == 0:
                                self.color_stacks[
                                    merged_idx // RECHECK_CHUNK] = color_acc
                                color_acc = None
                        spans.count("loader.color_stack_bytes",
                                    e * color.nbytes)
                    merged_idx += 1
                    if n_in_block == self.block_frames:
                        merge.__exit__(None, None, None)
                        self._put_block(block)
                        pool_idx = (pool_idx + 1) % pool_size
                        block = block_pool[pool_idx]
                        n_in_block = 0
                        merge.__enter__()
                merge.__exit__(None, None, None)
            if n_in_block:
                # the tail block: in device-put mode from its slot (the
                # upload has completed before the block goes on, and the
                # pool is refilled only by a later lease, after release());
                # in host mode a copy, since pop_block hands out the block
                # itself and a later lease overwrites the pool
                if self.device_put_mode:
                    tail = block[:n_in_block]
                else:
                    with merge:
                        tail = block[:n_in_block].copy()
                self._put_block(tail)
            if self.keep_color_stacks and color_acc is not None:
                self.color_stacks[merged_idx // RECHECK_CHUNK] = color_acc
        except BaseException as exc:  # surface decode-thread failures
            self._thread_exc = exc
        finally:
            loop.__exit__(None, None, None)
            if pool is not None:
                pool.shutdown(wait=False)
            self.read_stopped = True
            self._put_eos()

    def _put_block(self, block: np.ndarray, free=None) -> None:
        """Queue a completed block with indefinite backpressure: the
        consumer can legitimately stall (a first kernel build takes
        seconds), so a bounded put timeout must retry, not kill the decode
        thread. Stops promptly when the loader is stopped.

        In device-put mode the block goes to the uploader thread, which
        calls ``free`` (a staging ring's slot) once the copy out of it has
        completed. The span ``loader.qput`` times the wait."""
        q, item = ((self._upload_queue, (block, free))
                   if self.device_put_mode else (self.block_queue, block))
        with self.spans.span("loader.qput", wait=True):
            while True:
                try:
                    q.put(item, timeout=PUT_TIMEOUT)
                    return
                except queue.Full:
                    if self.read_stopped:
                        raise

    def _stage_block(self, block: np.ndarray) -> tuple:
        """Upload one block (and run the device preprocess, if any); returns
        ``(tensor, n_real)`` once the copy has completed, so the host
        buffer may be reused at once.

        On a card the copy runs on the loader's own stream, from the pinned
        pool without waiting for the host; a short tail block is padded to
        the fixed block shape on the device by repeating its last frame.
        The result is marked as used on the consumer's (default) stream, so
        its memory is not reused while the consumer's work reads it. On the
        CPU the block is copied into a fresh tensor.

        Spans: ``loader.h2d`` around it all (MDRF ``loader_h2d_s``), with
        ``loader.upload`` (the copy, the tail's pad and the device
        preprocess, enqueued; done on the CPU) and, on a card,
        ``loader.upload_event`` (waiting for their event) inside."""
        import torch
        n_real = block.shape[0]
        dev = torch.device(self.device)
        src = torch.from_numpy(block)
        shape = (self.block_frames,) + tuple(block.shape[1:])
        spans = self.spans
        with spans.span("loader.h2d"):
            if dev.type == "cuda":
                stream = self._upload_stream
                with spans.span("loader.upload"):
                    with torch.cuda.stream(stream):
                        out = torch.empty(shape, dtype=torch.uint8,
                                          device=dev)
                        out[:n_real].copy_(src, non_blocking=True)
                        if n_real < self.block_frames:
                            out[n_real:] = out[n_real - 1:n_real]
                        if self._dev_preproc_fn is not None:
                            out = self._dev_preproc_fn(out)
                        done = torch.cuda.Event()
                        done.record(stream)
                    out.record_stream(torch.cuda.default_stream(dev))
                with spans.span("loader.upload_event", wait=True):
                    done.synchronize()
            else:
                with spans.span("loader.upload"):
                    out = torch.empty(shape, dtype=torch.uint8)
                    out[:n_real] = src
                    if n_real < self.block_frames:
                        out[n_real:] = out[n_real - 1:n_real]
                    if self._dev_preproc_fn is not None:
                        out = self._dev_preproc_fn(out)
        self.spans.count("loader.h2d_bytes", block.nbytes)
        return (out, n_real)

    def _uploadloop(self, upload_queue, block_queue, stop_evt):
        """Uploader thread: stage blocks from the decode thread onto the
        device and forward them in FIFO order. The decode loops always
        deliver an EOS sentinel (None) through the upload queue, which this
        loop turns into the block queue's EOS, so the sentinel can never
        overtake an upload in flight.

        Queues and the stop event are arguments bound at thread creation: a
        retired uploader that outlives its bounded join keeps talking to its
        own run's queues and can never steal blocks from, reorder, or
        inject a stray EOS into a successor run."""
        spans = self.spans
        try:
            while True:
                try:
                    with spans.span("loader.upload_get", wait=True):
                        item = upload_queue.get(timeout=PUT_TIMEOUT)
                except queue.Empty:
                    if stop_evt.is_set():
                        return
                    continue  # the decode loop always delivers the sentinel
                if item is None:
                    return
                block, free = item
                staged = self._stage_block(block)
                if free is not None:  # the copy out of the slot is done
                    free()
                with spans.span("loader.upload_put", wait=True):
                    while True:
                        try:
                            block_queue.put(staged, timeout=PUT_TIMEOUT)
                            break
                        except queue.Full:
                            if stop_evt.is_set():
                                return
        except BaseException as exc:  # surface upload failures to pop_block
            if not stop_evt.is_set():
                self._thread_exc = exc
        finally:
            # a retired thread must not signal EOS: its successor owns the
            # stream now
            for _ in range(120):
                if stop_evt.is_set():
                    break
                try:
                    block_queue.put(None, timeout=PUT_TIMEOUT)
                    break
                except queue.Full:
                    pass

    def _put_eos(self):
        """Deliver the end-of-stream sentinel. It must not be dropped:
        with a fast producer the queue is routinely full here, and a lost
        None makes the consumer eat the full pop timeout at end of stream.
        In device-put mode it goes through the upload queue, so it stays
        behind the uploads in flight."""
        q = self._upload_queue if self.device_put_mode else self.block_queue
        for _ in range(120):
            try:
                q.put(None, timeout=PUT_TIMEOUT)
                return
            except queue.Full:
                continue

    def pop_block(self):
        """Return the next [T, H, W(, 3)] uint8 block of merged frames --
        or, in device-put mode, a (device tensor of block_frames frames,
        n_real) pair -- or None at end of stream. Re-raises any
        decode-thread or upload failure instead of silently ending the
        stream."""
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
        assert not self.device_put_mode, (
            "pop() serves host frames; disable device_put mode")
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
        if self._upload_stop is not None:
            self._upload_stop.set()

    def release(self):
        super().release()
        self.clear_queue()
        # the uploader may still hold references to pooled slots; wait for
        # it before handing the pool buffers back to the lease cache
        up = self._upload_thread
        if up is not None and up.is_alive():
            if self._upload_stop is not None:
                self._upload_stop.set()
            self._stop_requested = True
            up.join(timeout=PUT_TIMEOUT)
        leased = getattr(self, "_leased_pool", None)
        if leased is not None:
            self._leased_pool = None
            if up is not None and up.is_alive():
                # a stalled uploader may still read these slots: abandon
                # the lease instead of recycling aliased buffers
                return
            _return_block_pool(*leased)

    @property
    def stopped(self) -> bool:
        return self.read_stopped and self.block_queue.empty()


def _process_decode_worker(wrapper_cls, video_name, hwaccel, start_frame,
                           n_raw_total, exp_frame, preprocess, block_frames,
                           block_shape, shm_name, n_slots, free_q, ready_q,
                           stop_evt, continue_on_err, keep_color,
                           recheck_chunk):
    """Decode/preprocess/merge loop running in a separate process, writing
    completed blocks into a shared-memory ring (the block analog of the
    reference's RawArray frame ring, MetLib/videoloader.py:634-793).

    Protocol: the parent pre-fills ``free_q`` with slot ids; the worker
    blocks on a free slot, fills it, and posts ("block", slot, n_frames) on
    ``ready_q``. Colour recheck stacks travel as ("stack", idx, array)
    messages; EOS is ("eos", cuda_initialized); failures are ("error",
    repr).

    The worker is host code: it decodes with cv2 and numpy, never touches
    the card and creates no CUDA state (the parent uploads). Its EOS says
    whether CUDA was initialised in it, and the parent refuses a stream
    whose worker did.
    """
    import numpy as _np
    from multiprocessing import shared_memory as _shm
    shm = None
    wrapper = None
    try:
        shm = _shm.SharedMemory(name=shm_name)
        ring = _np.ndarray((n_slots,) + block_shape, _np.uint8,
                           buffer=shm.buf)
        wrapper = wrapper_cls(video_name, hwaccel=hwaccel)
        wrapper.set_to(start_frame)
        slot = free_q.get()
        n_in_block = 0
        merged_idx = 0
        color_acc = None
        group: list = []
        cgroup: list = []
        n_in_group = 0
        scratch3 = None
        merge_scratch = None
        raw_left = n_raw_total
        while raw_left > 0 and not stop_evt.is_set():
            ok, raw = wrapper.read()
            if not ok or raw is None:
                if continue_on_err:
                    raw_left -= 1
                    continue
                break
            raw_left -= 1
            if keep_color:
                g, c = preprocess(raw, keep_color=True)
                group.append(g)
                cgroup.append(c)
                if len(group) < exp_frame:
                    continue
                merged = _np.array(group[0])
                for f in group[1:]:
                    _np.maximum(merged, f, out=merged)
                group = []
                ring[slot, n_in_block] = merged
                color = _np.array(cgroup[0])
                for f in cgroup[1:]:
                    _np.maximum(color, f, out=color)
                cgroup = []
                color_acc = (color if color_acc is None
                             else _np.maximum(color_acc, color))
                if (merged_idx + 1) % recheck_chunk == 0:
                    ready_q.put(("stack", merged_idx // recheck_chunk,
                                 color_acc))
                    color_acc = None
            else:
                # allocation-free hot path: preprocess straight into the
                # shared-memory ring slot (cv2 dst= kernels; mirrors the
                # in-process loader's into() path)
                dst = ring[slot, n_in_block]
                if (scratch3 is None and raw.ndim == 3
                        and preprocess.resize and preprocess.grayscale):
                    scratch3 = _np.empty(
                        (preprocess.dsize[1], preprocess.dsize[0], 3),
                        _np.uint8)
                if n_in_group == 0:
                    preprocess.into(raw, dst, scratch3)
                else:
                    if merge_scratch is None:
                        merge_scratch = _np.empty_like(dst)
                    preprocess.into(raw, merge_scratch, scratch3)
                    _np.maximum(dst, merge_scratch, out=dst)
                n_in_group += 1
                if n_in_group < exp_frame:
                    continue
                n_in_group = 0
            n_in_block += 1
            merged_idx += 1
            if n_in_block == block_frames:
                ready_q.put(("block", slot, n_in_block))
                n_in_block = 0
                slot = free_q.get()
        if n_in_block and not stop_evt.is_set():
            ready_q.put(("block", slot, n_in_block))
        if keep_color and color_acc is not None:
            ready_q.put(("stack", merged_idx // recheck_chunk, color_acc))
        import sys as _sys
        torch_mod = _sys.modules.get("torch")
        ready_q.put(("eos", bool(torch_mod is not None
                                 and torch_mod.cuda.is_initialized())))
    except Exception as exc:  # surface child failures to the parent
        try:
            ready_q.put(("error", repr(exc)))
        except Exception:
            pass
    finally:
        if wrapper is not None:
            try:
                wrapper.release()
            except Exception:
                pass
        if shm is not None:
            shm.close()


class ProcessVideoLoader(BlockVideoLoader):
    """Subprocess decode with a shared-memory block ring.

    The GIL-escaping analog of the reference's ProcessVideoLoader
    (MetLib/videoloader.py:634-793): decode + preprocess + exposure merge
    run in a child process started with the ``spawn`` method (this process
    may hold CUDA state and threads, which a forked child must not
    inherit); completed [block_frames, H, W(,3)] blocks are exchanged
    through POSIX shared memory with a slot free-list, so the only
    per-block parent cost is one copy out of the ring. The child never
    touches the card; blocks are host arrays and the consumer uploads them
    (device-put mode stays off).
    """

    def _maybe_scaled_decode(self) -> list[int]:
        # the child process re-creates the wrapper from its class, so an
        # in-place wrapper swap here would not apply there
        return list(self.raw_size)

    def __init__(self, *args: Any, ring_slots: int = 4, **kwargs: Any
                 ) -> None:
        self.ring_slots = ring_slots
        self._proc = None
        self._shm = None
        super().__init__(*args, **kwargs)
        self.device_put_mode = False
        self.worker_cuda_initialized: Optional[bool] = None

    def start(self):
        import multiprocessing as mp
        from multiprocessing import shared_memory

        self.color_stacks.clear()
        self._pending = []
        self._thread_exc = None
        self.read_stopped = False
        self._eos = False
        self.worker_cuda_initialized = None

        e = self.exp_frame
        w, h = self.runtime_size
        block_shape = ((self.block_frames, h, w) if self.grayscale
                       else (self.block_frames, h, w, 3))
        nbytes = int(np.prod((self.ring_slots,) + block_shape))
        ctx = mp.get_context("spawn")
        self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self._ring = np.ndarray((self.ring_slots,) + block_shape, np.uint8,
                                buffer=self._shm.buf)
        self._free_q = ctx.Queue()
        self._ready_q = ctx.Queue()
        self._stop_evt = ctx.Event()
        for s in range(self.ring_slots):
            self._free_q.put(s)
        n_raw_total = (self.iterations // e) * e
        self._proc = ctx.Process(
            target=_process_decode_worker,
            args=(self.video_wrapper, self.video_name, self.hwaccel,
                  self.start_frame, n_raw_total, e, self.preprocess,
                  self.block_frames, block_shape, self._shm.name,
                  self.ring_slots, self._free_q, self._ready_q,
                  self._stop_evt, self.continue_on_err,
                  self.keep_color_stacks, RECHECK_CHUNK),
            daemon=True)
        self._proc.start()

    def pop_block(self) -> Optional[np.ndarray]:
        if getattr(self, "_eos", False):
            return None
        while True:
            try:
                msg = self._ready_q.get(timeout=GET_TIMEOUT * 6)
            except queue.Empty:
                # queue silence is EOS or failure only if the worker died
                # without posting a sentinel; a live worker may stall
                if self._proc is not None and self._proc.is_alive():
                    continue
                self.read_stopped = True
                if self._proc is not None:
                    raise RuntimeError(
                        "video decode process exited without EOS "
                        f"(exitcode={self._proc.exitcode})")
                return None
            kind = msg[0]
            if kind == "block":
                _, slot, n = msg
                out = self._ring[slot, :n].copy()
                self._free_q.put(slot)
                return out
            if kind == "stack":
                self.color_stacks[msg[1]] = msg[2]
                continue
            if kind == "eos":
                self._eos = True
                self.read_stopped = True
                self.worker_cuda_initialized = msg[1]
                if msg[1]:
                    raise RuntimeError("the video decode process "
                                       "initialised CUDA")
                return None
            if kind == "error":
                self._eos = True
                self.read_stopped = True
                raise RuntimeError(f"video decode process failed: {msg[1]}")

    def stop(self):
        self.read_stopped = True
        if getattr(self, "_stop_evt", None) is not None:
            self._stop_evt.set()

    def release(self):
        self.stop()
        proc, self._proc = self._proc, None
        if proc is not None:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        shm, self._shm = self._shm, None
        if shm is not None:
            self._ring = None
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        self.video.release()

    @property
    def stopped(self) -> bool:
        return self.read_stopped

    def clear_queue(self):
        pass


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
