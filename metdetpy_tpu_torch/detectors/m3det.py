"""The M3 (max-minus-mean) line detector as a batched PyTorch block step.

Counterpart of ``metdetpy_tpu/detectors/m3det.py`` (reference
MetLib/Detector.py:160-448). Per block of T merged frames, one block step
runs on the device with no host sync:

  window diff (CUDA kernel) + sub-ROI noise std
  -> noise-EMA + adaptive threshold over the block
  -> median3 -> binarize -> close (CUDA kernel) -> dynamic mask
  -> batched Hough (vote and walk-pick CUDA kernels)
  -> everything the host needs packed into ONE f32 buffer.

The EMA's update schedule, update count, warmup flag and momentum depend
only on the frame timer, never on the frames, so they are kept and
computed on the host (in f32, with the fused multiply-adds XLA's CPU
backend forms); only the EMA value and the thresholds live on the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from ..log import BaseMetLog
from ..ops import filters, kernels, windows
from ..ops.f32 import fma_f32
from ..ops.hough import hough_lines_batch
from ..structs import BinaryCfg
from ..utils import lineset_nms
from .base import BaseDetector, FrameResult

NUM_LINES_TOOMUCH = 500
MAX_ALLOW_GAP = 0.05  # diff-area % at which the adaptive hough gap closes
N_EXTRAS = 6          # packed per-frame scalars (see _pack)
COLLECT_GROUP = 8     # packed block buffers read back per device->host copy

# sensitivity polynomial thr = a*sigma^2 + b
# (reference MetLib/Detector.py:177-183)
SENSITIVITY_COEF = {"low": (2.0, 4.4), "normal": (1.2, 3.6),
                    "high": (0.9, 3.0)}
ABS_SENSITIVITY = {"high": 3, "normal": 5, "low": 7}

_F32 = np.float32


def _fma_host(a, b, c) -> np.float32:
    """round_f32(a * b + c) of f32 host scalars (see ops.f32.fma_f32)."""
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def select_subarea(mask: np.ndarray, area: float):
    """Pick a mostly-unmasked centered sub-ROI for noise estimation
    (reference SNR_SW.select_subarea, MetLib/Detector.py:93-122): start at
    the center, walk the top edge up in steps of 10 while the unmasked
    ratio improves. Returns (row1, col1, row2, col2)."""
    h, w = mask.shape[:2]
    if area == 0:
        return (h // 2, w // 2, 0, 0)
    sub_rate = area ** 0.5
    sub_h, sub_w = int(h * sub_rate), int(w * sub_rate)
    x1, y1 = (h - sub_h) // 2, (w - sub_w) // 2
    pix = sub_h * sub_w
    light_ratio = np.sum(mask[x1:x1 + sub_h, y1:y1 + sub_w]) / pix
    while light_ratio < 1:
        x1 -= 10
        new_ratio = np.sum(mask[x1:x1 + sub_h, y1:y1 + sub_w]) / pix
        if new_ratio < light_ratio or x1 < 0:
            x1 += 10
            break
        light_ratio = new_ratio
    return (x1, y1, x1 + sub_h, y1 + sub_w)


@dataclasses.dataclass
class EmaState:
    """Noise-EMA state (reference EMA with quadratic warmup,
    MetLib/utils.py:324-368). The value and thresholds are f32 device
    tensors, 0-dim for one stream or [S] for S streams that share a frame
    timer; the data-independent schedule state is on the host."""
    cur_value: torch.Tensor     # f32
    t: int                      # update count
    warmup_on: bool
    cur_momentum: np.float32
    bi_threshold: torch.Tensor  # f32 current integer threshold
    bi_thr_float: torch.Tensor  # f32 unrounded threshold (for visu)

    @staticmethod
    def init(momentum: float, init_threshold: float, device: torch.device,
             shape: tuple = ()) -> "EmaState":
        def scalar(v):
            return torch.full(shape, v, dtype=torch.float32, device=device)
        return EmaState(scalar(0.0), 0, True, _F32(momentum),
                        scalar(init_threshold), scalar(init_threshold))


def _ema_threshold_scan(stds: torch.Tensor, timer0: int, state: EmaState,
                        *, n: int, std_interval: int, momentum: float,
                        warmup_speed: float, adaptive: bool, coef_a: float,
                        coef_b: float):
    """Per-frame noise EMA + adaptive threshold over a block: stds [T], or
    [S, T] for S streams with ``state`` of shape [S] (one host schedule).

    Update schedule of SNR_SW.update (MetLib/Detector.py:81-91): every
    frame while 1 < timer <= n, then every std_interval frames. Threshold
    of LineDetector.update (:225-229) with round-half-to-even.

    f32 arithmetic follows the JAX package's scan as XLA's CPU backend
    compiles it: ``1 - (1-k)^2`` and ``m*v + (1-m)*s`` and ``a*v^2 + b``
    are each one fused multiply-add. Returns (thr u8, thr_f f32, ema_vals
    f32, each of the shape of ``stds``, and the new state).
    """
    t_block = stds.shape[-1]
    m_f = _F32(momentum)
    one_minus_m = _F32(1 - momentum)
    speed = _F32(warmup_speed)
    val = state.cur_value
    t_cnt, warm_on, cur_m = state.t, state.warmup_on, state.cur_momentum
    vals = []
    for i in range(t_block):
        timer = timer0 + 1 + i
        if (timer > n and timer % std_interval == 0) or 1 < timer <= n:
            k = _F32(t_cnt) * one_minus_m * speed
            omk = _F32(1) - k
            warm_m = m_f * _fma_host(-omk, omk, 1.0)
            cur_m = warm_m if (warm_on and k < 1) else m_f
            warm_on = bool(warm_on and k < 1)
            val = fma_f32(val, float(cur_m),
                          stds[..., i] * float(_F32(1) - cur_m))
            t_cnt += 1
        vals.append(val)
    ema_vals = torch.stack(vals, dim=-1)
    if adaptive:
        steps = torch.arange(t_block, device=stds.device)
        thr_f_new = fma_f32(ema_vals * ema_vals, float(_F32(coef_a)),
                            float(_F32(coef_b)))
        use = ema_vals != 0
        # carry forward the last step whose EMA value was nonzero
        last = torch.cummax(torch.where(use, steps, -1), dim=-1).values
        src = last.clamp(min=0)
        thr_f = torch.where(last >= 0, thr_f_new.gather(-1, src),
                            state.bi_thr_float[..., None])
        thr = torch.where(last >= 0, torch.round(thr_f_new).gather(-1, src),
                          state.bi_threshold[..., None])
    else:
        thr_f = state.bi_thr_float[..., None].expand(stds.shape)
        thr = state.bi_threshold[..., None].expand(stds.shape)
    new_state = EmaState(ema_vals[..., -1], t_cnt, warm_on, cur_m,
                         thr[..., -1], thr_f[..., -1])
    # f32 -> u8 saturates, as XLA's conversion does
    return thr.clamp(0, 255).to(torch.uint8), thr_f, ema_vals, new_state


def _dst_sum_scales(mask_area: int,
                    sharded_fold: bool = False) -> tuple[float, float]:
    """f32 factors of the diff area ``sum / 255.0 / mask_area * 100.0`` (%
    of the mask) and of ``dst_sum / MAX_ALLOW_GAP``, as XLA folds them:
    the f32 reciprocals of 255 and of the area multiplied with 100 in
    float64 and rounded once; that divided by f32(MAX_ALLOW_GAP) in float64
    and rounded once. The gap's ``1 - sum * scale`` is then contracted to a
    fused multiply-add (both matched against jnp for several areas).

    ``sharded_fold``: the area factor as the JAX package's sharded
    programs fold it (the step under ``shard_map`` and ``jax.vmap``:
    ``parallel/multistream.py``, ``parallel/temporal.py``), rounded to f32
    after each of the two products, matched against their packed buffers;
    their gap factor is the single-stream one. The two folds differ in the
    last two bits of some diff areas, nowhere else."""
    f64 = np.float64
    inv_area = _F32(1 / mask_area) if mask_area else _F32(np.inf)
    area = _F32(f64(_F32(1 / 255)) * f64(inv_area) * 100.0)
    gap = _F32(f64(area) / f64(_F32(MAX_ALLOW_GAP)))
    if sharded_fold:
        area = _F32(_F32(_F32(1 / 255) * inv_area) * _F32(100))
    return float(area), float(gap)


def _m3_block_step(gray_hist, sub_hist, dy_hist, ema_state, frames, timer0,
                   *, n, roi, dy_mask, mask_area, std_interval, momentum,
                   warmup_speed, adaptive, coef_a, coef_b, hough_threshold,
                   min_len, max_gap, max_points, max_peaks,
                   sharded_fold=False):
    """The M3 step over one [T, H, W] u8 device block, or over S streams'
    blocks at once ([S, T, H, W], carries with a leading [S], one timer):
    each stream's results equal its own single-stream step's (the diff
    area to the fold ``sharded_fold`` selects, see ``_dst_sum_scales``).
    Returns the packed host buffer ([(S,) T, K*5 + N_EXTRAS]), the dst
    block (for visu) and the new carries."""
    r1, c1, r2, c2 = roi
    diff, new_gray = kernels.window_diff(gray_hist, frames, n, timer0)
    stds, new_sub = windows.window_noise_std(
        sub_hist, frames[..., r1:r2, c1:c2], n, timer0)
    thr, thr_f, ema_vals, new_ema = _ema_threshold_scan(
        stds, timer0, ema_state, n=n, std_interval=std_interval,
        momentum=momentum, warmup_speed=warmup_speed, adaptive=adaptive,
        coef_a=coef_a, coef_b=coef_b)
    closed = median_binarize_close_blocks(diff, thr)
    packed, dst, new_dy = _m3_lines(
        closed, dy_hist, timer0, 0, ema_vals, thr_f, thr, n=n,
        dy_mask=dy_mask, mask_area=mask_area,
        hough_threshold=hough_threshold, min_len=min_len, max_gap=max_gap,
        max_points=max_points, max_peaks=max_peaks,
        sharded_fold=sharded_fold)
    return packed, dst, new_gray, new_sub, new_dy, new_ema


def median_binarize_close_blocks(diff: torch.Tensor,
                                 thr: torch.Tensor) -> torch.Tensor:
    """``kernels.median_binarize_close`` over [..., T, H, W] with thr
    [..., T]: the frames of every stream in one launch."""
    h, w = diff.shape[-2:]
    return kernels.median_binarize_close(
        diff.reshape(-1, h, w), thr.reshape(-1)).reshape(diff.shape)


def _m3_lines(closed, dy_hist, timer0, timer_step, ema_vals, thr_f, thr, *,
              n, dy_mask, mask_area, hough_threshold, min_len, max_gap,
              max_points, max_peaks, sharded_fold=False):
    """The step after binarization, over [(S,) T, H, W] u8: dynamic mask,
    diff area, batched Hough of all frames together, the packed buffer.
    Stream s starts at frame timer0 + s * timer_step. Returns (packed,
    dst, new dy history)."""
    new_dy = dy_hist
    dst = closed
    if dy_mask:
        dy_sum, new_dy = windows.rolling_sum_u32(dy_hist, closed, n)
        lens = windows.window_lengths(
            timer0, closed.shape[-3], n, closed.device,
            closed.shape[0] if closed.dim() == 4 else 0, timer_step)
        # pixels active in >= length-1 window slots are hot (stars/towers):
        # erode the pass-mask and zero them (reference
        # MetLib/Detector.py:234-242)
        passmask = (dy_sum <= ((lens - 1) * 255)[..., None, None]).to(
            torch.uint8)
        dst = closed * filters.erode3x3(passmask)
    area_scale, gap_scale = _dst_sum_scales(mask_area, sharded_fold)
    dst_px = dst.sum(dim=(-2, -1), dtype=torch.int64).to(torch.float32)
    dst_sum = dst_px * area_scale
    # max(0, 1 - dst_sum / MAX_ALLOW_GAP) * max_gap
    gap = torch.clamp(fma_f32(-dst_px, gap_scale, 1.0), min=0.0) * max_gap
    h, w = dst.shape[-2:]
    hough = hough_lines_batch(dst.reshape(-1, h, w), gap.reshape(-1),
                              threshold=hough_threshold, min_len=min_len,
                              max_points=max_points, max_peaks=max_peaks)
    packed = _pack(hough.lines, hough.valid, dst_sum.reshape(-1),
                   hough.npix, hough.overflow, ema_vals.reshape(-1),
                   thr_f.reshape(-1), thr.reshape(-1))
    return packed.reshape(*dst.shape[:-2], -1), dst, new_dy


def _pack(lines, valid, dst_sum, npix, overflow, ema_vals, thr_f, thr):
    """Pack all host-needed outputs into one [T, K*5 + N_EXTRAS] f32 buffer
    (a single device->host copy per block)."""
    t_block, k, _ = lines.shape
    f32 = torch.float32
    return torch.cat([
        lines.to(f32).reshape(t_block, k * 4),
        valid.to(f32),
        dst_sum[:, None].to(f32),
        npix[:, None].to(f32),
        overflow[:, None].to(f32),
        ema_vals[:, None],
        thr_f[:, None],
        thr[:, None].to(f32),
    ], dim=1)


def _unpack(buf: np.ndarray, k: int):
    t_block = buf.shape[0]
    lines = buf[:, :k * 4].reshape(t_block, k, 4).astype(np.int32)
    valid = buf[:, k * 4:k * 5] > 0.5
    extras = buf[:, k * 5:]
    return lines, valid, extras  # extras: dst_sum,npix,overflow,ema,thrf,thr


class LineDetector(BaseDetector):
    """Shared machinery: window stack, adaptive threshold, dynamic mask
    (reference LineDetector, MetLib/Detector.py:160-242)."""

    def __init__(self, window_sec: float, fps: float, mask: np.ndarray,
                 num_cls: int, cfg: BinaryCfg, logger: BaseMetLog,
                 max_points: Optional[int] = None, max_peaks: int = 64,
                 device: str = "cuda") -> None:
        if max_points is None:
            max_points = int(os.environ.get("METDETPY_TPU_MAX_POINTS", 8192))
        self.device = resolve_device(device)
        self.mask = mask
        self.num_cls = num_cls
        self.logger = logger
        self.mask_area = int(np.sum(mask))
        self.bi_cfg = cfg.binary
        self.hough_cfg = cfg.hough_line
        self.dynamic_cfg = cfg.dynamic
        self.max_points = max_points
        self.max_peaks = max_peaks

        self.n = max(int(window_sec * fps), 1)
        self.hw = mask.shape[:2]

        # noise estimation config (reference SNR_SW, Detector.py:34-127)
        self.std_roi = select_subarea(mask, self.bi_cfg.area)
        self.noise_momentum = 1 - self.bi_cfg.interval / 60
        self.std_interval = self.bi_cfg.interval * self.n
        self.adaptive = bool(self.bi_cfg.adaptive_bi_thre)
        if self.adaptive:
            self.coef_a, self.coef_b = SENSITIVITY_COEF[
                self.bi_cfg.sensitivity]
            init_thr = ABS_SENSITIVITY[self.bi_cfg.sensitivity]
        else:
            self.coef_a, self.coef_b = 0.0, 0.0
            init_thr = self.bi_cfg.init_value
        self.bi_threshold = init_thr
        self.bi_threshold_float = float(init_thr)
        self.snr = 0.0
        self._visu_state: dict = {}
        self._init_device_state()

    def reset_device_state(self) -> None:
        """Reinitialize the device carries (window / sub-ROI / dynamic-mask
        histories and EMA) and the frame timer. Used by the block loop's
        failure recovery: detection restarts its warmup while the host-side
        collector keeps its accumulated tracks."""
        self._init_device_state()

    def _init_device_state(self) -> None:
        h, w = self.hw
        r1, c1, r2, c2 = self.std_roi

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.uint8, device=self.device)
        self.timer = 0
        self._gray_hist = zeros(self.n - 1, h, w)
        self._sub_hist = zeros(self.n - 1, r2 - r1, c2 - c1)
        self._dy_hist = zeros(self.n - 1, h, w)
        self._ema = EmaState.init(self.noise_momentum,
                                  float(self.bi_threshold), self.device)
        self._pending: list[np.ndarray] = []
        self._last: Optional[FrameResult] = None

    # -- async block API -------------------------------------------------

    def process_block_async(self, block) -> Any:
        """Dispatch one block; returns an opaque handle for ``collect``.
        Device carries are updated immediately (launches are async)."""
        raise NotImplementedError

    def collect(self, handle: Any) -> list[FrameResult]:
        """Fetch a dispatched block's results (one device->host copy)."""
        return self._collect_from_buf(handle[0].cpu().numpy(), handle)

    def collect_many(self, handles: list) -> list[list[FrameResult]]:
        """Collect many dispatched blocks with one device->host copy per
        group of COLLECT_GROUP blocks: the packed buffers are stacked on
        the device and read back as one array."""
        bufs: list[np.ndarray] = []
        for a in range(0, len(handles), COLLECT_GROUP):
            arr = torch.stack([h[0] for h in handles[a:a + COLLECT_GROUP]])
            bufs.extend(arr.cpu().numpy())
        return [self._collect_from_buf(bufs[i], h)
                for i, h in enumerate(handles)]

    def handle_slim(self, handle: Any) -> Any:
        """Drop the visu plane (a full [T, H, W] dst block) from a
        dispatched handle; deferred collection keeps many handles alive
        and only needs the small packed result."""
        return (handle[0], None) + tuple(handle[2:])

    def _collect_from_buf(self, buf: np.ndarray,
                          handle: Any) -> list[FrameResult]:
        dst_dev = handle[1]
        lines, valid, extras = _unpack(buf, self.max_peaks)
        self.snr = float(extras[-1, 3])
        self.bi_threshold_float = float(extras[-1, 4])
        self.bi_threshold = int(extras[-1, 5])
        self._visu_state = {"dst": dst_dev, "dst_sum": float(extras[-1, 0]),
                            "lines_num": int(valid[-1].sum())}
        return self._post_lines(lines, valid, extras)

    def process_block(self, block) -> list[FrameResult]:
        return self.collect(self.process_block_async(block))

    def _post_lines(self, lines, valid, extras) -> list[FrameResult]:
        results: list[FrameResult] = []
        for t in range(lines.shape[0]):
            if extras[t, 2] > 0.5:  # overflow: too-many-response frame drop
                results.append((np.zeros((0, 4), int),
                                np.zeros((0, self.num_cls))))
                continue
            frame_lines = lines[t][valid[t]]
            if len(frame_lines) == 0 or len(frame_lines) > NUM_LINES_TOOMUCH:
                results.append((np.zeros((0, 4), int),
                                np.zeros((0, self.num_cls))))
                continue
            results.append(self._classify_lines(frame_lines))
        return results

    def _classify_lines(self, frame_lines: np.ndarray) -> FrameResult:
        raise NotImplementedError

    # -- per-frame compat API ---------------------------------------------

    def update(self, new_frame: np.ndarray) -> None:
        self._pending.append(np.asarray(new_frame, dtype=np.uint8))

    def detect(self) -> FrameResult:
        if self._pending:
            block = np.stack(self._pending)
            self._pending.clear()
            self._last = self.process_block(block)[-1]
        if self._last is None:
            return np.zeros((0, 4), int), np.zeros((0, self.num_cls))
        return self._last


class M3Detector(LineDetector):
    """Max-minus-mean detector over the sliding window (the default
    detector; reference M3Detector, MetLib/Detector.py:302-448)."""

    def _step_static_kwargs(self) -> dict:
        return dict(
            n=self.n, roi=self.std_roi,
            dy_mask=bool(self.dynamic_cfg.dy_mask),
            mask_area=self.mask_area, std_interval=self.std_interval,
            momentum=self.noise_momentum, warmup_speed=float(self.n),
            adaptive=self.adaptive, coef_a=self.coef_a, coef_b=self.coef_b,
            hough_threshold=int(self.hough_cfg.threshold),
            min_len=int(self.hough_cfg.min_len),
            max_gap=float(self.hough_cfg.max_gap),
            max_points=self.max_points, max_peaks=self.max_peaks)

    def process_block_async(self, block) -> Any:
        """``block``: [T, H, W] uint8, a numpy array (uploaded here; the
        copy completes before this returns, so the caller may reuse it) or
        a tensor already on the detector's device, which the caller must
        not write to afterwards (the detector may keep its last frames as a
        view for the next block's window)."""
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(block).to(self.device)
        (packed, dst, self._gray_hist, self._sub_hist, self._dy_hist,
         self._ema) = _m3_block_step(
            self._gray_hist, self._sub_hist, self._dy_hist, self._ema,
            block.contiguous(), self.timer, **self._step_static_kwargs())
        self.timer += block.shape[0]
        return packed, dst

    def _classify_lines(self, frame_lines: np.ndarray) -> FrameResult:
        nms_lines, nonline_probs = lineset_nms(frame_lines)
        cls_pred = np.zeros((len(nms_lines), self.num_cls))
        cls_pred[:, -1] = nonline_probs    # OTHERS (area-like) prob
        cls_pred[:, 0] = 1 - nonline_probs  # METEOR (line-like) prob
        return nms_lines, cls_pred

    def visu(self):
        from ..visu import ImgVisuAttrs, TextColorPair, TextVisu
        state = self._visu_state
        out = []
        if state.get("dst") is not None:
            out.append(ImgVisuAttrs(
                "mix_bg", img=state["dst"][-1].cpu().numpy() // 255,
                weight=0.5, color="yellow"))
        out.extend([
            TextVisu("std_value", position="left-top", color="green",
                     text_list=[TextColorPair(text=f"STD:{self.snr:.4f}")]),
            TextVisu("bi_value", position="left-top", color="green",
                     text_list=[TextColorPair(
                         text=f"Bi_Threshold: {self.bi_threshold} (rounded "
                              f"from {self.bi_threshold_float:.4f})")]),
            TextVisu("lines_num", position="left-top", color="green",
                     text_list=[TextColorPair(
                         text=f"Line num: {state.get('lines_num', 0)}")]),
            TextVisu("area_ratio", position="left-top", color="green",
                     text_list=[TextColorPair(
                         text=f"Diff Area: {state.get('dst_sum', 0):.2f}%")]),
        ])
        return out


def _classic_block_step(gray_hist, sub_hist, classic_hist, ema_state, frames,
                        timer0, *, n, roi, std_interval, momentum,
                        warmup_speed, adaptive, coef_a, coef_b,
                        hough_threshold, min_len, max_gap, max_points,
                        max_peaks):
    """Batched uzanka 4-frame algorithm (reference ClassicDetector,
    MetLib/Detector.py:245-296): |f2-f3| -> binarize -> dilate -> invert ->
    AND with f0/f1 -> |.| -> binarize -> dilate -> Hough."""
    r1, c1, r2, c2 = roi
    t_block = frames.shape[0]
    # the gray window's stats are unused by the 4-frame algorithm; only
    # the history carry advances
    new_gray = (torch.cat([gray_hist, frames], dim=0)[t_block:].clone()
                if n > 1 else gray_hist)
    stds, new_sub = windows.window_noise_std(
        sub_hist, frames[:, r1:r2, c1:c2], n, timer0)
    thr, thr_f, ema_vals, new_ema = _ema_threshold_scan(
        stds, timer0, ema_state, n=n, std_interval=std_interval,
        momentum=momentum, warmup_speed=warmup_speed, adaptive=adaptive,
        coef_a=coef_a, coef_b=coef_b)

    seq = torch.cat([classic_hist, frames], dim=0)  # [3+T, H, W]
    # reference index mapping (MetLib/Detector.py:258-276): id3 = newest,
    # id0 = oldest; the NEWEST pair's diff builds the suppression mask and
    # detection runs on the masked OLDEST pair
    newest = seq[3:3 + t_block]
    newer = seq[2:2 + t_block]
    older = seq[1:1 + t_block]
    oldest = seq[0:t_block]
    thr_b = thr[:, None, None]

    def absdiff(a, b):
        return torch.where(a > b, a - b, b - a)
    diff23 = filters.binary_threshold(absdiff(newer, newest), thr_b)
    diff23 = 255 - filters.dilate3x3(diff23)
    dst = absdiff(diff23 & oldest, diff23 & older)
    dst = filters.dilate3x3(filters.binary_threshold(dst, thr_b))
    gap = torch.full((t_block,), max_gap, dtype=torch.float32,
                     device=frames.device)
    hough = hough_lines_batch(dst, gap, threshold=hough_threshold,
                              min_len=min_len, max_points=max_points,
                              max_peaks=max_peaks)
    # sum / 255.0 as XLA compiles it: the integer sum rounded to f32 (it
    # passes 2^24 on large frames) times the f32 reciprocal of 255
    dst_sum = dst.sum(dim=(1, 2), dtype=torch.int64).to(
        torch.float32) * float(_F32(1) / _F32(255))
    packed = _pack(hough.lines, hough.valid, dst_sum, hough.npix,
                   hough.overflow, ema_vals, thr_f, thr)
    return packed, dst, new_gray, new_sub, seq[t_block:].clone(), new_ema


class ClassicDetector(LineDetector):
    """4-frame differencing detector; all detections labeled METEOR
    (reference ClassicDetector, MetLib/Detector.py:245-299)."""

    CLASSIC_WINDOW = 4

    def __init__(self, window_sec: float, fps: float, mask: np.ndarray,
                 num_cls: int, cfg: BinaryCfg, logger: BaseMetLog,
                 **kw) -> None:
        # window is hardcoded to 4 frames regardless of window_sec
        # (reference MetLib/Detector.py:249-255)
        # The 4-frame dst has no median blur or dynamic mask quieting it,
        # so noisy video binarizes+dilates to tens of thousands of points
        # per frame; the M3 point budget would overflow-drop frames the
        # reference keeps (it only drops at >500 LINES,
        # MetLib/Detector.py:358-360). Derive the default budget from the
        # frame AREA instead: 1/8 of the pixels (a dilated ~1% noise
        # floor) with the M3 default as floor and 64k as cap. An explicit
        # METDETPY_TPU_MAX_POINTS or caller kwarg wins verbatim.
        if kw.get("max_points") is None:
            env = os.environ.get("METDETPY_TPU_MAX_POINTS")
            if env is not None:
                kw["max_points"] = int(env)
            else:
                area = int(np.prod(mask.shape[:2]))
                kw["max_points"] = min(max(8192, area // 8), 1 << 16)
        super().__init__(self.CLASSIC_WINDOW / fps, fps, mask, num_cls, cfg,
                         logger, **kw)

    def _init_device_state(self) -> None:
        super()._init_device_state()
        self._classic_hist = torch.zeros((3,) + tuple(self.hw),
                                         dtype=torch.uint8,
                                         device=self.device)

    def process_block_async(self, block) -> Any:
        """``block``: [T, H, W] uint8, as M3Detector.process_block_async."""
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(block).to(self.device)
        (packed, dst, self._gray_hist, self._sub_hist, self._classic_hist,
         self._ema) = _classic_block_step(
            self._gray_hist, self._sub_hist, self._classic_hist, self._ema,
            block.contiguous(), self.timer, n=self.n,
            roi=self.std_roi, std_interval=self.std_interval,
            momentum=self.noise_momentum, warmup_speed=float(self.n),
            adaptive=self.adaptive, coef_a=self.coef_a, coef_b=self.coef_b,
            hough_threshold=int(self.hough_cfg.threshold),
            min_len=int(self.hough_cfg.min_len),
            max_gap=float(self.hough_cfg.max_gap),
            max_points=self.max_points, max_peaks=self.max_peaks)
        warmup_start = self.timer
        self.timer += block.shape[0]
        return packed, dst, warmup_start

    def _collect_from_buf(self, buf: np.ndarray,
                          handle: Any) -> list[FrameResult]:
        results = super()._collect_from_buf(buf, handle)
        warmup_start = handle[2]
        # no detection until the 4-frame window is full
        for t in range(len(results)):
            if warmup_start + t + 1 < self.CLASSIC_WINDOW:
                results[t] = (np.zeros((0, 4), int),
                              np.zeros((0, self.num_cls)))
        return results

    def _classify_lines(self, frame_lines: np.ndarray) -> FrameResult:
        cls_pred = np.zeros((len(frame_lines), self.num_cls))
        cls_pred[:, 0] = 1  # always METEOR
        return frame_lines, cls_pred


class DiffAreaGuidingDetecor(BaseDetector):
    """EMA-background experimental detector; returns no lines (parity with
    the incomplete reference implementation, MetLib/Detector.py:451-519).
    Host numpy: it has no block step, and the block loop drives it frame
    by frame through ``process_block``; ``device`` is accepted and unused.

    Background maintenance uses Uint8EMA exactly as the reference does
    (warmup-adjusted momentum, int16-promoted blend,
    MetLib/utils.py:371-415); the reference defers the EMA update until
    after diffing (post_update, MetLib/Detector.py:488-501)."""

    def __init__(self, window_sec: float, fps: float, mask: np.ndarray,
                 num_cls: int, cfg, logger: BaseMetLog,
                 device: str = "cuda") -> None:
        from ..utils import Uint8EMA
        self.logger = logger
        momentum = 1 - 1 / (window_sec * fps)
        self.logger.info(f"Momentum={momentum:.4f}")
        self.bg_maintainer = Uint8EMA(momentum=momentum)
        self.cur_frame: Optional[np.ndarray] = None
        self.diff_img: Optional[np.ndarray] = None
        self.num_cls = num_cls

    def update(self, new_frame: np.ndarray) -> None:
        self.cur_frame = new_frame

    def post_update(self) -> None:
        self.bg_maintainer.update(self.cur_frame)

    def detect(self) -> FrameResult:
        if self.bg_maintainer.t == 0:
            self.bg_maintainer.update(self.cur_frame)
            self.diff_img = np.zeros_like(self.cur_frame)
            return np.zeros((0, 4), int), np.zeros((0, self.num_cls))
        self.diff_img = ((self.cur_frame.astype(np.float64) + 100)
                         > self.bg_maintainer.cur_value).astype(np.uint8) * 255
        self.post_update()
        return np.zeros((0, 4), int), np.zeros((0, self.num_cls))


def load_state_numpy(detector: LineDetector, state: dict) -> None:
    """Start ``detector`` mid-stream from carries given as numpy values.

    ``state`` holds ``gray_hist``, ``sub_hist`` and ``dy_hist`` ([n-1, ...]
    uint8), ``ema`` (the six EmaState fields in order: cur_value, t,
    warmup_on, cur_momentum, bi_threshold, bi_thr_float) and ``timer``
    (frames consumed) -- what the JAX package's M3Detector carries in
    ``_gray_hist``, ``_sub_hist``, ``_dy_hist``, ``_ema`` and
    ``_timer_dev``. For a ClassicDetector it also holds ``classic_hist``
    ([3, H, W] uint8, the last three frames)."""
    dev = detector.device

    def u8(a, like):
        t = torch.from_numpy(np.array(a, np.uint8)).to(dev)
        if t.shape != like.shape:
            raise ValueError(f"carry shape {tuple(t.shape)}, expected "
                             f"{tuple(like.shape)}")
        return t

    def f32(v):
        return torch.full((), float(np.float32(v)), dtype=torch.float32,
                          device=dev)

    detector._gray_hist = u8(state["gray_hist"], detector._gray_hist)
    detector._sub_hist = u8(state["sub_hist"], detector._sub_hist)
    detector._dy_hist = u8(state["dy_hist"], detector._dy_hist)
    if hasattr(detector, "_classic_hist"):
        detector._classic_hist = u8(state["classic_hist"],
                                    detector._classic_hist)
    cur, t, warm, mom, thr, thr_f = (np.asarray(v) for v in state["ema"])
    detector._ema = EmaState(f32(cur), int(t), bool(warm), _F32(mom),
                             f32(thr), f32(thr_f))
    detector.timer = int(np.asarray(state["timer"]))
