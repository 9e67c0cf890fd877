"""The M3 (max-minus-mean) line detector as a batched PyTorch block step.

Counterpart of ``metdetpy_tpu/detectors/m3det.py`` (reference
MetLib/Detector.py:160-448). Per block of T merged frames, one block step
runs on the device with no host sync:

  window diff (CUDA kernel) + sub-ROI noise std
  -> noise-EMA + adaptive threshold over the block
  -> median3 -> binarize -> close (CUDA kernel) -> dynamic mask
  -> batched Hough (vote and walk-pick CUDA kernels)
  -> everything the host needs packed into ONE f32 buffer.

Window history, binarized-response history (dynamic mask), EMA state and
the frame timer are carried across blocks as device tensors, as the JAX
package carries them: the EMA's update schedule, update count, warm-up
flag and momentum are computed on the device from the timer tensor (in
f32, with the fused multiply-adds XLA's CPU backend forms), so one
captured program of the step serves every block. On a card,
``M3Detector`` and ``ClassicDetector`` dispatch each block as one replay
of a CUDA graph of their step (``step_graph.StepGraph``), the counterpart
of the JAX package's ``jax.jit`` on ``_m3_block_step`` and
``_classic_block_step``.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
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
from .step_graph import StepGraph

NUM_LINES_TOOMUCH = 500
MAX_ALLOW_GAP = 0.05  # diff-area % at which the adaptive hough gap closes
N_EXTRAS = 6          # packed per-frame scalars (see _pack)
COLLECT_GROUP = 8     # default METDETPY_TPU_COLLECT_GROUP (collect_many)

# sensitivity polynomial thr = a*sigma^2 + b
# (reference MetLib/Detector.py:177-183)
SENSITIVITY_COEF = {"low": (2.0, 4.4), "normal": (1.2, 3.6),
                    "high": (0.9, 3.0)}
ABS_SENSITIVITY = {"high": 3, "normal": 5, "low": 7}

_F32 = np.float32


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
    MetLib/utils.py:324-368): six device tensors, each 0-dim for one stream
    or [S] for S streams that share a frame timer, as the JAX package's
    NamedTuple holds them."""
    cur_value: torch.Tensor     # f32
    t: torch.Tensor             # i32 update count
    warmup_on: torch.Tensor     # bool
    cur_momentum: torch.Tensor  # f32
    bi_threshold: torch.Tensor  # f32 current integer threshold
    bi_thr_float: torch.Tensor  # f32 unrounded threshold (for visu)

    @staticmethod
    def init(momentum: float, init_threshold: float, device: torch.device,
             shape: tuple = ()) -> "EmaState":
        def full(v, dtype):
            return torch.full(shape, v, dtype=dtype, device=device)
        f32 = torch.float32
        return EmaState(full(0.0, f32), full(0, torch.int32),
                        full(True, torch.bool), full(float(_F32(momentum)),
                                                     f32),
                        full(float(init_threshold), f32),
                        full(float(init_threshold), f32))

    def tensors(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def clone(self) -> "EmaState":
        return EmaState(*(x.clone() for x in self.tensors()))


def ema_update_frames(timer0: int, t_block: int, n: int,
                      std_interval: int) -> list[int]:
    """The frames of a block (0-based) whose noise EMA updates: the
    schedule of SNR_SW.update (MetLib/Detector.py:81-91), every frame
    while 1 < timer <= n, then every std_interval frames; frame i has
    timer timer0 + 1 + i. A host statement of the schedule that
    ``_ema_threshold_scan`` computes on the device (the tests and the
    stage profiler's lines read it)."""
    return [i for i in range(t_block)
            if (timer0 + 1 + i > n and (timer0 + 1 + i) % std_interval == 0)
            or 1 < timer0 + 1 + i <= n]


def ema_update_bound(t_block: int, n: int, std_interval: int) -> int:
    """The most EMA updates a block of t_block frames can hold: the n-1
    frames of the warm-up and ceil(t_block / std_interval) multiples of
    the interval, at most t_block."""
    return min(t_block, n - 1 + -(-t_block // std_interval))


def _ema_threshold_scan(stds: torch.Tensor, timer0, state: EmaState,
                        *, n: int, std_interval: int, momentum: float,
                        warmup_speed: float, adaptive: bool, coef_a: float,
                        coef_b: float):
    """Per-frame noise EMA + adaptive threshold over a block: stds [T], or
    [S, T] for S streams with ``state`` of shape [S] (one schedule).
    ``timer0`` is the frame timer, a 0-dim int32 device tensor (or a host
    int, which becomes one).

    Update schedule of SNR_SW.update (MetLib/Detector.py:81-91): every
    frame while 1 < timer <= n, then every std_interval frames. Threshold
    of LineDetector.update (:225-229) with round-half-to-even.

    Everything is device data, as in the JAX package's ``lax.scan``: the
    update mask comes from the timer tensor, each frame's update count is
    the state's plus an exclusive cumsum of the mask, the warm-up flag a
    running AND of ``k < 1`` over the updates, and the momentum of each
    update follows from them. Only the value recurrence is sequential; it
    runs over the block's updates, compacted in order, for the static
    bound ``ema_update_bound`` (the slots past the block's updates are
    identities, ``v * 1 + 0``).

    f32 arithmetic follows the JAX package's scan as XLA's CPU backend
    compiles it: ``1 - (1-k)^2`` and ``m*v + (1-m)*s`` and ``a*v^2 + b``
    are each one fused multiply-add. Returns (thr u8, thr_f f32, ema_vals
    f32, each of the shape of ``stds``, and the new state).
    """
    t_block = stds.shape[-1]
    dev = stds.device
    timer0 = windows.as_timer(timer0, dev)
    m_f = float(_F32(momentum))
    steps = torch.arange(t_block, dtype=torch.int32, device=dev)
    timers = timer0 + 1 + steps
    upd = (((timers > n) & (timers % std_interval == 0))
           | ((timers > 1) & (timers <= n)))
    n_upd = torch.cumsum(upd, dim=0, dtype=torch.int32)  # updates <= i
    # update count before frame i; k = t * (1 - m) * speed, whose two
    # constants XLA folds into one f32 product before multiplying by t
    t_at = state.t[..., None] + (n_upd - upd.to(torch.int32))
    k = t_at.to(torch.float32) * float(
        _F32(1 - momentum) * _F32(warmup_speed))
    omk = 1 - k
    warm_m = fma_f32(-omk, omk, 1.0) * m_f
    below = k < 1
    # the warm-up is on after frame i while every update so far had k < 1
    warm_after = state.warmup_on[..., None] & (
        torch.cumsum(upd & ~below, dim=-1) == 0)
    warm_before = torch.cat([state.warmup_on[..., None],
                             warm_after[..., :-1]], dim=-1)
    cur_m = torch.where(warm_before & below, warm_m, m_f)

    # the block's updates in order: update j (1-based) is at the first
    # frame whose count reaches j; slots past the block's count are
    # identities
    bound = ema_update_bound(t_block, n, std_interval)
    j = torch.arange(1, bound + 1, dtype=torch.int32, device=dev)
    frame_of = torch.searchsorted(n_upd, j).clamp(max=t_block - 1)
    real = j <= n_upd[-1]
    m_j = cur_m.index_select(-1, frame_of)
    s_j = stds.index_select(-1, frame_of) * (1 - m_j)
    a64 = torch.where(real, m_j, 1.0).double()
    b64 = torch.where(real, s_j, 0.0).double()
    val = state.cur_value
    vals = [val]
    for i in range(bound):
        # round_f32(v * m + s * (1 - m)): the product is exact in float64
        val = torch.addcmul(b64[..., i], val.double(), a64[..., i]).float()
        vals.append(val)
    ema_vals = torch.stack(vals, dim=-1).gather(
        -1, n_upd.to(torch.int64).expand(stds.shape))

    last = torch.where(upd, steps, -1).max()  # the last update's frame
    new_m = torch.where(last >= 0, cur_m.index_select(
        -1, last.clamp(min=0).to(torch.int64).reshape(1))[..., 0],
        state.cur_momentum)
    if adaptive:
        thr_f_new = fma_f32(ema_vals * ema_vals, float(_F32(coef_a)),
                            float(_F32(coef_b)))
        use = ema_vals != 0
        # carry forward the last step whose EMA value was nonzero
        last_use = torch.cummax(torch.where(use, steps, -1), dim=-1).values
        src = last_use.clamp(min=0).to(torch.int64)
        thr_f = torch.where(last_use >= 0, thr_f_new.gather(-1, src),
                            state.bi_thr_float[..., None])
        thr = torch.where(last_use >= 0,
                          torch.round(thr_f_new).gather(-1, src),
                          state.bi_threshold[..., None])
    else:
        thr_f = state.bi_thr_float[..., None].expand(stds.shape)
        thr = state.bi_threshold[..., None].expand(stds.shape)
    new_state = EmaState(ema_vals[..., -1].clone(),
                         state.t + n_upd[-1], warm_after[..., -1].clone(),
                         new_m, thr[..., -1].clone(), thr_f[..., -1].clone())
    # f32 -> u8 saturates, as XLA's conversion does
    return thr.clamp(0, 255).to(torch.uint8), thr_f, ema_vals, new_state


def _dst_sum_scales(mask_area: int,
                    sharded_fold: bool = False) -> tuple[float, float]:
    """f32 factors of the diff area ``sum / 255.0 / mask_area * 100.0`` (%
    of the mask) and of ``dst_sum / MAX_ALLOW_GAP``, as XLA folds them in
    the jitted single-stream step: the divisions become products with the
    f32 reciprocals, and the constants fold in f32 as ``(1/area * 100)``
    first, then times ``1/255``; the gap's factor is that times the f32
    reciprocal of f32(MAX_ALLOW_GAP), rounded once. The gap's ``1 - sum *
    scale`` is then contracted to a fused multiply-add. (Both held to
    jitted jnp over many areas in ``tests/test_torch_port_step_graph.py``,
    among them 64x96, whose factor a float64 product of the reciprocals
    misses by one bit.)

    ``sharded_fold``: the area factor as the JAX package's sharded
    programs fold it (the step under ``shard_map`` and ``jax.vmap``:
    ``parallel/multistream.py``, ``parallel/temporal.py``), ``1/255`` times
    ``1/area`` first, then times 100, matched against their packed
    buffers; their gap factor is the single-stream one. The two folds
    differ in the last two bits of some diff areas, nowhere else."""
    inv_area = _F32(1 / mask_area) if mask_area else _F32(np.inf)
    area = _F32(_F32(1 / 255) * _F32(inv_area * _F32(100)))
    gap = _F32(area * _F32(1 / _F32(MAX_ALLOW_GAP)))
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
    ``timer0`` is the frame timer, a 0-dim int32 tensor on the frames'
    device (a host int becomes one). Returns the packed host buffer
    ([(S,) T, K*5 + N_EXTRAS]), the dst block (for visu), the new carries
    and, as the JAX step does, the advanced timer ``timer0 + T``: a device
    carry, so the next block needs no host value of it."""
    r1, c1, r2, c2 = roi
    timer0 = windows.as_timer(timer0, frames.device)
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
    new_timer = timer0 + frames.shape[-3]
    return packed, dst, new_gray, new_sub, new_dy, new_ema, new_timer


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
    dst, dst_px, dst_sum, new_dy = _dst_and_area(
        closed, dy_hist, timer0, timer_step, n=n, dy_mask=dy_mask,
        mask_area=mask_area, sharded_fold=sharded_fold)
    gap_scale = _dst_sum_scales(mask_area, sharded_fold)[1]
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


def _dst_and_area(closed, dy_hist, timer0, timer_step, *, n, dy_mask,
                  mask_area, sharded_fold=False):
    """The dynamic mask and the diff area of ``_m3_lines``, everything of
    the step between binarization and the Hough stage. Returns (dst, its
    active pixels a frame as f32, the diff area, new dy history)."""
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
    area_scale = _dst_sum_scales(mask_area, sharded_fold)[0]
    dst_px = dst.sum(dim=(-2, -1), dtype=torch.int64).to(torch.float32)
    return dst, dst_px, dst_px * area_scale, new_dy


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
        """Reinitialize the device carries in place, as the JAX package
        does (``metdetpy_tpu/detectors/m3det.py:272-289``): the window /
        sub-ROI / dynamic-mask histories and the frame timer to zero, the
        EMA to a fresh one whose threshold starts from the last one the
        host collected (``bi_threshold``). Used by the block loop's failure
        recovery: detection restarts its warmup while the host-side
        collector keeps its accumulated tracks. In place, so that a
        captured step (``step_graph``) keeps its buffers."""
        self.timer = 0
        for carry in (self._gray_hist, self._sub_hist, self._dy_hist,
                      self._timer_dev):
            carry.zero_()
        fresh = EmaState.init(self.noise_momentum, float(self.bi_threshold),
                              self.device)
        for cur, new in zip(self._ema.tensors(), fresh.tensors()):
            cur.copy_(new)
        self._pending = []
        self._last = None

    def _init_device_state(self) -> None:
        h, w = self.hw
        r1, c1, r2, c2 = self.std_roi

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.uint8, device=self.device)
        # device carries (the timer too, see _m3_block_step's new_timer;
        # self.timer is the host shadow for bookkeeping and checkpoints)
        self.timer = 0
        self._timer_dev = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._gray_hist = zeros(self.n - 1, h, w)
        self._sub_hist = zeros(self.n - 1, r2 - r1, c2 - c1)
        self._dy_hist = zeros(self.n - 1, h, w)
        self._ema = EmaState.init(self.noise_momentum,
                                  float(self.bi_threshold), self.device)
        self._graph: Optional[StepGraph] = None  # the step's, on a card
        self._pending: list[np.ndarray] = []
        self._last: Optional[FrameResult] = None

    # -- async block API -------------------------------------------------

    def _replay(self, step, carries: tuple, block: torch.Tensor,
                static: dict):
        """One block as one replay of ``step``'s CUDA graph
        (``step_graph.StepGraph``), whose buffers are this detector's
        carries, the attributes named in ``carries`` in the step's order;
        returns (packed, dst). At the first block an idle graph of these
        carry shapes is adopted, or a new one made; it goes back when the
        detector is dropped."""
        if self._graph is None:
            self._graph = StepGraph.acquire(
                step, [getattr(self, name) for name in carries])
            for name, buf in zip(carries, self._graph.carries):
                setattr(self, name, buf)
            weakref.finalize(self, self._graph.release)
        return self._graph(block, **static)

    def process_block_async(self, block) -> Any:
        """Dispatch one block; returns an opaque handle for ``collect``.
        Device carries are updated immediately (launches are async)."""
        raise NotImplementedError

    def collect(self, handle: Any) -> list[FrameResult]:
        """Fetch a dispatched block's results (one device->host copy)."""
        return self._collect_from_buf(handle[0].cpu().numpy(), handle)

    def collect_many(self, handles: list) -> list[list[FrameResult]]:
        """Collect many dispatched blocks with one device->host copy per
        group of ``METDETPY_TPU_COLLECT_GROUP`` blocks (default
        COLLECT_GROUP, read at each call): the packed buffers are stacked
        on the device and read back as one array. The tail group is not
        padded (the JAX package pads it so that one stack program
        compiles)."""
        group = max(1, int(os.environ.get("METDETPY_TPU_COLLECT_GROUP")
                           or COLLECT_GROUP))
        bufs: list[np.ndarray] = []
        for a in range(0, len(handles), group):
            arr = torch.stack([h[0] for h in handles[a:a + group]])
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
        not write to until the step has read it.

        On a card the block is one replay of the step's CUDA graph
        (``step_graph.StepGraph``, captured at the first block of each
        shape, or adopted from a dropped detector of the same carry
        shapes), whose buffers are this detector's carries; on the CPU the
        step runs as a function of the carries."""
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(block)
        kw = self._step_static_kwargs()
        if self.device.type == "cuda":
            packed, dst = self._replay(_m3_block_step, (
                "_gray_hist", "_sub_hist", "_dy_hist", "_ema", "_timer_dev"),
                block, kw)
        else:
            (packed, dst, self._gray_hist, self._sub_hist, self._dy_hist,
             self._ema, self._timer_dev) = _m3_block_step(
                self._gray_hist, self._sub_hist, self._dy_hist, self._ema,
                block.to(self.device).contiguous(), self._timer_dev, **kw)
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
    AND with f0/f1 -> |.| -> binarize -> dilate -> Hough. ``timer0`` and
    the last output, the advanced timer, are device carries as in
    ``_m3_block_step``."""
    r1, c1, r2, c2 = roi
    t_block = frames.shape[0]
    timer0 = windows.as_timer(timer0, frames.device)
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
    return (packed, dst, new_gray, new_sub, seq[t_block:].clone(), new_ema,
            timer0 + t_block)


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

    def reset_device_state(self) -> None:
        super().reset_device_state()
        self._classic_hist.zero_()

    def _step_static_kwargs(self) -> dict:
        return dict(
            n=self.n, roi=self.std_roi, std_interval=self.std_interval,
            momentum=self.noise_momentum, warmup_speed=float(self.n),
            adaptive=self.adaptive, coef_a=self.coef_a, coef_b=self.coef_b,
            hough_threshold=int(self.hough_cfg.threshold),
            min_len=int(self.hough_cfg.min_len),
            max_gap=float(self.hough_cfg.max_gap),
            max_points=self.max_points, max_peaks=self.max_peaks)

    def process_block_async(self, block) -> Any:
        """``block``: [T, H, W] uint8, as M3Detector.process_block_async:
        on a card one replay of ``_classic_block_step``'s CUDA graph over
        this detector's carries, on the CPU the step as a function."""
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(block)
        kw = self._step_static_kwargs()
        if self.device.type == "cuda":
            packed, dst = self._replay(_classic_block_step, (
                "_gray_hist", "_sub_hist", "_classic_hist", "_ema",
                "_timer_dev"), block, kw)
        else:
            (packed, dst, self._gray_hist, self._sub_hist,
             self._classic_hist, self._ema,
             self._timer_dev) = _classic_block_step(
                self._gray_hist, self._sub_hist, self._classic_hist,
                self._ema, block.to(self.device).contiguous(),
                self._timer_dev, **kw)
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
    ([3, H, W] uint8, the last three frames).

    The carries are loaded in place, so that a captured step keeps its
    buffers."""
    def load(dst, a, dtype):
        src = torch.from_numpy(np.array(a, dtype))
        if src.shape != dst.shape:
            raise ValueError(f"carry shape {tuple(src.shape)}, expected "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    for name in ("gray_hist", "sub_hist", "dy_hist", "classic_hist"):
        if hasattr(detector, f"_{name}"):
            load(getattr(detector, f"_{name}"), state[name], np.uint8)
    for field, v in zip(detector._ema.tensors(), state["ema"]):
        load(field, np.asarray(v).reshape(field.shape),
             {torch.float32: np.float32, torch.int32: np.int32,
              torch.bool: np.bool_}[field.dtype])
    detector.timer = int(np.asarray(state["timer"]))
    detector._timer_dev.fill_(detector.timer)
