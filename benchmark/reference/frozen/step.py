"""The port's M3 block step as a function of its carries (the port replays
it as one CUDA graph a block): window diff and sub-ROI noise, the noise EMA
and adaptive threshold, median-binarize-close, the dynamic mask and the
batched Hough, every output packed into one float32 buffer a block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import filters, kernels, windows
from .f32 import fma_f32
from .hough import hough_lines_batch

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
