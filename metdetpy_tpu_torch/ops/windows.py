"""Batched sliding-window statistics over frame blocks (plain PyTorch).

Counterpart of ``metdetpy_tpu/ops/windows.py``. A whole block of T frames
is processed at once with the previous n-1 frames carried in as history
(the reference's per-frame ``SlidingWindow`` ring buffer,
MetLib/utils.py:225-321).

torch has few uint32 ops, so the rolling sums are taken in int32/int64,
which is exact for uint8 inputs. Warmup semantics match the reference:
during the first n-1 frames the mean divides by ``length = min(n, timer)``
and the integer mean is ``sum // length``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WindowStats(NamedTuple):
    """Per-frame-position window statistics for a block of T frames."""
    win_max: torch.Tensor   # [(S,) T, H, W] u8: max over the trailing window
    win_mean: torch.Tensor  # [(S,) T, H, W] u8: integer mean (sum // length)
    diff: torch.Tensor      # [(S,) T, H, W] u8: win_max - win_mean (>= 0)


# Every function below takes frames [T, H, W] with history [n-1, H, W], or
# a leading stream axis: frames [S, T, H, W] with history [S, n-1, H, W]
# (S camera feeds, or S consecutive time shards). The time axis is -3.
# Stream s starts at frame timer0 + s * timer_step (0 for feeds that share
# a timer; the shard length for time shards). ``timer0`` is the frame timer
# as the block step carries it, a 0-dim int32 tensor on the frames' device,
# or a host int (eager callers with a host offset).


def as_timer(timer0, device: torch.device) -> torch.Tensor:
    """``timer0`` as a 0-dim int32 tensor on ``device``: a host int becomes
    a fill on the device (no host->device copy), a tensor on another device
    is moved."""
    if isinstance(timer0, torch.Tensor):
        if timer0.dtype != torch.int32 or timer0.dim() != 0:
            raise TypeError(f"frame timer: {timer0.dtype} of shape "
                            f"{tuple(timer0.shape)}, expected a 0-dim "
                            f"torch.int32")
        return timer0.to(device)
    return torch.full((), int(timer0), dtype=torch.int32, device=device)


def _seq(history: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    return torch.cat([history, frames], dim=-3)


def _new_history(seq: torch.Tensor, history: torch.Tensor, t_block: int,
                 n: int) -> torch.Tensor:
    return seq[..., t_block:, :, :].clone() if n > 1 else history


def _rolling_sum(seq: torch.Tensor, n: int, dtype: torch.dtype
                 ) -> torch.Tensor:
    """Trailing n-window sums along the time axis (-3), 'valid' extent:
    [..., n-1+T, H, W] -> [..., T, H, W]."""
    cs = torch.cumsum(seq.to(dtype), dim=-3, dtype=dtype)
    out = cs[..., n - 1:, :, :].clone()
    out[..., 1:, :, :] -= cs[..., :-n, :, :]
    return out


def window_lengths(timer0, t_block: int, n: int,
                   device: torch.device, n_streams: int = 0,
                   timer_step: int = 0) -> torch.Tensor:
    """Warmup-aware window lengths min(n, timer0 + 1 + t) as int64: [T],
    or [S, T] for ``n_streams`` streams, stream s starting at frame
    timer0 + s * timer_step. Built on the device from the timer tensor."""
    timers = torch.arange(t_block, device=device, dtype=torch.int64)
    if n_streams:
        timers = timers + timer_step * torch.arange(
            n_streams, device=device, dtype=torch.int64)[:, None]
    return torch.clamp(timers + (as_timer(timer0, device) + 1), max=n)


def _lengths(frames: torch.Tensor, timer0, n: int,
             timer_step: int) -> torch.Tensor:
    """The window lengths of ``frames``' positions: [T] or [S, T]."""
    t_block = frames.shape[-3]
    n_streams = frames.shape[0] if frames.dim() == 4 else 0
    return window_lengths(timer0, t_block, n, frames.device, n_streams,
                          timer_step)


def window_stats(history: torch.Tensor, frames: torch.Tensor, n: int,
                 timer0, timer_step: int = 0
                 ) -> tuple[WindowStats, torch.Tensor]:
    """Trailing-window max/mean for each frame position in a block.

    Args:
      history: [(S,) n-1, H, W] uint8, the n-1 frames preceding this block.
      frames: [(S,) T, H, W] uint8 block of new (exposure-merged) frames.
      n: window size in merged frames.
      timer0: frames consumed before this block (by stream 0), a 0-dim
        int32 tensor or a host int.
      timer_step: see the note above.

    Returns:
      (WindowStats, new_history [(S,) n-1, H, W]).
    """
    t_block = frames.shape[-3]
    seq = _seq(history, frames)
    win_max = seq.unfold(-3, n, 1).amax(dim=-1)
    win_sum = _rolling_sum(seq, n, torch.int32)
    lengths = _lengths(frames, timer0, n, timer_step)
    win_mean = torch.div(win_sum, lengths.to(torch.int32)[..., None, None],
                         rounding_mode="floor").to(torch.uint8)
    diff = win_max - win_mean  # max >= mean element-wise, no wraparound
    return (WindowStats(win_max, win_mean, diff),
            _new_history(seq, history, t_block, n))


def window_noise_std(history: torch.Tensor, frames: torch.Tensor, n: int,
                     timer0, timer_step: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position std of the sub-ROI window around its integer mean.

    With rolling sums S1 = sum(x), S2 = sum(x^2) and m = S1 // length,
    the per-pixel sum of squared deviations S2 - 2*m*S1 + length*m^2 is an
    integer, so it is formed and summed over the frame in int64 exactly.
    The JAX package forms the same integers in f32 (exact below 2^24) but
    sums them in f32 in XLA's order, so the two agree exactly while the
    frame sum stays below 2^24 and to f32 rounding (rtol 1e-6) above it.
    Then var = sum / (length * h * w) and std = sqrt(max(var, 0)) in f32,
    correctly rounded: the root is taken in float64 and rounded once to
    f32 (torch's vectorised f32 ``sqrt`` on the CPU is not correctly
    rounded: sqrt(89.953125) comes out 1 ulp low).

    Returns:
      (stds [(S,) T] float32, new_history).
    """
    t_block = frames.shape[-3]
    seq = _seq(history, frames)
    s1 = _rolling_sum(seq, n, torch.int64)
    s2 = _rolling_sum(seq.to(torch.int64) ** 2, n, torch.int64)
    lengths = _lengths(frames, timer0, n, timer_step)
    len3 = lengths[..., None, None]
    m = torch.div(s1, len3, rounding_mode="floor")
    ssd = s2 - 2 * m * s1 + len3 * m * m
    total = ssd.sum(dim=(-2, -1)).to(torch.float32)
    denom = lengths.to(torch.float32) * frames.shape[-2] * frames.shape[-1]
    var = total / denom
    stds = torch.sqrt(torch.clamp(var, min=0.0).double()).float()
    return stds, _new_history(seq, history, t_block, n)


def rolling_sum_u32(history: torch.Tensor, frames: torch.Tensor,
                    n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rolling window sum (int32, exact for uint8 input) over a block,
    carrying history. Used for the dynamic-mask response window
    (reference MetLib/Detector.py:234-242)."""
    t_block = frames.shape[-3]
    seq = _seq(history, frames)
    return (_rolling_sum(seq, n, torch.int32),
            _new_history(seq, history, t_block, n))


def merge_exposure_max(frames: torch.Tensor, exp_frame: int) -> torch.Tensor:
    """Merge consecutive exp_frame raw frames by per-pixel max:
    [T*e, H, W] -> [T, H, W] (reference MergeFunction.max)."""
    if exp_frame == 1:
        return frames
    t, h, w = frames.shape
    assert t % exp_frame == 0, "frame count must be a multiple of exp_frame"
    return frames.reshape(t // exp_frame, exp_frame, h, w).amax(dim=1)
