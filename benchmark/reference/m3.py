"""The M3 detector worked out again: the frozen block step over the
analysed frames, block by block with its carries, and the per-frame lines
the collector takes (a frame whose Hough overflowed, or that holds no line
or more than ``NUM_LINES_TOOMUCH``, gives none; the others go through the
line-set NMS, with the METEOR probability one less the line's area-likeness
and the OTHERS probability that likeness).
"""

from __future__ import annotations

import numpy as np
import torch

from .frozen import step
from .frozen.utils import lineset_nms

MAX_POINTS = 8192   # binarized points a frame's Hough takes
MAX_PEAKS = 64      # lines a frame's Hough returns
NUM_LINES_TOOMUCH = 500


class M3:

    def __init__(self, cfg: dict, window_sec: float, eq_fps: float,
                 hw: tuple, num_cls: int, device: torch.device) -> None:
        binary, hough = cfg["binary"], cfg["hough_line"]
        self.num_cls = num_cls
        h, w = hw
        n = max(int(window_sec * eq_fps), 1)
        mask = np.ones(hw, np.uint8)
        roi = step.select_subarea(mask, binary["area"])
        adaptive = bool(binary["adaptive_bi_thre"])
        if adaptive:
            coef_a, coef_b = step.SENSITIVITY_COEF[binary["sensitivity"]]
            init_thr = step.ABS_SENSITIVITY[binary["sensitivity"]]
        else:
            coef_a, coef_b = 0.0, 0.0
            init_thr = binary["init_value"]
        momentum = 1 - binary["interval"] / 60
        self.static = dict(
            n=n, roi=roi, dy_mask=bool(cfg["dynamic"]["dy_mask"]),
            mask_area=int(mask.sum()), std_interval=binary["interval"] * n,
            momentum=momentum, warmup_speed=float(n), adaptive=adaptive,
            coef_a=coef_a, coef_b=coef_b,
            hough_threshold=int(hough["threshold"]),
            min_len=int(hough["min_len"]), max_gap=float(hough["max_gap"]),
            max_points=MAX_POINTS, max_peaks=MAX_PEAKS)
        r1, c1, r2, c2 = roi

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.uint8, device=device)
        self.carries = (zeros(n - 1, h, w), zeros(n - 1, r2 - r1, c2 - c1),
                        zeros(n - 1, h, w),
                        step.EmaState.init(momentum, float(init_thr), device),
                        torch.zeros((), dtype=torch.int32, device=device))

    def block(self, frames: torch.Tensor) -> list:
        """[T, H, W] uint8 analysed frames -> T (lines, probabilities)."""
        gray, sub, dy, ema, timer = self.carries
        packed, _, gray, sub, dy, ema, timer = step._m3_block_step(
            gray, sub, dy, ema, frames.contiguous(), timer, **self.static)
        self.carries = (gray, sub, dy, ema, timer)
        lines, valid, extras = step._unpack(packed.cpu().numpy(), MAX_PEAKS)
        out = []
        for t in range(lines.shape[0]):
            frame_lines = lines[t][valid[t]]
            if (extras[t, 2] > 0.5 or len(frame_lines) == 0
                    or len(frame_lines) > NUM_LINES_TOOMUCH):
                out.append((np.zeros((0, 4), int),
                            np.zeros((0, self.num_cls))))
                continue
            kept, nonline = lineset_nms(frame_lines)
            probs = np.zeros((len(kept), self.num_cls))
            probs[:, -1] = nonline
            probs[:, 0] = 1 - nonline
            out.append((kept, probs))
        return out
