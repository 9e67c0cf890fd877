"""The loader's preprocess worked out again from the clip: the resize to the
analysed size (OpenCV's ``INTER_LINEAR`` on uint8, in its fixed-point
arithmetic), and the exposure's max-merge of raw frames.

The resize of an axis from ``src`` to ``dst`` samples source position
``(d + 0.5) * src / dst - 0.5``, rounded down to ``s`` with the rest ``f``
(float32). A row is first combined along x with the 11-bit weights
``round(2048 * (1 - f))`` and ``round(2048 * f)`` into integers, then along
y as OpenCV's vector path does: each product of the x-sum shifted right by 4
and a y weight is shifted right by 16, the two are added and rounded with
``(sum + 2) >> 2``. Positions left of the first column or past the last
take that column alone (along y, the rows are clamped). At 2:1 on both axes
this is the mean of each 2x2 square, rounded: ``(a + b + c + d + 2) >> 2``.
A colour frame is turned gray after its resize.
"""

from __future__ import annotations

import numpy as np
import torch


def _taps(src: int, dst: int, clamp_weight: bool):
    """(first index, second index, first weight, second weight) of each
    output position of an axis."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weight:
        f = np.where((s < 0) | (s >= src - 1), np.float32(0), f)
    s0 = np.clip(s, 0, src - 1)
    s1 = np.clip(s + 1, 0, src - 1)
    if clamp_weight:
        s1 = np.where(s >= src - 1, s0, s1)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return s0, s1, w0, w1


def resize_linear(frames: torch.Tensor, width: int,
                  height: int) -> torch.Tensor:
    """[N, H, W(, C)] uint8 -> [N, height, width(, C)] uint8."""
    n, h, w = frames.shape[:3]
    if (h, w) == (height, width):
        return frames
    dev = frames.device
    xs0, xs1, a0, a1 = (torch.from_numpy(v).to(dev)
                        for v in _taps(w, width, True))
    ys0, ys1, b0, b1 = (torch.from_numpy(v).to(dev)
                        for v in _taps(h, height, False))
    a0, a1, b0, b1 = (v.to(torch.int32) for v in (a0, a1, b0, b1))
    extra = (1,) * (frames.dim() - 3)
    a0, a1 = a0.view(-1, *extra), a1.view(-1, *extra)
    b0, b1 = b0.view(-1, 1, *extra), b1.view(-1, 1, *extra)
    x = frames.to(torch.int32)
    rows = x[:, :, xs0] * a0 + x[:, :, xs1] * a1      # [N, H, width(, C)]
    top = ((rows[:, ys0] >> 4) * b0) >> 16
    bottom = ((rows[:, ys1] >> 4) * b1) >> 16
    return ((top + bottom + 2) >> 2).clamp(0, 255).to(torch.uint8)


def bgr2gray(frames: torch.Tensor) -> torch.Tensor:
    """[..., 3] BGR uint8 -> [...] uint8: BT.601 in OpenCV's 15-bit fixed
    point, ``(3735 B + 19235 G + 9798 R + 2**14) >> 15``."""
    x = frames.to(torch.int32)
    return ((3735 * x[..., 0] + 19235 * x[..., 1] + 9798 * x[..., 2]
             + (1 << 14)) >> 15).to(torch.uint8)


def max_merge(frames: torch.Tensor, e: int) -> torch.Tensor:
    """The maximum of each run of ``e`` frames, a partial run at the end
    left out: [N, ...] -> [N // e, ...]."""
    m = frames.shape[0] // e
    return frames[:m * e].reshape(m, e, *frames.shape[1:]).amax(dim=1)
