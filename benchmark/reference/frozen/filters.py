"""Batched 3x3 image filters over [..., H, W] tensors (plain PyTorch).

Counterpart of ``metdetpy_tpu/ops/filters.py``: the OpenCV kernels used by
the reference detectors (cv2.medianBlur / cv2.threshold / cv2.dilate /
cv2.erode / cv2.morphologyEx), written as nine shifted views combined with
``torch.minimum`` / ``torch.maximum`` so they run on uint8 and int32 on any
device (``max_pool2d`` takes neither on the CPU).

Border conventions match OpenCV defaults:
  - medianBlur(ksize=3): BORDER_REPLICATE.
  - dilate: constant border of the dtype minimum (border never dilates in).
  - erode: constant border of the dtype maximum (border never erodes in).
"""

from __future__ import annotations

import torch

# median-of-9 network (Paeth's 19-exchange network)
MEDIAN9_PAIRS = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2))


def _pad_edge(img: torch.Tensor) -> torch.Tensor:
    """Replicate-pad the last two axes by one pixel."""
    img = torch.cat([img[..., :1, :], img, img[..., -1:, :]], dim=-2)
    return torch.cat([img[..., :1], img, img[..., -1:]], dim=-1)


def _pad_const(img: torch.Tensor, value: int) -> torch.Tensor:
    """Constant-pad the last two axes by one pixel."""
    shape = list(img.shape)
    shape[-2] += 2
    shape[-1] += 2
    out = torch.full(shape, value, dtype=img.dtype, device=img.device)
    out[..., 1:-1, 1:-1] = img
    return out


def _shifts(padded: torch.Tensor, h: int, w: int) -> list[torch.Tensor]:
    return [padded[..., dy:dy + h, dx:dx + w]
            for dy in range(3) for dx in range(3)]


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median filter over the last two axes (replicate border)."""
    h, w = img.shape[-2:]
    v = _shifts(_pad_edge(img), h, w)
    for i, j in MEDIAN9_PAIRS:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def _dtype_min(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.uint8 else torch.iinfo(dtype).min


def _dtype_max(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def dilate3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 rect dilation (max over the window), OpenCV default border."""
    h, w = img.shape[-2:]
    v = _shifts(_pad_const(img, _dtype_min(img.dtype)), h, w)
    out = v[0]
    for x in v[1:]:
        out = torch.maximum(out, x)
    return out


def erode3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 rect erosion (min over the window), OpenCV default border."""
    h, w = img.shape[-2:]
    v = _shifts(_pad_const(img, _dtype_max(img.dtype)), h, w)
    out = v[0]
    for x in v[1:]:
        out = torch.minimum(out, x)
    return out


def close3x3(img: torch.Tensor) -> torch.Tensor:
    """Morphological closing with a 3x3 rect kernel (dilate then erode)."""
    return erode3x3(dilate3x3(img))


def binary_threshold(img: torch.Tensor, thresh,
                     maxval: int = 255) -> torch.Tensor:
    """cv2.THRESH_BINARY: maxval where img > thresh else 0, as uint8.

    ``thresh`` may be a scalar or broadcastable (e.g. per-frame [T, 1, 1]).
    """
    return torch.where(img > thresh, maxval, 0).to(torch.uint8)
