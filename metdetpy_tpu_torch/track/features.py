"""Image feature helpers used by detectors and the exporter
(reference MetLib/feature.py:13-69). Host-side; inputs are tiny ROI crops.
"""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np

from ..structs import Box


def crop_with_box(img: np.ndarray, roi: Box) -> np.ndarray:
    return img[roi.y1:roi.y2, roi.x1:roi.x2]


def calc_roi_gradient(img: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> float:
    """Weighted circular mean of Sobel gradient orientation; used to orient
    the bounding-box diagonal of ML detections."""
    if img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    gx = cv2.Sobel(img, cv2.CV_64F, 1, 0, ksize=3)
    gy = cv2.Sobel(img, cv2.CV_64F, 0, 1, ksize=3)
    angle = np.arctan2(-gy, gx) % np.pi
    weight = np.hypot(gx, gy)
    if mask is not None:
        weight = weight * mask.astype(weight.dtype)
    else:
        high = np.percentile(weight, 95)
        weight = weight * (weight > high)
    total = np.sum(weight)
    if total == 0:
        return float("nan")
    mean_angle = np.angle(np.sum(weight * np.exp(1j * angle)) / total)
    return float(mean_angle % (2 * np.pi))


def calc_brightness_with_roi(img: np.ndarray, roi: Optional[Box] = None,
                             gamma: float = 2.2) -> float:
    """Relative target brightness: Otsu-separated fg/bg mean ratio^(1/gamma)
    over a context window twice the box's long side."""
    if img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if roi is not None:
        (x, y), (w, h) = roi.to_xywh_list()
        long_side = max(w, h)
        ctx = Box(max(0, x - long_side), max(0, y - long_side),
                  x + long_side, y + long_side)
        roi_img = crop_with_box(img, ctx)
    else:
        roi_img = img
    blurred = cv2.blur(roi_img, (5, 5))
    _, mask = cv2.threshold(blurred, 0, 255,
                            cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    bg = np.mean(blurred[mask == 255])
    fg = np.mean(blurred[mask == 0])
    return float(fg / bg) ** (1 / gamma)
