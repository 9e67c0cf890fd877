"""The helpers of the port's ``utils`` that the collector and the M3
lines use: the class names, point geometry, time stamps, the line-set NMS
and the trapezoid membership functions."""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable, Sequence

import numpy as np

# global/class_name.txt beside this package
RESOURCE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ID2NAME: dict[int, str] = {}
_NAME2ID: dict[str, int] = {}
_classes_loaded = False


def _load_class_names() -> None:
    global _classes_loaded
    if _classes_loaded:
        return
    fname = os.path.join(RESOURCE_DIR, "global", "class_name.txt")
    with open(fname, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            num, name = line.split()
            _ID2NAME[int(num)] = name
            _NAME2ID[name] = int(num)
    top = max(_ID2NAME.keys())
    for offset, extra in ((1, "DROPPED"), (2, "OTHERS")):
        _ID2NAME[top + offset] = extra
        _NAME2ID[extra] = top + offset
    _classes_loaded = True


def get_id2name() -> dict[int, str]:
    _load_class_names()
    return _ID2NAME


def get_num_class() -> int:
    _load_class_names()
    return len(_ID2NAME)


class Name2Label:
    """Fixed class-id registry (reference MetLib/collector.py:28-63)."""
    METEOR = 0
    PLANE_SATELLITE = 1
    RED_SPRITE = 2
    LIGHTNING = 3
    JET = 4
    RARE_SPRITE = 5
    SPACECRAFT = 6
    BUGS = 7

    @staticmethod
    def OTHERS() -> int:
        return get_num_class() - 2

    @staticmethod
    def DROPPED() -> int:
        return get_num_class() - 1


# ---------------------------------------------------------------------------
# Point geometry (reference MetLib/utils.py:128-177)
# ---------------------------------------------------------------------------


def pt_len_sqr(pt1: Any, pt2: Any):
    if isinstance(pt1, np.ndarray) and isinstance(pt2, np.ndarray):
        return (pt1[..., 1] - pt2[..., 1]) ** 2 + (pt1[..., 0] - pt2[..., 0]) ** 2
    return (pt1[1] - pt2[1]) ** 2 + (pt1[0] - pt2[0]) ** 2


def pt_len(pt1: Any, pt2: Any):
    return np.sqrt(pt_len_sqr(pt1, pt2))


def pt_drct(pt1: Any, pt2: Any) -> float:
    """Direction angle of the two-point line, in [0, pi]."""
    return float(np.arccos((pt2[1] - pt1[1]) / pt_len(pt1, pt2)))


def frame2ts(frame: int, fps: float) -> str:
    return datetime.datetime.strftime(
        datetime.datetime.fromtimestamp(frame / fps, tz=datetime.timezone.utc),
        "%H:%M:%S.%f")[:-3]


def lineset_nms(lines: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Line-set NMS: greedy grouping by center distance within the longest
    line's radius, plus a "non-line" (area) probability per kept line from
    the group's width/length ratio (reference MetLib/utils.py:780-839).
    """
    num = len(lines)
    dy = lines[:, 3] - lines[:, 1]
    dx = lines[:, 2] - lines[:, 0]
    length_sqr = dy.astype(np.int64) ** 2 + dx.astype(np.int64) ** 2
    # implicit line params (A, B, C): A=y2-y1, B=x1-x2, C=x2*y1-y2*x1
    abc = np.stack([
        lines[:, 3] - lines[:, 1],
        lines[:, 0] - lines[:, 2],
        lines[:, 2] * lines[:, 1] - lines[:, 3] * lines[:, 0],
    ], axis=1).astype(np.int64)
    centers = (lines[:, 2:] + lines[:, :2]) // 2
    order = np.argsort(length_sqr)[::-1]
    taken = np.zeros((num,), dtype=bool)
    keep: list[int] = []
    widths: list[float] = []
    for pos, idx in enumerate(order):
        if taken[idx]:
            continue
        keep.append(idx)
        taken[idx] = True
        max_width = 0.0
        for idy in order[pos:]:
            if taken[idy]:
                continue
            if pt_len_sqr(centers[idx], centers[idy]) < length_sqr[idx] // 4:
                taken[idy] = True
                max_width = max(
                    max_width,
                    float(abs(abc[idx, 0] * centers[idy][0]
                              + abc[idx, 1] * centers[idy][1] + abc[idx, 2])))
        widths.append(max_width)
    keep_arr = np.array(keep, dtype=int)
    norms = np.sqrt((abc[keep_arr, 0] ** 2 + abc[keep_arr, 1] ** 2).astype(float))
    nonline_prob = (np.abs(widths) / norms
                    / np.sqrt(length_sqr[keep_arr].astype(float)) * 2)
    nonline_prob = np.minimum(nonline_prob, 1.0)
    return lines[keep_arr], nonline_prob


def create_prob_func(rng: Sequence[float]) -> Callable[[float], float]:
    """Trapezoid membership function over (a, b)
    (reference MetLib/collector.py:70-94)."""
    a, b = rng

    def get_prob(x: float) -> float:
        if x < a:
            return x / a
        if a <= x <= b:
            return 1
        if x < 2 * b:
            return (2 * b - x) / b
        return 0

    return get_prob
