"""Host-side utilities: geometry, time conversion, resize parsing, class
registry, sigma-clipping and box matching.

Behavior parity with reference MetLib/utils.py (cited per function); all
implementations are fresh and numpy-based. Device-side math lives in
``metdetpy_tpu_torch.ops``.
"""

from __future__ import annotations

import datetime
import os
import os.path as path
import warnings
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from .structs import Box
from .version import PROJECT_NAME, VERSION  # noqa: F401  (re-export)

EPS = 1e-2
PI = np.pi / 180.0
EULER_CONSTANT = 0.5772
MAX_SIGMA_CLIP_ITERS = 10
LIVE_MODE_SPEED_CTRL_CONST = 0.9

SWITCH2BOOL = {"on": True, "off": False}

STR2DTYPE = {
    "float32": np.float32,
    "float16": np.float16,
    "bfloat16": np.float32,  # host staging dtype; device casts to bf16
    "int8": np.int8,
}

# ---------------------------------------------------------------------------
# Resource directory (reference MetLib/utils.py:50-80)
# ---------------------------------------------------------------------------

_resource_dir_override: Optional[str] = os.environ.get(
    "METDET_RESOURCE_DIR", None)


def set_resource_dir(resource_dir: Optional[str]) -> None:
    global _resource_dir_override
    _resource_dir_override = resource_dir


def get_resource_dir() -> str:
    if _resource_dir_override:
        return _resource_dir_override
    # package lives at <workspace>/metdetpy_tpu_torch/utils.py
    return path.dirname(path.dirname(path.abspath(__file__)))


def relative2abs_path(rpath: str) -> str:
    if rpath.startswith("./"):
        rpath = rpath[2:]
    return path.join(get_resource_dir(), rpath)


def get_clip_config_path() -> str:
    return path.join(get_resource_dir(), "global", "clip_cfg.json")


# ---------------------------------------------------------------------------
# Class-name registry (reference MetLib/utils.py:33-48, global/class_name.txt)
# ---------------------------------------------------------------------------

_ID2NAME: dict[int, str] = {}
_NAME2ID: dict[str, int] = {}
_classes_loaded = False


def _load_class_names() -> None:
    global _classes_loaded
    if _classes_loaded:
        return
    fname = relative2abs_path("./global/class_name.txt")
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


def get_name2id() -> dict[str, int]:
    _load_class_names()
    return _NAME2ID


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


def pt_offset(pt: Sequence[Any], offset: Sequence[Any]) -> list[Any]:
    assert len(pt) == len(offset)
    return [v + o for v, o in zip(pt, offset)]


# ---------------------------------------------------------------------------
# Statistics helpers
# ---------------------------------------------------------------------------


def sigma_clip(sequence: Union[list, np.ndarray],
               sigma: float = 3.0) -> np.ndarray:
    """Iterative sigma-clipping (reference MetLib/utils.py:516-540)."""
    seq = np.asarray(sequence).reshape((-1,))
    mean, std = np.mean(seq), np.std(seq)
    for _ in range(MAX_SIGMA_CLIP_ITERS):
        seq = seq[np.abs(mean - seq) <= sigma * std]
        new_mean, new_std = np.mean(seq), np.std(seq)
        if new_mean == mean:
            break
        mean, std = new_mean, new_std
    return seq


def circular_kernel(size: int) -> np.ndarray:
    """Binary disc structuring element (reference MetLib/utils.py:543-559)."""
    if size % 2 == 0 or size <= 0:
        raise ValueError("size must be a positive odd integer")
    r = size // 2
    y, x = np.ogrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


class EMA:
    """Exponential moving average with quadratic warmup
    (reference MetLib/utils.py:324-368)."""

    def __init__(self, momentum: float = 0.99,
                 warmup_speed: Union[int, float] = 1) -> None:
        assert 0 <= momentum <= 1
        self.init_momentum = momentum
        self.cur_momentum = momentum
        self.cur_value: Any = 0
        self.t = 0
        self.warmup_speed = warmup_speed

    def _adjust(self) -> None:
        k = self.t * (1 - self.init_momentum) * self.warmup_speed
        if k < 1:
            self.cur_momentum = self.init_momentum * (1 - (1 - k) ** 2)
        else:
            self.warmup_speed = 0
            self.cur_momentum = self.init_momentum

    def update(self, value: Any) -> None:
        if self.warmup_speed:
            self._adjust()
        self.cur_value = (self.cur_momentum * self.cur_value
                          + (1 - self.cur_momentum) * value)
        self.t += 1


class Uint8EMA(EMA):
    """EMA over uint8 image matrices (reference MetLib/utils.py:371-415).

    The incoming frame is promoted to int16 before the blend so uint8
    wraparound can never poison the background estimate; the running
    value itself is a float matrix (the momentum blend is float math in
    the reference too). Shares the quadratic momentum warmup with EMA.
    """

    def update(self, value: np.ndarray) -> None:
        if self.warmup_speed > 0:
            self._adjust()
        value_copy = np.array(value, dtype=np.int16)
        self.cur_value = (self.cur_momentum * self.cur_value
                          + (1 - self.cur_momentum) * value_copy)
        self.t += 1


# ---------------------------------------------------------------------------
# Resize / size parsing (reference MetLib/utils.py:562-632)
# ---------------------------------------------------------------------------


def parse_resize_param(tgt_wh: Union[None, list, str, int],
                       raw_wh: Union[list, tuple]) -> list[int]:
    """Parse a resize option to [w, h] given the raw size [w, h]."""
    if tgt_wh is None:
        return list(raw_wh)
    w, h = raw_wh
    if isinstance(tgt_wh, str):
        try:
            if "x" in tgt_wh.lower():
                tgt_wh = list(map(int, tgt_wh.lower().split("x")))
            else:
                tgt_wh = int(tgt_wh)
        except Exception as e:
            raise Exception(
                f"{e}: invalid --resize value; expected an integer or "
                f"\"WxH\", got {tgt_wh}.")
    if isinstance(tgt_wh, int):
        tgt_wh = [tgt_wh, -1] if w > h else [-1, tgt_wh]
    if isinstance(tgt_wh, list):
        if len(tgt_wh) != 2:
            raise Exception(f"resize list must have 2 entries, got {len(tgt_wh)}")
        if tgt_wh[0] <= 0 or tgt_wh[1] <= 0:
            if tgt_wh[0] <= 0 and tgt_wh[1] <= 0:
                warnings.warn("Invalid resize; raw resolution will be used.")
                return list(raw_wh)
            idn = 0 if tgt_wh[0] <= 0 else 1
            idx = 1 - idn
            tgt_wh[idn] = int(raw_wh[idn] * tgt_wh[idx] / raw_wh[idx])
        return list(tgt_wh)
    raise TypeError(f"unsupported resize arg type {type(tgt_wh)}")


def transpose_wh(size_mat: Sequence[int]) -> list[int]:
    if len(size_mat) == 2:
        return [size_mat[1], size_mat[0]]
    if len(size_mat) == 3:
        x, y, c = size_mat
        return [y, x, c]
    raise Exception(f"size list should have length 2 or 3, got {len(size_mat)}")


# ---------------------------------------------------------------------------
# Frame <-> time conversion (reference MetLib/utils.py:635-741)
# ---------------------------------------------------------------------------


def frame2ts(frame: int, fps: float) -> str:
    return datetime.datetime.strftime(
        datetime.datetime.fromtimestamp(frame / fps, tz=datetime.timezone.utc),
        "%H:%M:%S.%f")[:-3]


def ts2frame(time: str, fps: float) -> int:
    assert time.count(":") == 2, f"invalid time string {time!r}"
    fmt = "%H:%M:%S.%f" if "." in time else "%H:%M:%S"
    dt = datetime.datetime.strptime(time, fmt)
    seconds = dt.hour * 3600 + dt.minute * 60 + dt.second + dt.microsecond / 1e6
    return int(round(seconds * fps))


def adjust_ts(time_str: str, offset_sec: float, fps: float) -> str:
    frame = ts2frame(time_str, fps)
    return frame2ts(max(0, frame + int(round(offset_sec * fps))), fps)


def time2frame(time_ms: int, fps: float) -> int:
    return int(round(time_ms / 1000 * fps))


def frame2time(frame: int, fps: float) -> int:
    return int(round(frame * 1000 / fps))


def timestr2int(time: str) -> int:
    if ":" in time:
        return ts2frame(time, fps=1000)
    return int(time)


# ---------------------------------------------------------------------------
# Box / prediction utilities (reference MetLib/utils.py:887-1006)
# ---------------------------------------------------------------------------


def xywh2xyxy(mat: np.ndarray, inplace: bool = True) -> np.ndarray:
    if not inplace:
        mat = mat.copy()
    mat[:, 0] = mat[:, 0] - mat[:, 2] / 2
    mat[:, 1] = mat[:, 1] - mat[:, 3] / 2
    mat[:, 2] = mat[:, 0] + mat[:, 2]
    mat[:, 3] = mat[:, 1] + mat[:, 3]
    return mat


def calculate_area_iou(mat1: Box, mat2: Box) -> float:
    """IoU with degenerate (zero-width/height) handling
    (reference MetLib/utils.py:921-953)."""
    if mat1.x1 == mat1.x2 == mat2.x1 == mat2.x2:
        o_y = sorted([mat1.y1, mat1.y2, mat2.y1, mat2.y2], reverse=True)
        if mat1.y1 == mat2.y1 and mat1.y2 == mat2.y2:
            return 1
        return (o_y[2] - o_y[1]) / (o_y[3] - o_y[0])
    if mat1.y1 == mat1.y2 == mat2.y1 == mat2.y2:
        o_x = sorted([mat1.x1, mat1.x2, mat2.x1, mat2.x2], reverse=True)
        if mat1.x1 == mat2.x1 and mat1.x2 == mat2.x2:
            return 1
        return (o_x[2] - o_x[1]) / (o_x[3] - o_x[0])
    if (mat1.x1 >= mat2.x2 or mat1.x2 <= mat2.x1
            or mat1.y1 >= mat2.y2 or mat1.y2 <= mat2.y1):
        return 0
    i_xx = sorted([mat1.x1, mat1.x2, mat2.x1, mat2.x2], reverse=True)[1:-1]
    i_yy = sorted([mat1.y1, mat1.y2, mat2.y1, mat2.y2], reverse=True)[1:-1]
    area_i = (i_xx[1] - i_xx[0]) * (i_yy[1] - i_yy[0])
    area_a = (mat1.x2 - mat1.x1) * (mat1.y2 - mat1.y1)
    area_b = (mat2.x2 - mat2.x1) * (mat2.y2 - mat2.y1)
    return area_i / (area_a + area_b - area_i)


def box_matching(src_seq: Sequence[Sequence[int]],
                 tgt_seq: Sequence[Sequence[int]],
                 iou_threshold: float = 0.5) -> list[tuple[int, int]]:
    """Greedy best-IoU matching src->tgt (reference MetLib/utils.py:956-979)."""
    match_ind: list[tuple[int, int]] = []
    matched: set[int] = set()
    tgt_boxes = [Box.from_list(list(x)) for x in tgt_seq]
    src_boxes = [Box.from_list(list(x)) for x in src_seq]
    for i, sbox in enumerate(src_boxes):
        best_iou, best_j = 0.0, -1
        for j, tbox in enumerate(tgt_boxes):
            if j in matched:
                continue
            iou = calculate_area_iou(sbox, tbox)
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_j != -1:
            match_ind.append((i, best_j))
            matched.add(best_j)
    return match_ind


def expand_cls_pred(cls_pred: np.ndarray) -> np.ndarray:
    """Append an extra OTHERS column (reference MetLib/utils.py:996-1006)."""
    n = cls_pred.shape[0]
    return np.concatenate([cls_pred, np.zeros((n, 1))], axis=-1)


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


def color_interpolater(colors: list[tuple[int, ...]]):
    """Return f: [0,1] -> interpolated color tuple
    (reference MetLib/utils.py:744-777)."""
    arrs = [np.array(c, dtype=float) for c in colors]
    gap = 1 / (len(arrs) - 1)

    def interp(x: float) -> tuple[int, ...]:
        x = min(max(x, 0.0), 1.0)
        i = max(int((x - EPS) / gap), 0)
        dx = x / gap - i
        mixed = (1 - dx) * arrs[i] + dx * arrs[i + 1]
        return tuple(int(v) for v in mixed)

    return interp
