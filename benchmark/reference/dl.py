"""The dldet detector worked out again: each analysed frame's maximum with
the frames before it in the detector's window, YOLOv5s (the frozen modules)
over the window-max stack cut into the preset's tiles, the candidates above
the objectness threshold gathered from every tile and level, one greedy
non-maximum suppression over them, and each box's diagonal turned along the
gradient of its region.

Each tile is normalised to [0, 1] and resized to the model's input by the
antialiased cubic resize of ``jax.image.resize`` (Keys' kernel, a = -0.5,
widened by the scale when shrinking, each output's weights summing to 1),
in float32 with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .frozen import yolov5
from .preprocess import bgr2gray
from .frozen.records import Box

PARTITION_MIN_OVERLAP = 0.2
MULTISCALE_NMS_THRE = 0.1   # the suppression across tiles and levels
CANDIDATES = 128            # candidates an image keeps, by score
HW_TOLERANCE = 0.2
BATCH = 16                  # tiles a forward takes


def plan_tiles(h: int, w: int, mh: int, mw: int, levels: int,
               partition: int):
    """(transposed, levels of (y0, x0, hs, ws) tiles) of an [h, w] image
    for an [mh, mw] model (MetDetPy's tiling, MetLib/model.py:297-400)."""
    transposed = False
    model_ratio, ratio = mh / mw, h / w
    h_rep = w_rep = 1
    if abs(model_ratio - ratio) > HW_TOLERANCE:
        if ((ratio - 1) * (model_ratio - 1)) > 0 or abs(
                model_ratio - 1 / ratio) < HW_TOLERANCE:
            transposed = True
            h, w = w, h
        if h > w:
            h_rep = int(np.ceil(h * mw / (mh * w)))
        else:
            w_rep = int(np.ceil(w * mh / (h * mw)))
    out = []
    for level in range(levels):
        if level > 0:
            h_rep *= partition
            w_rep *= partition
        tot_h = (h_rep - 1) * PARTITION_MIN_OVERLAP
        tot_w = (w_rep - 1) * PARTITION_MIN_OVERLAP
        hs = min(int(h // (h_rep - tot_h)), h)
        ws = min(int(w // (w_rep - tot_w)), w)
        h_stride = int(h // (h_rep + tot_h))
        w_stride = int(w // (w_rep + tot_w))
        out.append([(min(i * h_stride, h - hs), min(j * w_stride, w - ws),
                     hs, ws) for i in range(h_rep) for j in range(w_rep)])
    return transposed, out


def cubic_weights(m: int, n: int) -> np.ndarray:
    """[n, m] weights of the resize of an axis from m to n samples."""
    inv = m / n
    sample = (np.arange(n) + 0.5) * inv - 0.5
    x = np.abs(sample[:, None] - np.arange(m)[None, :]) / max(inv, 1.0)
    w = np.where(x < 1, (1.5 * x - 2.5) * x * x + 1,
                 np.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2, 0.0))
    w = w / w.sum(axis=1, keepdims=True)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[:, None], w, 0.0)


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of box ``a`` with each of ``b`` (xyxy, areas without the +1)."""
    iw = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0,
                 None)
    ih = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0,
                 None)
    inter = iw * ih
    area = ((np.clip(a[2] - a[0], 0, None) * np.clip(a[3] - a[1], 0, None))
            + np.clip(b[:, 2] - b[:, 0], 0, None)
            * np.clip(b[:, 3] - b[:, 1], 0, None))
    return inter / np.maximum(area - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, score_thre: float,
        nms_thre: float) -> list:
    """Greedy suppression: the boxes at or above ``score_thre`` from the
    highest score down (ties by index), each kept unless it overlaps a kept
    one by an IoU above ``nms_thre``."""
    kept: list = []
    for i in np.argsort(-scores, kind="stable")[:CANDIDATES]:
        if scores[i] < score_thre:
            break
        if kept and (iou(boxes[i], boxes[kept]) > nms_thre).any():
            continue
        kept.append(int(i))
    return kept


def roi_angle(roi: np.ndarray) -> float:
    """The weighted circular mean of the Sobel gradient's orientation over
    the strongest 5% of the region (the borders reflected without their
    edge pixel), in [0, 2 pi), or nan where every weight is 0."""
    p = np.pad(roi.astype(np.float64), 1, mode="reflect")
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[:-2, 1:-1] - p[:-2, 2:])
    angle = np.arctan2(-gy, gx) % np.pi
    weight = np.hypot(gx, gy)
    weight = weight * (weight > np.percentile(weight, 95))
    total = np.sum(weight)
    if total == 0:
        return float("nan")
    return float(np.angle(np.sum(weight * np.exp(1j * angle)) / total)
                 % (2 * np.pi))


class YOLO:
    """YOLOv5s in float32 from the preset's weights, on the preset's tiles;
    ``control`` ``"float8"`` or ``"int8"`` rounds every body convolution's
    input and kernel to that type (one scale a tensor)."""

    def __init__(self, model_cfg: dict, nc: int, device: torch.device,
                 control: str | None = None) -> None:
        with np.load(model_cfg["weight_path"]) as data:
            flat = {k: data[k] for k in data.files}
        self.model = yolov5.YOLOv5(nc=nc, dtype=torch.float32)
        self.model.load_state_dict(yolov5.params_from_flax(flat), strict=True)
        self.model = self.model.eval().requires_grad_(False).to(device)
        self.device, self.control = device, control
        self.mh, self.mw = (int(v) for v in
                            model_cfg["input_hw"].lower().split("x"))
        self.pos_thre = float(model_cfg["pos_thre"])
        self.levels = int(model_cfg["multiscale_pred"])
        self.partition = int(model_cfg["multiscale_partition"])
        if self.levels < 1:
            raise ValueError("the reference takes multiscale_pred >= 1")

    def _forward(self, crops: torch.Tensor) -> np.ndarray:
        """[B, hs, ws, 3] float32 tiles -> decoded [B, N, 5 + nc]."""
        wh = torch.from_numpy(cubic_weights(crops.shape[1], self.mh)).to(
            self.device, torch.float32)
        ww = torch.from_numpy(cubic_weights(crops.shape[2], self.mw)).to(
            self.device, torch.float32)
        x = torch.einsum("oh,bhwc->bowc", wh, crops)
        x = torch.einsum("pw,bowc->bopc", ww, x)
        yolov5.CONTROL = self.control
        try:
            out = yolov5.decode_predictions(self.model(x), self.model.nc)
        finally:
            yolov5.CONTROL = None
        return out.cpu().numpy()

    def boxes(self, stacks: torch.Tensor) -> list:
        """[T, H, W, 3] uint8 -> T (boxes [k, 4] int, probabilities
        [k, nc])."""
        t, h, w, _ = stacks.shape
        transposed, levels = plan_tiles(h, w, self.mh, self.mw, self.levels,
                                        self.partition)
        x = stacks.to(torch.float32) / 255.0
        if transposed:
            x = x.permute(0, 2, 1, 3)
        pos = [[] for _ in range(t)]
        cls = [[] for _ in range(t)]
        for tiles in levels:
            hs, ws = tiles[0][2], tiles[0][3]
            owners = [(i, y0, x0) for i in range(t) for (y0, x0, _, _) in tiles]
            for a in range(0, len(owners), BATCH):
                part = owners[a:a + BATCH]
                crops = torch.stack([x[i, y0:y0 + hs, x0:x0 + ws]
                                     for i, y0, x0 in part])
                preds = self._forward(crops)
                for (i, y0, x0), p in zip(part, preds):
                    p = p[p[:, 4] >= self.pos_thre]
                    b = p[:, :4].copy()
                    b[:, 0] -= b[:, 2] / 2
                    b[:, 1] -= b[:, 3] / 2
                    b[:, 2] += b[:, 0]
                    b[:, 3] += b[:, 1]
                    b[:, [0, 2]] = b[:, [0, 2]] * (ws / self.mw) + x0
                    b[:, [1, 3]] = b[:, [1, 3]] * (hs / self.mh) + y0
                    pos[i].append(b.astype(int))
                    cls[i].append(np.sqrt(p[:, 5:] * p[:, 4:5]))
        out = []
        for i in range(t):
            p = np.concatenate(pos[i]) if pos[i] else np.zeros((0, 4), int)
            c = (np.concatenate(cls[i]) if cls[i]
                 else np.zeros((0, self.model.nc)))
            if len(p):
                scr = c.max(axis=1)
                top = np.argsort(-scr, kind="stable")[:CANDIDATES]
                p, c, scr = p[top], c[top], scr[top]
                keep = nms(p.astype(np.float64), scr, self.pos_thre,
                           MULTISCALE_NMS_THRE)
                p, c = p[keep], c[keep]
                ok = (p[:, 2] - p[:, 0] >= 1) & (p[:, 3] - p[:, 1] >= 1)
                p, c = p[ok], c[ok]
            if transposed:
                p = p[:, [1, 0, 3, 2]]
            out.append((p, c))
        return out


def orient(stacks: torch.Tensor, boxes: list) -> list:
    """Each box's y ends swapped where the gradient of its region on the
    stack points into the second or fourth quarter; the probabilities gain
    the OTHERS column (0)."""
    out = []
    for t, (pos, cls) in enumerate(boxes):
        pos = pos.copy()
        for i, coords in enumerate(pos):
            box = Box.from_list(list(coords))
            roi = bgr2gray(stacks[t, box.y1:box.y2, box.x1:box.x2])
            if roi.numel() == 0:
                continue
            drct = roi_angle(roi.cpu().numpy())
            if not math.isnan(drct) and int(drct // (np.pi / 2)) % 2 == 1:
                pos[i, [1, 3]] = pos[i, [3, 1]]
        out.append((pos, np.concatenate([cls, np.zeros((len(cls), 1))],
                                        axis=1)))
    return out


def window_max(frames: torch.Tensor, n: int) -> torch.Tensor:
    """[T, H, W, 3]: each frame's maximum with the n-1 frames before it,
    frames before the first reading 0."""
    out = frames.clone()
    for k in range(1, n):
        out[k:] = torch.maximum(out[k:], frames[:-k])
    return out
