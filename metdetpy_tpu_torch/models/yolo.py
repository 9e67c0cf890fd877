"""YOLOModel runtime: preprocessing, batched multiscale tiling, device NMS.

Counterpart of ``metdetpy_tpu/models/yolo.py``. API parity with reference
YOLOModel (MetLib/model.py:169-400): ``forward(img) -> (boxes [N,4] int,
cls_scores [N,nc])`` with score = sqrt(cls * obj_conf) and the multiscale
pyramid inference scheme (transpose-to-match-aspect + h_rep x w_rep tiling
with 0.2 min overlap per level).

  - all tiles of a pyramid level run as ONE batched forward (the reference
    issues one onnxruntime call per tile under a global lock,
    MetLib/model.py:341-383);
  - NMS runs on the device with correct xyxy IoU. (The reference passes xyxy
    boxes to cv2.dnn.NMSBoxes, which expects xywh -- a latent bug that only
    weakens its suppression; we do not replicate it.)

The device functions are plain functions on tensors; everything they launch
is enqueued without a host sync. The convolutions, pools, sorts and prefix
sums are library calls (the JAX package computes them outside any Pallas
kernel as well). The model's methods may be called from any thread (the
exporter's recheck runs on its own): each enters ``torch.inference_mode``
and, on a card, selects the model's device itself.
"""

from __future__ import annotations

import collections
import functools
import os
import threading
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..log import BaseMetLog, get_default_logger
from ..ops.nms import nms_xyxy, top_k_stable
from ..utils import get_num_class
from . import yolov5
from .weights import (convert_onnx, flatten_tree, is_lfs_pointer,
                      params_from_flax)

PARTITION_MIN_OVERLAP = 0.2
MULTISCALE_NMS_OVERLAP_THRE = 0.1
DEFAULT_INPUT_HW = (640, 640)

# CALLS["forward"]: YOLOModel.forward calls that returned (one per
# rechecked clip); CALLS["network"]: forwards of the network itself that
# returned, whoever asked. A call that raises is not counted. The exporter's
# thread and the main thread both count, hence the lock.
CALLS: collections.Counter = collections.Counter()
_CALLS_LOCK = threading.Lock()


def _count(key: str) -> None:
    with _CALLS_LOCK:
        CALLS[key] += 1


def _ensure_3ch(x: np.ndarray) -> np.ndarray:
    """Expand grayscale / drop alpha so the model always sees 3 channels
    (the reference's channel-expand preprocess, MetLib/imgproc.py:128-135;
    loaders keep IMREAD_UNCHANGED semantics so single-channel images reach
    the model)."""
    if x.ndim == 2 or (x.ndim == 3 and x.shape[-1] == 1):
        x = x.reshape(*x.shape[:2])
        return np.repeat(x[..., None], 3, axis=-1)
    if x.ndim == 3 and x.shape[-1] == 4:
        return x[..., :3]
    return x


# XLA turns the JAX package's division by a constant into a multiplication
# by its float32 reciprocal (126 of the 256 uint8 values differ from a true
# division in the last bit)
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_INV_65535 = float(np.float32(1.0) / np.float32(65535.0))


def _unit_f32(x: torch.Tensor) -> torch.Tensor:
    """Integer frames are normalized to [0,1] float32 ON DEVICE, so the
    host->device copy stays 1 (uint8) or 2 (uint16) bytes/pixel. Float
    inputs are assumed already normalized and pass through unchanged."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * _INV_255
    if x.dtype == torch.uint16:
        return x.to(torch.float32) * _INV_65535
    return x.to(torch.float32)


def _fma(a, b, c) -> np.ndarray:
    """round_f32(a * b + c) of float32 arrays, as a fused multiply-add."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _cubic_kernel(d: np.ndarray, inv_scale) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, of x = d * inv_scale in
    float32, by Horner's rule with each multiply-add fused. XLA folds the
    constant ``inv_scale`` into the first coefficient of each polynomial
    (``1.5 * x`` becomes ``d * f32(1.5 * inv_scale)``); with inv_scale 1
    (upscaling) the two forms are one."""
    f = np.float32
    x = (d * inv_scale).astype(f)
    near = _fma(_fma(d, f(f(1.5) * inv_scale), f(-2.5)) * x, x, f(1.0))
    far = _fma(_fma(_fma(d, f(f(-0.5) * inv_scale), f(2.5)), x, f(-4.0)),
               x, f(2.0))
    return np.where(x >= 2.0, f(0.0), np.where(x >= 1.0, far, near))


def _xla_column_sums(w: np.ndarray) -> np.ndarray:
    """[1, n] float32 sums over the rows of ``w`` in the order of XLA's CPU
    reduction: the rows, padded with zeros to a multiple of 32 (the pad
    split evenly, the odd row after), summed in windows of 32 rows one row
    at a time, then the windows' sums one after the other."""
    f = np.float32
    m = w.shape[0]
    rows = -(-m // 32) * 32
    lo = (rows - m) // 2
    wp = np.zeros((rows, w.shape[1]), f)
    wp[lo:lo + m] = w
    wins = wp.reshape(rows // 32, 32, -1)
    acc = np.zeros((rows // 32, w.shape[1]), f)
    for j in range(32):
        acc += wins[:, j]
    total = np.zeros(w.shape[1], f)
    for part in acc:
        total += part
    return total[None]


def _cubic_weight_mat(m: int, n: int) -> np.ndarray:
    """[m, n] float32 weights of the antialiased cubic resize of an axis
    from m to n samples, as ``jax.image.resize(method="cubic")`` builds
    them: half-pixel centres, the kernel widened by m/n when scaling down,
    every output's weights normalized to sum 1. The float32 arithmetic is
    that of the jitted JAX function on XLA's CPU backend, which the weights
    equal exactly: the sample positions and the kernel's polynomial are
    fused multiply-adds, the division by the kernel's width a
    multiplication by its reciprocal folded into the polynomial's first
    coefficients, and the normalising sums XLA's windowed reduction."""
    f = np.float32
    inv_scale = f(1.0 / (n / m))
    kernel_scale = max(inv_scale, f(1.0))
    sample = _fma(np.arange(n, dtype=f) + f(0.5), inv_scale, f(-0.5))
    d = np.abs(sample[None, :] - np.arange(m, dtype=f)[:, None]).astype(f)
    w = _cubic_kernel(d, f(f(1.0) / kernel_scale))
    total = _xla_column_sums(w)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


_WEIGHT_MATS: dict = {}


def _weight_mat(m: int, n: int, device: torch.device) -> torch.Tensor:
    key = (m, n, str(device))
    if key not in _WEIGHT_MATS:
        _WEIGHT_MATS[key] = torch.from_numpy(
            _cubic_weight_mat(m, n).T.copy()).to(device)     # [n, m]
    return _WEIGHT_MATS[key]


def _resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """[B, H, W, 3] float32 -> [B, hw[0], hw[1], 3]: the cubic resize as two
    float32 products with the weight matrices (rows, then columns). The
    products follow the process-wide float32 matmul setting
    (``torch.backends.cuda.matmul.allow_tf32``): full float32 by torch's
    default, which is what the tests and ``chip_smoke.py`` run with (the
    smoke sets it to False explicitly); a caller that allows TF32 gets the
    resize in TF32 on the card."""
    if hw is None or (x.shape[1], x.shape[2]) == tuple(hw):
        return x
    if x.shape[1] != hw[0]:
        x = torch.einsum("oh,bhwc->bowc", _weight_mat(x.shape[1], hw[0],
                                                      x.device), x)
    if x.shape[2] != hw[1]:
        x = torch.einsum("pw,bowc->bopc", _weight_mat(x.shape[2], hw[1],
                                                      x.device), x)
    return x


def _topk_compact(preds: torch.Tensor, k: int, pos_thre: float):
    """Device-side candidate compaction: keep only the top-k rows by
    objectness ([B, k, 5+nc]; ties keep the lower row first) plus the
    per-image count of rows at or above pos_thre. The full decoded tensor
    is [B, N, 5+nc] with N ≈ 6300 at 320x320; the host only ever looks at
    the rows above the threshold. The count lets it detect (and warn about)
    the rare crop with more above-threshold candidates than k."""
    obj = preds[..., 4]
    _, idx = top_k_stable(obj, k)
    sel = torch.gather(preds, 1, idx[..., None].expand(-1, -1,
                                                       preds.shape[-1]))
    n_above = (obj >= pos_thre).sum(dim=-1, dtype=torch.int32)
    return sel, n_above


def _network(model: yolov5.YOLOv5, x: torch.Tensor) -> torch.Tensor:
    out = yolov5.decode_predictions(model(x), model.nc)
    _count("network")
    return out


def _forward_decode(model: yolov5.YOLOv5, imgs: torch.Tensor, hw=None):
    """imgs: [B, H, W, 3] uint8/uint16/float32 -> decoded [B, N, 5+nc]
    (normalize + optional resize to hw + forward)."""
    return _network(model, _resize_to(_unit_f32(imgs), hw))


def _forward_decode_topk(model: yolov5.YOLOv5, imgs: torch.Tensor, k: int,
                         pos_thre: float, hw=None):
    """Forward + decode + top-k compaction (see _topk_compact)."""
    return _topk_compact(_forward_decode(model, imgs, hw), k, pos_thre)


def _tiles_forward_topk(model: yolov5.YOLOv5, imgs: torch.Tensor, tiles, hw,
                        k: int, pos_thre: float, transpose: bool = False):
    """Device-resident pyramid level: imgs [B, H, W, 3] (u8/u16/f32, on the
    device) -> compacted candidates for every (image, tile) pair. Nothing
    but the [B*T, k, 5+nc] candidates ever leaves the device. Crop order is
    image-major (image 0 tiles, image 1 tiles, ...) to match the host
    path's np.stack loop."""
    x = _unit_f32(imgs)
    if transpose:
        x = x.permute(0, 2, 1, 3)
    crops = torch.stack([x[:, y0:y0 + hs, x0:x0 + ws]
                         for (y0, x0, hs, ws) in tiles], dim=1)
    bt = crops.shape[0] * crops.shape[1]
    crops = _resize_to(crops.reshape(bt, crops.shape[2], crops.shape[3], 3),
                       hw)
    return _topk_compact(_network(model, crops), k, pos_thre)


def _nms_batch(boxes: torch.Tensor, scores: torch.Tensor, score_thre: float,
               nms_thre: float, top_k: int = 128):
    """Batched greedy NMS over padded per-image candidate sets:
    boxes [B, N, 4], scores [B, N] -> (order [B, K], keep [B, K])."""
    return nms_xyxy(boxes, scores, score_thre, nms_thre, top_k)


def _xywh_to_xyxy(rows: torch.Tensor) -> torch.Tensor:
    x1 = rows[..., 0] - rows[..., 2] / 2
    y1 = rows[..., 1] - rows[..., 3] / 2
    return torch.stack([x1, y1, x1 + rows[..., 2], y1 + rows[..., 3]],
                       dim=-1)


def _sel_nms_device(sel: torch.Tensor, *, pos_thre: float, nms_thre: float):
    """xywh->xyxy + batched NMS chained on the dispatched top-k candidates
    (the box math is bit-identical to the host's: x2 = w + (x - w/2) in f32
    either way)."""
    return _nms_batch(_xywh_to_xyxy(sel), sel[..., 4], pos_thre, nms_thre)


def _compact_kept_device(sel: torch.Tensor, order: torch.Tensor,
                         keep: torch.Tensor, cap: int):
    """Gather the NMS-kept rows of a whole block into one fixed-cap buffer,
    so the readback is O(detections), not O(B * topk_readback): a prefix
    sum over the keep flags gives each kept row its slot, rows past ``cap``
    (and rows not kept) land in a discarded overflow slot. No host sync.

    Box math is bit-identical to _postprocess_single: xywh->xyxy in f32
    before any scaling, and rows appear in the same per-image order (order
    positions are already score-sorted by the NMS).

    Returns:
      packed  [cap, 5 + (5+nc) - 4]: per kept row
              (owner_image, x1, y1, x2, y2, obj, cls...) f32, rows
              owner-major in NMS order; tail rows zero.
      counts  [B] int32 kept rows per image (pre-cap).
      total   [] int32 total kept rows (pre-cap; > cap means truncated).
    """
    b, _, d = sel.shape
    rows = torch.gather(sel, 1, order[..., None].expand(-1, -1, d))
    kk = order.shape[1]
    owner = torch.arange(b, dtype=torch.float32,
                         device=sel.device)[:, None].expand(b, kk)
    payload = torch.cat([owner[..., None], _xywh_to_xyxy(rows),
                         rows[..., 4:]], dim=-1).reshape(b * kk, -1)
    flat_keep = keep.reshape(-1)
    pos = torch.cumsum(flat_keep.to(torch.int32), dim=0) - 1
    total = flat_keep.sum(dtype=torch.int32)
    tgt = torch.where(flat_keep & (pos < cap), pos, cap)
    packed = torch.zeros((cap + 1, payload.shape[1]), dtype=torch.float32,
                         device=sel.device)
    # kept rows have distinct slots; everything else writes slot `cap`
    packed[tgt] = payload
    counts = keep.sum(dim=1, dtype=torch.int32)
    return packed[:cap], counts, total


def to_numpy(x, dtype=None) -> np.ndarray:
    """A host numpy array of a tensor (one device->host copy) or of an
    array that already is one."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype=dtype)


# device-resident networks keyed by (path, mtime, device): every YOLOModel
# of a process (one per detect_video pass via MetExporter / MLDetector)
# shares one parse of the npz and one upload
_WEIGHT_CACHE: dict = {}


def _on_device(method):
    """Run a YOLOModel method under inference mode on the model's device
    (both are per-thread settings)."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with torch.inference_mode():
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    return method(self, *args, **kwargs)
            return method(self, *args, **kwargs)
    return wrapped


class YOLOModel:
    """YOLO detector on PyTorch. ``dtype`` is accepted for config parity
    and, as in the JAX package, not consulted: the body runs in bfloat16
    and the detect heads in float32."""

    def __init__(self, weight_path: Optional[str] = None,
                 dtype: str = "bfloat16", nms: bool = False,
                 warmup: bool = True, pos_thre: float = 0.25,
                 nms_thre: float = 0.45, multiscale_pred: int = 1,
                 multiscale_partition: int = 2, hw_tolerance: float = 0.2,
                 logger: Optional[BaseMetLog] = None,
                 input_hw: tuple[int, int] = DEFAULT_INPUT_HW,
                 device: str = "cuda",
                 variables: Optional[dict] = None) -> None:
        self.logger = logger or get_default_logger()
        self.device = resolve_device(device)
        hw_env = os.environ.get("METDETPY_TPU_YOLO_HW")
        if hw_env:
            h, w = hw_env.lower().split("x")
            input_hw = (int(h), int(w))
        self.nms = nms
        self.pos_thre = pos_thre
        self.nms_thre = nms_thre
        self.multiscale_pred = multiscale_pred
        self.multiscale_partition = multiscale_partition
        self.hw_tolerance = hw_tolerance
        self.h, self.w = input_hw
        self.c = 3
        self.topk_readback = int(
            os.environ.get("METDETPY_TPU_YOLO_TOPK", 256))
        # block-wide kept-row budget for the compacted single-scale
        # readback (_compact_kept_device); kept rows past it are dropped
        # with a warning (the batched NMS already caps at 128/image)
        self.compact_cap = int(
            os.environ.get("METDETPY_TPU_YOLO_COMPACT_CAP", 512))
        self.nc = get_num_class() - 2  # without DROPPED/OTHERS
        self.hw_ratio = self.h / self.w
        # the tiles of the last ``forward``'s plan, once it has returned
        self.last_tiles = 0

        self.model = self._load_weights(weight_path, variables)
        if warmup:
            _ = self._batched_forward(
                np.zeros((1, self.h, self.w, 3), np.float32))
        self.logger.info(
            f"Loaded YOLOv5s (PyTorch) on {self.device} from "
            f"{weight_path!r}.")

    # ------------------------------------------------------------------

    def _build(self, flat: dict) -> yolov5.YOLOv5:
        model = yolov5.YOLOv5(nc=self.nc)
        model.load_state_dict(params_from_flax(flat), strict=True)
        model = model.eval().requires_grad_(False).to(self.device)
        model = model.to(memory_format=torch.channels_last)
        return model.cast_body_weights_()

    def _load_weights(self, weight_path: Optional[str],
                      variables: Optional[dict]) -> yolov5.YOLOv5:
        """The network with its weights on the device: from ``variables``
        (the flattened flax tree as numpy arrays) when given, else from
        ``weight_path`` (``.npz`` of that tree, or an ultralytics ``.onnx``).
        A missing or unreadable file raises: there is no random
        initialisation to fall back on."""
        if variables is not None:
            return self._build(variables)
        if not weight_path or not os.path.isfile(weight_path):
            raise FileNotFoundError(
                f"YOLO weight file {weight_path!r} does not exist")
        if is_lfs_pointer(weight_path):
            raise ValueError(
                f"YOLO weight file {weight_path!r} is a Git-LFS pointer, "
                "not the weights; fetch the real file")
        key = (os.path.abspath(weight_path), os.path.getmtime(weight_path),
               str(self.device))
        cached = _WEIGHT_CACHE.get(key)
        if cached is None:
            if weight_path.endswith(".npz"):
                with np.load(weight_path) as data:
                    flat = {k: data[k] for k in data.files}
            elif weight_path.endswith(".onnx"):
                self.logger.info("Converting ONNX weights...")
                flat = flatten_tree(convert_onnx(weight_path))
            else:
                raise ValueError(
                    f"YOLO weight file {weight_path!r} is neither a .npz "
                    "nor a .onnx file")
            cached = _WEIGHT_CACHE[key] = self._build(flat)
        return cached

    def _to_device(self, imgs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)

    # ------------------------------------------------------------------

    @_on_device
    def _batched_forward(self, imgs: np.ndarray) -> np.ndarray:
        """imgs: [B, h, w, 3] uint8/uint16 (or float32 in [0,1]);
        normalized + resized on device to the model resolution; returns
        [B, N, 5+nc] float32 numpy."""
        out = _forward_decode(self.model, self._to_device(imgs),
                              hw=(self.h, self.w))
        return to_numpy(out, np.float32)

    def _k_budget(self) -> int:
        n_anchors = 3 * sum((self.h // s) * (self.w // s)
                            for s in (8, 16, 32))
        return min(self.topk_readback, n_anchors)

    def _warn_truncated(self, n_above, k: int) -> None:
        n_above = to_numpy(n_above)
        if (n_above > k).any():
            self.logger.warning(
                f"top-k readback truncated {int((n_above > k).sum())} "
                f"crop(s) with >{k} above-threshold candidates; raise "
                f"METDETPY_TPU_YOLO_TOPK to keep them all.")

    @_on_device
    def _batched_forward_topk(self, imgs: np.ndarray) -> np.ndarray:
        """Like _batched_forward, but reads back only the top-k
        candidates per image by objectness (device-compacted; see
        _topk_compact). Used by the multiscale tile loop, where the
        host immediately discards sub-threshold rows anyway."""
        k = self._k_budget()
        sel, n_above = _forward_decode_topk(
            self.model, self._to_device(imgs), k, self.pos_thre,
            hw=(self.h, self.w))
        self._warn_truncated(n_above, k)
        return to_numpy(sel, np.float32)

    def _nms_host(self, boxes: np.ndarray, scores: np.ndarray,
                  nms_thre: float):
        """Batched device NMS of host candidates -> numpy (order, keep)."""
        order, keep = _nms_batch(self._to_device(boxes),
                                 self._to_device(scores), self.pos_thre,
                                 nms_thre)
        return to_numpy(order), to_numpy(keep)

    def _postprocess_single(self, pred: np.ndarray, scale_wh,
                            order_keep=None):
        """pred [N, 5+nc] xywh+obj+cls at model scale -> (boxes xyxy int,
        cls scores) at input scale. With NMS on, ``order_keep`` carries
        this image's rows of an NMS that already ran batched."""
        boxes = pred[:, :4].copy()
        boxes[:, 0] -= boxes[:, 2] / 2
        boxes[:, 1] -= boxes[:, 3] / 2
        boxes[:, 2] += boxes[:, 0]
        boxes[:, 3] += boxes[:, 1]
        if self.nms:
            if order_keep is None:
                order, keep = self._nms_host(boxes[None], pred[None, :, 4],
                                             self.nms_thre)
                order_keep = (order[0], keep[0])
            idx = order_keep[0][order_keep[1]]
            boxes, pred = boxes[idx], pred[idx]
        sw, sh = scale_wh
        boxes[:, 0] *= sw
        boxes[:, 2] *= sw
        boxes[:, 1] *= sh
        boxes[:, 3] *= sh
        result_pos = boxes.astype(int)
        # sqrt score correction (reference MetLib/model.py:293-294)
        result_cls = np.sqrt(np.einsum("ab,a->ab", pred[:, 5:], pred[:, 4]))
        # drop degenerate boxes (decoded w/h rounds below one pixel)
        ok = ((result_pos[:, 2] - result_pos[:, 0] >= 1)
              & (result_pos[:, 3] - result_pos[:, 1] >= 1))
        return result_pos[ok], result_cls[ok]

    def _forward_tiles(self, x: np.ndarray, tiles):
        """Run a batch of same-size crops through one forward; offset boxes
        back to image coordinates."""
        batch = np.stack([x[y0:y0 + hs, x0:x0 + ws]
                          for (y0, x0, hs, ws) in tiles])
        # with NMS on, sub-top-k rows are score-filtered anyway -- read
        # back only the compacted candidates (see _forward_decode_topk);
        # nms=False callers get every anchor row, unfiltered
        order = keep = None
        if self.nms:
            k = self._k_budget()
            sel, n_above = _forward_decode_topk(
                self.model, self._to_device(batch), k, self.pos_thre,
                hw=(self.h, self.w))
            # the per-tile NMS of all tiles in one batched call
            order, keep = _sel_nms_device(sel, pos_thre=self.pos_thre,
                                          nms_thre=self.nms_thre)
            self._warn_truncated(n_above, k)
            preds = to_numpy(sel, np.float32)
            order, keep = to_numpy(order), to_numpy(keep)
        else:
            preds = self._batched_forward(batch)
        all_pos, all_cls = [], []
        hs, ws = tiles[0][2], tiles[0][3]
        scale = (ws / self.w, hs / self.h)
        for k, (y0, x0, _, _) in enumerate(tiles):
            pos, cls = self._postprocess_single(
                preds[k], scale,
                None if order is None else (order[k], keep[k]))
            pos[:, [0, 2]] += x0
            pos[:, [1, 3]] += y0
            all_pos.append(pos)
            all_cls.append(cls)
        return all_pos, all_cls

    def _plan_tiles(self, h: int, w: int):
        """Multiscale tile plan for an [h, w] image: (transpose_flag,
        levels), each level a list of same-shape (y0, x0, hs, ws) tiles
        (reference tiling scheme MetLib/model.py:297-400; origins clamped so
        the whole level runs as one stackable batch)."""
        transpose_flag = False
        input_hw_ratio = h / w
        h_rep, w_rep = 1, 1
        if abs(self.hw_ratio - input_hw_ratio) > self.hw_tolerance:
            if ((input_hw_ratio - 1) * (self.hw_ratio - 1)) > 0 or abs(
                    self.hw_ratio - 1 / input_hw_ratio) < self.hw_tolerance:
                transpose_flag = True
                input_hw_ratio = 1 / input_hw_ratio
                h, w = w, h
            if h > w:
                h_rep = int(np.ceil(h * self.w / (self.h * w)))
            else:
                w_rep = int(np.ceil(w * self.h / (h * self.w)))
        levels = []
        for scale in range(self.multiscale_pred):
            if scale > 0:
                h_rep *= self.multiscale_partition
                w_rep *= self.multiscale_partition
            tot_h = (h_rep - 1) * PARTITION_MIN_OVERLAP
            tot_w = (w_rep - 1) * PARTITION_MIN_OVERLAP
            h_size = min(int(h // (h_rep - tot_h)), h)
            w_size = min(int(w // (w_rep - tot_w)), w)
            h_stride = int(h // (h_rep + tot_h))
            w_stride = int(w // (w_rep + tot_w))
            levels.append([(min(i * h_stride, h - h_size),
                            min(j * w_stride, w - w_size), h_size, w_size)
                           for i in range(h_rep) for j in range(w_rep)])
        return transpose_flag, levels

    @_on_device
    def forward(self, x: np.ndarray):
        """Multiscale inference on one [H, W(, C)] uint8/uint16 image
        (grayscale expanded, alpha dropped). An exception in any pyramid
        level propagates: no level is skipped. ``last_tiles`` is then the
        number of tiles its plan ran."""
        out, self.last_tiles = self._forward(x)
        _count("forward")
        return out

    def _forward(self, x: np.ndarray):
        """((boxes, class scores), the tiles of the plan that ran)."""
        assert isinstance(x, np.ndarray) and x.ndim in (2, 3)
        x = _ensure_3ch(x)
        h, w, c = x.shape
        assert c == self.c, "channel count must match"
        if x.dtype not in (np.uint8, np.uint16):
            x = x.astype(np.float32) / 255.0  # u8/u16 normalize on device

        if self.multiscale_pred == 0:
            pred = self._batched_forward(x[None])[0]
            return self._postprocess_single(pred,
                                            (w / self.w, h / self.h)), 1

        transpose_flag, levels = self._plan_tiles(h, w)
        if transpose_flag:
            x = np.transpose(x, (1, 0, 2))

        result_pos: list[np.ndarray] = []
        result_cls: list[np.ndarray] = []
        for tiles in levels:
            pos_list, cls_list = self._forward_tiles(x, tiles)
            result_pos.extend(pos_list)
            result_cls.extend(cls_list)

        pos = np.concatenate(result_pos, axis=0)
        cls = np.concatenate(result_cls, axis=0)
        if len(pos) > 0:
            order, keep = self._nms_host(
                pos.astype(np.float32)[None],
                np.max(cls, axis=-1).astype(np.float32)[None],
                MULTISCALE_NMS_OVERLAP_THRE)
            idx = order[0][keep[0]]
            pos, cls = pos[idx], cls[idx]
        if transpose_flag:
            pos = pos[:, [1, 0, 3, 2]]
        return (pos, cls), sum(len(tiles) for tiles in levels)

    MAX_BATCH_CANDIDATES = 128  # per-image candidate budget for batched NMS

    @_on_device
    def forward_batch(self, imgs: np.ndarray) -> list:
        """Batched multiscale inference on [B, H, W, 3] uint8/uint16 images.

        Every pyramid level of every image runs in ONE device forward, and
        the final per-image NMS is a single batched device call. Per-tile
        pre-NMS is skipped (the stricter global multiscale NMS at IoU 0.1
        subsumes it), so box sets can differ from forward() in which member
        of a duplicate cluster survives.
        """
        assert imgs.ndim in (3, 4)
        if imgs.ndim == 3 or imgs.shape[-1] != self.c:
            imgs = np.stack([_ensure_3ch(im) for im in imgs])
        b, h, w, _ = imgs.shape
        if b == 0:
            return []
        x = (imgs if imgs.dtype in (np.uint8, np.uint16)
             else imgs.astype(np.float32) / 255.0)  # ints normalize on device
        if self.multiscale_pred == 0 or not self.nms:
            # nms=False keeps forward()'s exact (unfiltered) semantics
            preds = self._batched_forward(x)
            return [self._postprocess_single(preds[k],
                                             (w / self.w, h / self.h))
                    for k in range(b)]

        transpose_flag, levels = self._plan_tiles(h, w)
        if transpose_flag:
            x = np.transpose(x, (0, 2, 1, 3))

        per_pos = [[] for _ in range(b)]
        per_cls = [[] for _ in range(b)]
        for tiles in levels:
            hs, ws = tiles[0][2], tiles[0][3]
            crops = np.stack([x[k, y0:y0 + hs, x0:x0 + ws]
                              for k in range(b) for (y0, x0, _, _) in tiles])
            preds = self._batched_forward_topk(crops)
            self._accum_level(preds, tiles, b, per_pos, per_cls)
        return self._finalize_batch(per_pos, per_cls, b, transpose_flag)

    @_on_device
    def forward_batch_device(self, imgs_dev: torch.Tensor) -> list:
        """forward_batch for a [B, H, W, 3] uint8/uint16 tensor already on
        the device (e.g. MLDetector's window-max stacks): tiling,
        normalization, resize, forward and candidate compaction all run on
        the device and only the compacted top-k rows (plus the batched NMS
        verdicts) are copied back -- the stacks are never read back.
        Results match ``forward_batch(imgs_dev.cpu().numpy())`` exactly.
        (The reference fetches every stack to host and runs one
        onnxruntime call per tile, MetLib/Detector.py:522-573 +
        model.py:341-383.)"""
        if not self.nms:
            # full-anchor-row semantics require every row on host anyway
            return self.forward_batch(to_numpy(imgs_dev))
        if imgs_dev.shape[0] == 0:
            return []
        return self.collect_batch_device(self.dispatch_batch_device(
            imgs_dev))

    @_on_device
    def dispatch_batch_device(self, imgs_dev: torch.Tensor):
        """Dispatch-only half of forward_batch_device: enqueues every
        pyramid level's device work (launches are async) and returns an
        opaque handle of device tensors. Finish with collect_batch_device
        -- the pair lets a block pipeline overlap block N's host
        postprocess with block N+1's device compute."""
        if not self.nms:
            raise NotImplementedError(
                "device-resident dispatch requires nms=True")
        b, h, w, c = imgs_dev.shape
        assert c == self.c, "channel count must match"
        if imgs_dev.dtype not in (torch.uint8, torch.uint16):
            # match forward_batch's host semantics for float inputs
            # (divide by 255); u8/u16 normalize in _unit_f32
            imgs_dev = imgs_dev.to(torch.float32) / 255.0
        k = self._k_budget()
        single_scale = self.multiscale_pred == 0
        if single_scale:
            transpose_flag, levels = False, [((0, 0, h, w),)]
        else:
            transpose_flag, levels = self._plan_tiles(h, w)
        outs = []
        for tiles in levels:
            sel, n_above = _tiles_forward_topk(
                self.model, imgs_dev, tuple(tiles), (self.h, self.w), k,
                self.pos_thre, transpose_flag)
            if single_scale:
                # single-scale NMS needs no cross-level accumulation, so
                # it chains onto the forward, and the kept rows are
                # compacted across the block so the readback is
                # O(detections) (see _compact_kept_device)
                order, keep = _sel_nms_device(sel, pos_thre=self.pos_thre,
                                              nms_thre=self.nms_thre)
                packed, counts, total = _compact_kept_device(
                    sel, order, keep, self.compact_cap)
                outs.append((tiles, packed, counts, total, n_above))
            else:
                outs.append((tiles, sel, n_above))
        return ("compact" if single_scale else False, b, h, w,
                transpose_flag, k, outs)

    def collect_batch_device(self, handle) -> list:
        """Blocking half of dispatch_batch_device: copy the compacted
        candidates back (one small copy per level, none where the handle
        already holds numpy arrays) and run the host-side accumulation +
        the single batched NMS."""
        return self.collect_batch_device_rows(handle)[0]

    @_on_device
    def collect_batch_device_rows(self, handle) -> tuple:
        """collect_batch_device plus, for a single-scale ("compact")
        handle, each image's packed-row indices of its surviving boxes
        (see _unpack_compact; None for a multiscale handle). MLDetector
        joins the device-computed orientation triples through them."""
        single_scale, b, h, w, transpose_flag, k, outs = handle
        if single_scale == "compact":
            (_, packed, counts, total, n_above), = outs
            self._warn_truncated(n_above, k)
            return self._unpack_compact(
                to_numpy(packed, np.float32), to_numpy(counts),
                int(to_numpy(total)), b,
                (w / self.w, h / self.h))
        per_pos = [[] for _ in range(b)]
        per_cls = [[] for _ in range(b)]
        for tiles, sel, n_above in outs:
            self._warn_truncated(n_above, k)
            self._accum_level(to_numpy(sel, np.float32), tiles, b, per_pos,
                              per_cls)
        return self._finalize_batch(per_pos, per_cls, b,
                                    transpose_flag), None

    def _unpack_compact(self, packed: np.ndarray, counts: np.ndarray,
                        total: int, b: int, scale_wh):
        """Host half of _compact_kept_device: split the packed kept rows
        back into per-image (boxes, cls) with math bit-identical to
        _postprocess_single (f32 scale, then int cast, then the
        degenerate-box filter and sqrt(cls*obj) scores). Returns
        (results, rowidx): rowidx[i] is the global packed-row index of each
        surviving row of image i (the device-computed orientation triples
        are indexed by packed row)."""
        if total > len(packed):
            self.logger.warning(
                f"compacted readback truncated {total - len(packed)} "
                f"kept row(s); raise METDETPY_TPU_YOLO_COMPACT_CAP.")
        sw, sh = scale_wh
        n = min(total, len(packed))
        ends = np.minimum(np.cumsum(counts), n)
        starts = np.concatenate(([0], ends[:-1]))
        out, rowidx = [], []
        for i in range(b):
            rows = packed[starts[i]:ends[i]]
            bx = rows[:, 1:5].copy()
            bx[:, [0, 2]] *= sw
            bx[:, [1, 3]] *= sh
            result_pos = bx.astype(int)
            p = rows[:, 5:]
            result_cls = np.sqrt(np.einsum("ab,a->ab", p[:, 1:], p[:, 0]))
            ok = ((result_pos[:, 2] - result_pos[:, 0] >= 1)
                  & (result_pos[:, 3] - result_pos[:, 1] >= 1))
            rowidx.append(np.arange(starts[i], ends[i])[ok])
            out.append((result_pos[ok], result_cls[ok]))
        return out, rowidx

    def _accum_level(self, preds: np.ndarray, tiles, b: int, per_pos,
                     per_cls) -> None:
        """Host-side candidate accumulation for one pyramid level (shared
        by the host-crop and device-resident paths; preds is image-major
        [b*T, k, 5+nc] at model scale)."""
        hs, ws = tiles[0][2], tiles[0][3]
        sw, sh = ws / self.w, hs / self.h
        idx = 0
        for k in range(b):
            for (y0, x0, _, _) in tiles:
                p = preds[idx]
                idx += 1
                m = p[:, 4] >= self.pos_thre
                if not m.any():
                    continue
                p = p[m]
                boxes = p[:, :4].copy()
                boxes[:, 0] -= boxes[:, 2] / 2
                boxes[:, 1] -= boxes[:, 3] / 2
                boxes[:, 2] += boxes[:, 0]
                boxes[:, 3] += boxes[:, 1]
                boxes[:, [0, 2]] = boxes[:, [0, 2]] * sw + x0
                boxes[:, [1, 3]] = boxes[:, [1, 3]] * sh + y0
                per_pos[k].append(boxes.astype(int))
                per_cls[k].append(np.sqrt(
                    np.einsum("ab,a->ab", p[:, 5:], p[:, 4])))

    def _finalize_batch(self, per_pos, per_cls, b: int,
                        transpose_flag: bool) -> list:
        """Cap candidates, run the global multiscale NMS (one batched
        device call) and unpack per-image (boxes, cls) results."""
        cap = self.MAX_BATCH_CANDIDATES
        cand_pos = np.zeros((b, cap, 4), np.float32)
        cand_scr = np.full((b, cap), -1.0, np.float32)
        kept_pos = [np.zeros((0, 4), int)] * b
        kept_cls = [np.zeros((0, self.nc), np.float32)] * b
        counts = np.zeros(b, int)
        cls_store: list[np.ndarray] = [None] * b
        pos_store: list[np.ndarray] = [None] * b
        for k in range(b):
            if not per_pos[k]:
                continue
            pos = np.concatenate(per_pos[k])
            cls = np.concatenate(per_cls[k])
            scr = np.max(cls, axis=-1)
            if len(pos) > cap:
                top = np.argsort(-scr)[:cap]
                pos, cls, scr = pos[top], cls[top], scr[top]
            n = len(pos)
            cand_pos[k, :n] = pos
            cand_scr[k, :n] = scr
            counts[k] = n
            pos_store[k], cls_store[k] = pos, cls
        if counts.any():
            order, keep = self._nms_host(cand_pos, cand_scr,
                                         MULTISCALE_NMS_OVERLAP_THRE)
            for k in range(b):
                if counts[k] == 0:
                    continue
                sel = order[k][keep[k] & (order[k] < counts[k])]
                p = pos_store[k][sel].astype(int)
                ok = ((p[:, 2] - p[:, 0] >= 1) & (p[:, 3] - p[:, 1] >= 1))
                kept_pos[k] = p[ok]
                kept_cls[k] = cls_store[k][sel][ok]
        if transpose_flag:
            kept_pos = [p[:, [1, 0, 3, 2]] if len(p) else p
                        for p in kept_pos]
        return list(zip(kept_pos, kept_cls))
