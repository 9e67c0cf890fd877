"""MLDetector: deep-learning primary detector over max-stacked windows.

Counterpart of ``metdetpy_tpu/detectors/mldet.py``. Parity with reference
MLDetector (MetLib/Detector.py:522-573): the detector max-stacks the sliding
window of color frames and runs the YOLO model on the stack, then orients
each box's diagonal via the Sobel gradient direction of its ROI.

Per block the stacks are computed in one device pass (a rolling max over the
block with the previous n-1 frames carried in) and the YOLO forwards are
batched; nothing is copied back until the block is collected.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..log import BaseMetLog
from ..models import init_model
from ..models.yolo import to_numpy
from ..ops.f32 import fma_f32
from ..structs import Box, DLCfg
from ..track.features import calc_roi_gradient
from ..utils import expand_cls_pred
from .base import BaseDetector, FrameResult


def _window_max_color(hist: torch.Tensor, frames: torch.Tensor, n: int):
    """Rolling max over [T, H, W, C] with [n-1, H, W, C] history, or over
    S streams at once ([S, T, H, W, C] with [S, n-1, H, W, C])."""
    seq = torch.cat([hist, frames], dim=-4)
    out = seq.unfold(-4, n, 1).amax(dim=-1) if n > 1 else seq
    # a copy, so the carry does not keep the whole sequence alive
    return out, seq[..., frames.shape[-4]:, :, :, :].clone()


_ROI_WIN = 256          # ROI window side (boxes larger fall back)

# device-orientation limits: rows beyond _ORIENT_CAP or ROIs larger than
# _ORIENT_WIN fall back to the host ROI-fetch path (the weight-percentile
# needs a [cap, win*win] sort, so both are kept small; meteors at 320-px
# analysis are tens of px and a 64-frame block rarely keeps >64 boxes)
_ORIENT_CAP = 64
_ORIENT_WIN = 96


def _reflect101(n: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 index fold (vectorized, clamped so any
    off-range probe stays in-bounds; off-range only happens for masked
    outputs)."""
    n = n.abs()
    n = torch.where(n >= length, 2 * length - 2 - n, n)
    return torch.minimum(n.clamp(min=0), length - 1)


def _gray_i32(win: torch.Tensor) -> torch.Tensor:
    """BGR -> gray with OpenCV's fixed-point weights, int32."""
    win = win.to(torch.int32)
    return (win[..., 0] * 3735 + win[..., 1] * 19235
            + win[..., 2] * 9798 + 16384) >> 15


def _gather_windows(stacks: torch.Tensor, ts, ys, xs, p: int):
    """[N, p, p, C] windows of [T, H, W, C] stacks at (t, y, x) origins;
    origins are clamped so every window lies inside its frame."""
    _, h, w, _ = stacks.shape
    ar = torch.arange(p, device=stacks.device)
    rows = ys.clamp(0, h - p)[:, None] + ar
    cols = xs.clamp(0, w - p)[:, None] + ar
    return stacks[ts[:, None, None], rows[:, :, None], cols[:, None, :]]


def _orient_from_packed(stacks: torch.Tensor, packed: torch.Tensor,
                        sw: float, sh: float, p: int) -> torch.Tensor:
    """Device Sobel circular-mean orientation for the compacted kept rows.

    Mirrors track.features.calc_roi_gradient (reference
    MetLib/feature.py:17-34) per row of the model's packed readback
    (owner, x1, y1, x2, y2, obj, cls...) at model scale:
      * box -> frame scale (*sw/*sh), trunc-to-int, python-slice clamp
        semantics (exactly what the host _orient_results does),
      * gray conversion with cv2's fixed-point weights,
      * 3x3 Sobel with BORDER_REFLECT_101 folded at the ROI's own edges,
      * weight = hypot(gx, gy), thresholded at the ROI's 95th percentile
        (np.percentile linear interpolation, computed via a full sort),
      * weighted circular sums.

    Returns [cap, 4] f32: (sc, cc, wtot, ok) where sc/cc are the weighted
    circular sums of angle = atan2(-gy, gx) mod pi, wtot the weight total,
    and ok=0 flags rows this function could not handle (ROI larger than
    ``p``) -- the host falls back to the fetched-ROI path for those.
    Host-side drct = atan2(sc, cc) % 2pi.

    Numerics: gx/gy and their squares are integer-exact in f32; the
    percentile cut and the circular sums run in f32 (the host reference is
    f64), so angles can differ by ~1e-5 rad -- the consumer only uses the
    quadrant of the angle. Against the JAX package ``ok`` is exact and the
    sums agree to the order of the f32 additions.
    """
    t_n, h, w, _ = stacks.shape
    dev = stacks.device
    f32 = torch.float32
    t = packed[:, 0].to(torch.int32).clamp(0, t_n - 1).long()
    scale = torch.tensor([sw, sh, sw, sh], dtype=f32, device=dev)
    bi = (packed[:, 1:5] * scale).to(torch.int32).long()  # trunc cast
    x1, y1, x2, y2 = bi[:, 0], bi[:, 1], bi[:, 2], bi[:, 3]

    def clampidx(v, length):
        # python slice(start, stop).indices(length) semantics
        return torch.where(v < 0, (length + v).clamp(min=0),
                           v.clamp(max=length))
    y1c, y2c = clampidx(y1, h), clampidx(y2, h)
    x1c, x2c = clampidx(x1, w), clampidx(x2, w)
    bh = (y2c - y1c).clamp(min=0)
    bw = (x2c - x1c).clamp(min=0)
    ok = (bh <= p) & (bw <= p)
    empty = (bh == 0) | (bw == 0)
    # gather a [p, p] window that contains the valid ROI
    y0 = torch.minimum(y1c, torch.full_like(y1c, h - p)).clamp(0, h - p)
    x0 = torch.minimum(x1c, torch.full_like(x1c, w - p)).clamp(0, w - p)
    gray = _gray_i32(_gather_windows(stacks, t, y0, x0, p))  # [cap, p, p]
    vy, vx = y1c - y0, x1c - x0
    # reflect-101 padded ROI in window-local coords: [cap, p+2, p+2]
    ar = torch.arange(-1, p + 1, device=dev)[None, :]
    rm = (vy[:, None] + _reflect101(ar, bh.clamp(min=1)[:, None])
          ).clamp(0, p - 1)
    cm = (vx[:, None] + _reflect101(ar, bw.clamp(min=1)[:, None])
          ).clamp(0, p - 1)
    rows = torch.arange(packed.shape[0], device=dev)[:, None, None]
    padded = gray[rows, rm[:, :, None], cm[:, None, :]]
    gx = ((padded[:, :-2, 2:] - padded[:, :-2, :-2])
          + 2 * (padded[:, 1:-1, 2:] - padded[:, 1:-1, :-2])
          + (padded[:, 2:, 2:] - padded[:, 2:, :-2]))
    gy = ((padded[:, 2:, :-2] - padded[:, :-2, :-2])
          + 2 * (padded[:, 2:, 1:-1] - padded[:, :-2, 1:-1])
          + (padded[:, 2:, 2:] - padded[:, :-2, 2:]))
    gxf, gyf = gx.to(f32), gy.to(f32)
    angle = torch.remainder(torch.atan2(-gyf, gxf), math.pi)
    weight = torch.sqrt(gxf * gxf + gyf * gyf)
    ri = torch.arange(p, device=dev)
    valid = ((ri[None, :, None] < bh[:, None, None])
             & (ri[None, None, :] < bw[:, None, None]))
    # np.percentile(weight, 95) with linear interpolation over the bh*bw
    # valid values: ascending sort with invalids at +inf
    flat = torch.where(valid, weight, torch.inf).reshape(packed.shape[0], -1)
    s = torch.sort(flat, dim=1).values
    n_valid = (bh * bw).clamp(min=1)
    a = 0.95 * (n_valid - 1).to(f32)
    # (rows with an ROI larger than the window are flagged not ok; their
    # probes are clamped into the sorted row)
    lo = torch.floor(a).long().clamp(max=p * p - 1)
    hi = torch.minimum(lo + 1, n_valid - 1).clamp(max=p * p - 1)
    s_lo = s.gather(1, lo[:, None])[:, 0]
    s_hi = s.gather(1, hi[:, None])[:, 0]
    # one fused multiply-add, as XLA's CPU backend contracts it
    cut = fma_f32(a - lo.to(f32), s_hi - s_lo, s_lo)
    wt = torch.where(valid & (weight > cut[:, None, None]), weight, 0.0)
    sc = (wt * torch.sin(angle)).sum(dim=(1, 2))
    cc = (wt * torch.cos(angle)).sum(dim=(1, 2))
    wtot = wt.sum(dim=(1, 2))
    zero = torch.zeros((), dtype=f32, device=dev)
    return torch.stack([torch.where(empty, zero, sc),
                        torch.where(empty, zero, cc),
                        torch.where(empty, zero, wtot),
                        (ok | empty).to(f32)], dim=1)


def _gather_gray_rois(stacks: torch.Tensor, ts, ys, xs, p: int):
    """Extract [N, p, p] windows at (t, y, x) origins from u8 [T, H, W, 3]
    BGR stacks and gray-convert on device with OpenCV's exact fixed-point
    weights ((B*3735 + G*19235 + R*9798 + 16384) >> 15) -- the host reads
    every detection's orientation ROI in ONE copy instead of one per
    detection."""
    return _gray_i32(_gather_windows(stacks, ts.long(), ys.long(),
                                     xs.long(), p)).to(torch.uint8)


def fetch_gray_rois(stacks_dev: torch.Tensor, dets: list) -> list:
    """Batched orientation-ROI readback. ``dets`` holds
    (t, y1, y2, x1, x2) with raw (possibly negative / overshooting)
    box coords; each entry resolves with python plain-slice semantics
    -- exactly what ``stacks_dev[t, y1:y2, x1:x2]`` did -- then all
    in-window ROIs arrive as one [N, p, p] device gather + a single
    device->host copy (gray-converted on device, bit-equal to cv2's
    BGR2GRAY). Oversize ROIs (> _ROI_WIN) fall back to an individual
    copy. Returns gray u8 arrays (size 0 when the slice is empty),
    one per det."""
    h, w = int(stacks_dev.shape[1]), int(stacks_dev.shape[2])
    p = int(min(_ROI_WIN, h, w))
    out: list = [None] * len(dets)
    pend: list = []   # (det_idx, oy, ox, bh, bw)
    origins: list = []  # (t, y0, x0)
    for i, (t, y1, y2, x1, x2) in enumerate(dets):
        y1c, y2c, _ = slice(int(y1), int(y2)).indices(h)
        x1c, x2c, _ = slice(int(x1), int(x2)).indices(w)
        bh, bw = max(0, y2c - y1c), max(0, x2c - x1c)
        if bh == 0 or bw == 0:
            out[i] = np.zeros((bh, bw), np.uint8)
            continue
        if bh > p or bw > p:
            with torch.inference_mode():
                out[i] = _gray_i32(stacks_dev[t, y1c:y2c, x1c:x2c]).to(
                    torch.uint8).cpu().numpy()
            continue
        y0 = min(y1c, h - p)
        x0 = min(x1c, w - p)
        pend.append((i, y1c - y0, x1c - x0, bh, bw))
        origins.append((t, y0, x0))
    if pend:
        with torch.inference_mode():
            ts, ys, xs = torch.tensor(origins, dtype=torch.int64,
                                      device=stacks_dev.device).unbind(1)
            wins = _gather_gray_rois(stacks_dev, ts, ys, xs,
                                     p).cpu().numpy()
        for (i, oy, ox, bh, bw), win in zip(pend, wins):
            out[i] = win[oy:oy + bh, ox:ox + bw]
    return out


def orient_results(stacks_dev, batch_out: list, num_cls: int, orient=None,
                   rowidx=None) -> list[FrameResult]:
    """Orient each box of ``batch_out`` (frame t of the [T, H, W, 3]
    stacks) along the Sobel gradient of its ROI (reference
    MetLib/Detector.py:549-554): from the device-computed sums ``orient``
    joined through ``rowidx`` where given, else from the ROIs copied back
    in one batch (``fetch_gray_rois``). Returns per-frame (boxes, cls)."""
    results: list[FrameResult] = []
    dets: list = []       # (t, y1, y2, x1, x2)
    drcts: list = []      # device-computed angle or None (host leg)
    use_dev = orient is not None and rowidx is not None
    for t, (pos, cls) in enumerate(batch_out):
        for i, coords in enumerate(pos):
            if use_dev:
                r = int(rowidx[t][i])
                if r < len(orient) and orient[r][3] > 0:
                    sc, cc, wtot, _ = orient[r]
                    drcts.append(
                        float(np.arctan2(sc, cc) % (2 * np.pi))
                        if wtot > 0 else float("nan"))
                    continue
            box = Box.from_list(list(coords))
            dets.append((t, box.y1, box.y2, box.x1, box.x2))
            drcts.append(None)
    rois = fetch_gray_rois(stacks_dev, dets) if dets else []
    roi_iter = iter(rois)
    # orient each box diagonal along the dominant gradient direction
    # (reference MetLib/Detector.py:549-554); device-computed angles
    # (the compact path) resolved above, host-fetched ROIs here
    di = 0
    for t, (pos, cls) in enumerate(batch_out):
        for i in range(len(pos)):
            drct = drcts[di]
            di += 1
            if drct is None:
                roi = next(roi_iter)
                if roi.size == 0:
                    continue
                drct = calc_roi_gradient(roi)
            if not np.isnan(drct) and int(drct // (np.pi / 2)) % 2 == 1:
                pos[i, [1, 3]] = pos[i, [3, 1]]
    for t, (pos, cls) in enumerate(batch_out):
        if len(pos) == 0:
            results.append((np.zeros((0, 4), int),
                            np.zeros((0, num_cls))))
            continue
        results.append((pos, expand_cls_pred(cls)))
    return results


class MLDetector(BaseDetector):

    def __init__(self, window_sec: float, fps: float, mask: np.ndarray,
                 num_cls: int, cfg: DLCfg, logger: BaseMetLog,
                 device: str = "cuda") -> None:
        self.device = resolve_device(device)
        self.mask = mask
        self.num_cls = num_cls
        self.logger = logger
        self.n = max(int(window_sec * fps), 1)
        h, w = mask.shape[:2]
        c = mask.shape[2] if mask.ndim == 3 else 3
        self._hist_shape = (self.n - 1, h, w, c)
        self.reset_device_state()
        self.model = init_model(cfg.model, logger=self.logger,
                                device=self.device)
        # the device-resident dispatch needs the model's NMS; without it
        # the block loop drives process_block (every anchor row on the host)
        self.supports_async = bool(self.model.nms)
        self._pending: list[np.ndarray] = []
        self._last: Optional[FrameResult] = None
        self.result_pos = np.zeros((0, 4), int)
        # cumulative collect_many decomposition (api perf dict)
        self.last_collect_stats: dict = {}

    def update(self, new_frame: np.ndarray) -> None:
        self._pending.append(np.asarray(new_frame, dtype=np.uint8))

    def detect(self) -> FrameResult:
        if self._pending:
            block = np.stack(self._pending)
            self._pending.clear()
            self._last = self.process_block(block)[-1]
        if self._last is None:
            return np.zeros((0, 4), int), np.zeros((0, self.num_cls))
        return self._last

    def reset_device_state(self) -> None:
        """Device-fault recovery (api.py block loop): drop the possibly
        poisoned device-side window history; it re-warms over the next
        n-1 frames."""
        self._hist = torch.zeros(self._hist_shape, dtype=torch.uint8,
                                 device=self.device)

    def process_block_async(self, block) -> tuple:
        """Enqueue one block's window-max + every YOLO pyramid level on the
        device (async; the history carry updates immediately, so blocks can
        pipeline). ``block`` may be a host array (uploaded here) or a
        tensor already on the detector's device. Needs ``supports_async``
        (a model with nms=True); the model's dispatch raises otherwise."""
        with torch.inference_mode():
            if isinstance(block, np.ndarray):
                block = torch.from_numpy(block).to(self.device)
            stacks_dev, self._hist = _window_max_color(self._hist, block,
                                                       self.n)
            mh = self.model.dispatch_batch_device(stacks_dev)
            orient_dev = None
            if mh[0] == "compact":
                # chain the ROI orientation on the packed kept rows so the
                # angles ride the same deferred readback (no extra
                # host<->device round trips for in-cap, in-window boxes)
                (_, packed, _, _, _), = mh[6]
                h, w = int(stacks_dev.shape[1]), int(stacks_dev.shape[2])
                p = int(min(_ORIENT_WIN, h, w))
                orient_dev = _orient_from_packed(
                    stacks_dev, packed[:_ORIENT_CAP],
                    float(np.float32(w / self.model.w)),
                    float(np.float32(h / self.model.h)), p)
        return stacks_dev, mh, orient_dev

    def collect(self, handle: tuple) -> list[FrameResult]:
        stacks_dev, model_handle, orient_dev = handle
        batch_out, rowidx = self.model.collect_batch_device_rows(
            model_handle)
        return self._orient_results(
            stacks_dev, batch_out,
            orient=None if orient_dev is None else to_numpy(orient_dev),
            rowidx=rowidx)

    # the deferred-collection horizon keeps every handle's window-max
    # stacks alive on device ([T, H, W, 3] each, ~100 MB per 64-frame
    # 540p color block) until the flush -- bound the backlog well under
    # device memory (api._run_block_loop clamps its horizon to this)
    max_deferred_horizon = 16

    def collect_many(self, handles: list) -> list[list[FrameResult]]:
        """Deferred-collection primitive (api._run_block_loop): stack each
        pyramid level's compacted candidates ACROSS the horizon's handles
        and copy them back as single arrays -- one ``torch.stack`` and one
        device->host copy per level and slot for the whole horizon (and
        none in the hot dispatch loop). The host postprocess then runs per
        block on the prefetched buffers through the model's normal collect
        path."""
        if not handles:
            return []
        stats = {"fetch_s": 0.0, "post_s": 0.0, "orient_s": 0.0,
                 "fetch_bytes": 0}

        def fetch(tensors) -> np.ndarray:
            tf = time.perf_counter()
            arr = torch.stack(list(tensors)).cpu().numpy()
            stats["fetch_s"] += time.perf_counter() - tf
            stats["fetch_bytes"] += arr.nbytes
            return arr

        n_levels = len(handles[0][1][6])
        # arrays per level after the leading tiles entry: (sel, n_above)
        # for multiscale, (packed, counts, total, n_above) single-scale
        n_slots = len(handles[0][1][6][0]) - 1
        fetched = [[fetch(h[1][6][lv][s + 1] for h in handles)
                    for s in range(n_slots)] for lv in range(n_levels)]
        fetched_orient = (fetch(h[2] for h in handles)
                          if handles[0][2] is not None else None)
        out = []
        for i, (stacks_dev, mh, _orient_dev) in enumerate(handles):
            single_scale, b, h, w, tflag, k_budget, outs = mh
            outs_np = [(outs[lv][0], *(x[i] for x in fetched[lv]))
                       for lv in range(n_levels)]
            tp = time.perf_counter()
            batch_out, rowidx = self.model.collect_batch_device_rows(
                (single_scale, b, h, w, tflag, k_budget, outs_np))
            to = time.perf_counter()
            out.append(self._orient_results(
                stacks_dev, batch_out,
                orient=None if fetched_orient is None else fetched_orient[i],
                rowidx=rowidx))
            te = time.perf_counter()
            stats["post_s"] += to - tp
            stats["orient_s"] += te - to
        for k2, v2 in stats.items():
            self.last_collect_stats[k2] = (
                self.last_collect_stats.get(k2, 0) + v2)
        return out

    def process_block(self, block: np.ndarray) -> list[FrameResult]:
        if self.supports_async:
            return self.collect(self.process_block_async(block))
        with torch.inference_mode():
            if isinstance(block, np.ndarray):
                block = torch.from_numpy(block).to(self.device)
            stacks_dev, self._hist = _window_max_color(self._hist, block,
                                                       self.n)
        # device-resident forwards: the [T, H, W, 3] stacks are never read
        # back to host -- only compacted candidates are (vs the reference's
        # host-fetched stacks + one onnxruntime call per tile)
        batch_out = self.model.forward_batch_device(stacks_dev)
        return self._orient_results(stacks_dev, batch_out)

    def _orient_results(self, stacks_dev, batch_out: list, orient=None,
                        rowidx=None) -> list[FrameResult]:
        results = orient_results(stacks_dev, batch_out, self.num_cls,
                                 orient, rowidx)
        for pos, _ in results:
            if len(pos):
                self.result_pos = pos
        return results

    def visu(self):
        from ..visu import DrawRectVisu, SquareColorPair
        return [DrawRectVisu("results", color="orange", pair_list=[
            SquareColorPair(dot_pair=([int(x[0]), int(x[1])],
                                      [int(x[2]), int(x[3])]))
            for x in self.result_pos])]
