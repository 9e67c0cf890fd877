"""The recheck worked out again, for a configuration whose
``collector.recheck_cfg.switch`` is on: for each clip the collector
exports, the colour max-stack of the clip's merged frames, YOLOv5s over it
as the port's ``YOLOModel.forward`` runs it, and the port's matching,
fusion and demotion (``frozen/recheck.py``).

**The stack** is the port's block loader's: the analysed frames in colour
(the resize of ``preprocess.py``, no gray step), each exposure's raw
frames max-merged, then maxima over chunks of ``RECHECK_CHUNK`` (16)
merged frames; a clip of merged frames [s, e] (e the frame after its
last) takes every chunk from s // 16 to e // 16. The chunks run over the
clip's bounds by up to 15 merged frames on each side, as the port's do
(``BlockVideoLoader.recheck_stack``). Upstream MetDetPy decodes the
clip's exact bounds again (MetLib/collector.py:789-792): this is a
departure from upstream, taken so that a meteor or a plane in that slack
is seen by both sides alike. A clip with no chunk passes unchecked.

**The model** is ``dl.YOLO``'s network in float32 (TF32 off) on the
preset's tiles (``multiscale_pred`` levels, ``multiscale_partition``):
within each tile the candidates at or above ``pos_thre`` by objectness,
the 128 best, a greedy suppression at ``nms_thre``; the kept boxes scaled
to the tile, cut to whole px toward 0 and moved to the tile's place, those
under 1 px wide or high left out, each box's class probabilities
sqrt(class x objectness); then one greedy suppression over every tile's
boxes at IoU 0.1 by the largest probability, at or above ``pos_thre``.

**The margins**: each target of a rechecked clip gets ``margins``, how
near the reference's decisions on it lay to a flip (``stats["recheck"]``
lists them too):

- matched: ``iou``, its box's IoU with it (the match needs above 0);
  ``iou_runner_up``, the largest IoU of its box with another target still
  free at the box's turn (the box takes the larger); ``order``, how near
  another box came to taking it first: an earlier box by its IoU with its
  own target less its IoU with this one, a later box that overlaps it by
  the difference of their ranking probabilities (1 where there is none);
  ``suppress``, how near its box came to being suppressed, in its tile
  (by objectness, at ``nms_thre``) or across the tiles (by largest
  probability, at IoU 0.1), the nearer (``fates``: an overlapping
  candidate's lead in score, or ``nms_thre`` less their IoU); ``p1``,
  ``p2``, its box's two largest class probabilities (the class is the
  first); ``score_less_thre``, a meteor's merged score before its
  rounding, less ``det_thre`` (None for another class);
  ``box_less_thre``, its box's objectness or largest probability, the
  smaller, less ``pos_thre`` (the box exists above 0); ``others``, the
  other candidates that might have scored it in its box's place, nearest
  first (``_others``): each one's reach (its ``free`` margin through the
  suppressions, or how near it came to taking the target from the box,
  the larger), its largest probability, and whether it would decide the
  target's category alike;
- unmatched: ``unmatched``, the least change that gives it a box: over
  the candidates of every tile that overlap it, ``pos_thre`` less the
  candidate's smaller of objectness and largest probability where that is
  below ``pos_thre``, else how much more the candidate overlaps another
  target of the clip or how near it came to surviving the suppressions
  (``fates``), the larger; 1 where no candidate overlaps it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dl, preprocess
from .frozen import recheck as frozen
from .frozen.exporter import MetExporter
from .frozen.records import Box, SingleMDRecord
from .frozen.utils import Name2Label, get_id2name

RECHECK_CHUNK = 16   # merged frames a colour max-stack covers
CHUNK = 32           # raw frames resized at once, at most
OTHERS = 16          # other candidates a matched target's margins list
FAR = 0.1            # a candidate's free margin from which it is not listed


class Stacks:
    """The colour max-stacks of a clip ([N, H, W, 3] uint8), chunk by
    chunk as a clip asks for them, on ``device``."""

    def __init__(self, clip: np.ndarray, size: tuple, e: int,
                 device) -> None:
        self.clip, (self.aw, self.ah), self.e = clip, size, e
        self.device = device
        self.n_merged = clip.shape[0] // e
        self.chunks: dict = {}

    def _chunk(self, c: int):
        a, b = c * RECHECK_CHUNK, min((c + 1) * RECHECK_CHUNK, self.n_merged)
        if a >= b:
            return None
        if c not in self.chunks:
            acc = None
            step = max(1, CHUNK // self.e) * self.e
            for r in range(a * self.e, b * self.e, step):
                raw = torch.from_numpy(
                    self.clip[r:min(r + step, b * self.e)]).to(self.device)
                x = preprocess.resize_linear(raw, self.aw, self.ah).amax(0)
                acc = x if acc is None else torch.maximum(acc, x)
            self.chunks[c] = acc
        return self.chunks[c]

    def stack(self, start_frame: int, end_frame: int):
        """[H, W, 3] uint8 over raw frames [start_frame, end_frame], or
        None where no chunk covers them."""
        s, t = start_frame // self.e, end_frame // self.e
        parts = [self._chunk(c) for c in range(max(0, s // RECHECK_CHUNK),
                                                t // RECHECK_CHUNK + 1)]
        parts = [p for p in parts if p is not None]
        if not parts:
            return None
        return torch.stack(parts).amax(0)


def _xyxy(p: np.ndarray) -> np.ndarray:
    """[n, 4] float32 xywh -> xyxy as the port computes it (x2 = w + x1)."""
    b = p[:, :4].copy()
    b[:, 0] -= b[:, 2] / 2
    b[:, 1] -= b[:, 3] / 2
    b[:, 2] += b[:, 0]
    b[:, 3] += b[:, 1]
    return b


def fates(boxes: np.ndarray, scores: np.ndarray, kept: list,
          score_thre: float, nms_thre: float) -> np.ndarray:
    """How near each candidate's fate at one ``dl.nms`` came to the other
    one. A kept candidate: the least of ``nms_thre`` less its IoU with a
    kept one ranked before it, and, for one ranked after it, its lead in
    score, or, where they overlap by ``nms_thre`` or less, that lead or
    ``nms_thre`` less their IoU, the larger (either way the other takes its
    place); 1 where nothing overlaps it. A suppressed one: over the kept
    ones ranked before it that overlap it by more than ``nms_thre``, each
    one's IoU less ``nms_thre`` or its lead in score, the smaller, and of
    these the largest (each has to let it through). One under
    ``score_thre``, or past the ``dl.CANDIDATES`` best: its score's
    distance from there."""
    order = np.argsort(-scores, kind="stable")
    rank = np.empty(len(scores), int)
    rank[order] = np.arange(len(scores))
    cut = order[:dl.CANDIDATES]
    out = np.where(scores < score_thre, score_thre - scores, 0.0)
    if len(order) > dl.CANDIDATES:
        past = rank >= dl.CANDIDATES
        out[past] = np.maximum(out[past], scores[order[dl.CANDIDATES - 1]]
                               - scores[past])
    idx = cut[scores[cut] >= score_thre]
    if not len(idx):
        return out
    is_kept = np.isin(idx, kept)
    ov = np.stack([dl.iou(boxes[i], boxes[idx]) for i in idx])
    s, r = scores[idx].astype(np.float64), rank[idx]
    for a, i in enumerate(idx):
        before = r < r[a]
        if is_kept[a]:
            near = before & is_kept & (ov[a] > 0)
            m = list(nms_thre - ov[a, near])
            after = ~before & (ov[a] > 0)
            after[a] = False
            m += list(np.maximum(s[a] - s[after],
                                 np.maximum(0.0, nms_thre - ov[a, after])))
            out[i] = min(m) if m else 1.0
        else:
            by = before & is_kept & (ov[a] > nms_thre)
            if by.any():
                out[i] = np.max(np.minimum(ov[a, by] - nms_thre,
                                           s[by] - s[a]))
    return out


def _let_through(box: np.ndarray, score: float, boxes: np.ndarray,
                 scores: np.ndarray, nms_thre: float) -> float:
    """``fates``' margin of a suppressed candidate, for one that never met
    these kept boxes (it fell at an earlier suppression)."""
    if not len(boxes):
        return 0.0
    ov = dl.iou(box, boxes)
    by = (scores >= score) & (ov > nms_thre)
    return float(np.max(np.minimum(ov[by] - nms_thre, scores[by] - score))
                 ) if by.any() else 0.0


def forward(yolo: dl.YOLO, stack: torch.Tensor, nms_thre: float):
    """The model over one [H, W, 3] uint8 image, as
    ``YOLOModel.forward``: (boxes [k, 4] int, probabilities [k, nc],
    objectness [k], ``cands``). ``cands`` holds, of every candidate of
    every tile, its ``box`` [M, 4] float, ``score`` [M] (the smaller of its
    objectness and largest probability), ``prob`` and ``cls`` [M] (its
    largest probability and that class) and ``free`` [M] (the least change
    that makes it one of the boxes by the suppressions, ``fates``; 0 for
    one that is); and, of each box, its candidate ``row`` [k] and
    ``suppress`` [k], how near it came to being suppressed in its tile or
    across the tiles."""
    h, w, _ = stack.shape
    transposed, levels = dl.plan_tiles(h, w, yolo.mh, yolo.mw, yolo.levels,
                                       yolo.partition)
    x = stack.to(torch.float32) / 255.0
    if transposed:
        x = x.permute(1, 0, 2)
    pos, cls, obj, row, cand_box, cand_cls, cand_obj, first, kept1 = (
        [] for _ in range(9))
    n_rows = 0
    for tiles in levels:
        hs, ws = tiles[0][2], tiles[0][3]
        for a in range(0, len(tiles), dl.BATCH):
            part = tiles[a:a + dl.BATCH]
            preds = yolo._forward(torch.stack(
                [x[y0:y0 + hs, x0:x0 + ws] for y0, x0, _, _ in part]))
            for (y0, x0, _, _), p in zip(part, preds):
                b = _xyxy(p)
                scale = np.array([ws / yolo.mw, hs / yolo.mh] * 2, np.float32)
                off = np.array([x0, y0, x0, y0])
                cand_box.append(b * scale + off)
                cand_cls.append(np.sqrt(p[:, 5:] * p[:, 4:5]))
                cand_obj.append(p[:, 4])
                keep = dl.nms(b.astype(np.float64), p[:, 4], yolo.pos_thre,
                              nms_thre)
                first.append(fates(b.astype(np.float64), p[:, 4], keep,
                                   yolo.pos_thre, nms_thre))
                kept1.append(np.isin(np.arange(len(p)), keep))
                kb, kp = b[keep] * scale, p[keep]
                q = kb.astype(int)
                c = cand_cls[-1][keep]
                ok = (q[:, 2] - q[:, 0] >= 1) & (q[:, 3] - q[:, 1] >= 1)
                pos.append(q[ok] + off)
                cls.append(c[ok])
                obj.append(kp[ok, 4])
                row.append(n_rows + np.asarray(keep, int)[ok])
                n_rows += len(p)
    pos, cls, obj, row, cand_box, cand_cls, cand_obj, first, kept1 = (
        np.concatenate(v) for v in (pos, cls, obj, row, cand_box, cand_cls,
                                    cand_obj, first, kept1))
    prob = cand_cls.max(axis=1)
    cands = {"box": cand_box, "prob": prob, "cls": cand_cls.argmax(axis=1),
             "score": np.minimum(cand_obj, prob),
             "free": np.where(kept1, 0.0, first), "row": row[:0],
             "suppress": np.ones(0)}
    degenerate = kept1.copy()
    degenerate[row] = False
    cands["free"][degenerate] = 1.0
    # a candidate that its tile kept meets the other tiles' here; one that
    # fell there meets the boxes kept here as well
    if len(pos):
        ranked = cls.max(axis=1).astype(np.float32)
        boxes = pos.astype(np.float64)
        keep = dl.nms(boxes, ranked, yolo.pos_thre, dl.MULTISCALE_NMS_THRE)
        second = fates(boxes, ranked, keep, yolo.pos_thre,
                       dl.MULTISCALE_NMS_THRE)
        free = cands["free"]
        free[row] = second
        free[row[keep]] = 0.0
        fell = np.flatnonzero(~kept1 & (cands["score"] >= yolo.pos_thre))
        for i in fell:
            free[i] = max(free[i], _let_through(
                cand_box[i], float(cands["prob"][i]), boxes[keep],
                ranked[keep], dl.MULTISCALE_NMS_THRE))
        cands["row"] = row[keep]
        cands["suppress"] = np.minimum(second, first[row])[keep]
        pos, cls, obj = pos[keep], cls[keep], obj[keep]
    cands["free"] = np.maximum(cands["free"], yolo.pos_thre - cands["score"])
    if transposed:
        pos = pos[:, [1, 0, 3, 2]]
        cands["box"] = cand_box[:, [1, 0, 3, 2]]
    return pos, cls, obj, cands


def _box(coords) -> Box:
    return Box.from_list([int(v) for v in coords])


def margins(targets: list, boxes: np.ndarray, probs: np.ndarray,
            obj: np.ndarray, cands: dict, pairs: list, det_thre: float,
            pos_thre: float) -> list:
    """One dict of margins for each of a clip's targets (see above)."""
    tboxes = [_box([*t.pt1, *t.pt2]) for t in targets]
    kept = [_box(b) for b in boxes]
    iou = np.array([[frozen.calculate_area_iou(b, t) for t in tboxes]
                    for b in kept], np.float64).reshape(len(kept),
                                                        len(tboxes))
    rank = probs.max(axis=1) if len(probs) else np.zeros(0)
    t_xyxy = np.array([[t.x1, t.y1, t.x2, t.y2] for t in tboxes],
                      np.float64).reshape(-1, 4)
    cand = np.stack([dl.iou(t, cands["box"]) for t in t_xyxy]) if len(
        t_xyxy) else np.zeros((0, len(cands["box"])))
    box_of = {r: l for l, r in pairs}
    target_of = {l: r for l, r in pairs}
    final_of = {int(rw): k for k, rw in enumerate(cands["row"])}
    out = []
    for r, t in enumerate(targets):
        l = box_of.get(r)
        if l is not None:
            # the targets still free at its box's turn, but this one
            free = [j for j in range(len(targets))
                    if j != r and box_of.get(j, len(kept)) > l]
            runner = float(iou[l, free].max()) if free else 0.0
            # another box taking it first: an earlier one by preferring it
            # to its own target, a later one by ranking before its box
            order = [iou[k, target_of[k]] - iou[k, r] for k in range(l)
                     if iou[k, r] > 0 and k in target_of]
            order += [rank[l] - rank[k] for k in range(l + 1, len(kept))
                      if iou[k, r] > 0]
            top = np.sort(probs[l])[::-1]
            meteor = int(np.argmax(probs[l])) == Name2Label.METEOR
            # its box lost: by its IoU, to the runner-up, or suppressed
            lose = min(iou[l, r], iou[l, r] - runner, cands["suppress"][l])
            out.append({
                "iou": float(iou[l, r]), "iou_runner_up": runner,
                "order": float(min(order)) if order else 1.0,
                "suppress": float(cands["suppress"][l]),
                "p1": float(top[0]),
                "p2": float(top[1]) if len(top) > 1 else 0.0,
                "score_less_thre": ((t.recheck_score + t.raw_score) / 2
                                    - det_thre) if meteor else None,
                "box_less_thre": float(min(obj[l], probs[l].max())
                                       - pos_thre),
                "others": _others(
                    cands, cand[r], l, boxes[l], rank[l], lose, final_of,
                    iou[:, r], iou, target_of,
                    _decision(int(np.argmax(probs[l])), float(top[0]),
                              t.raw_score, det_thre),
                    t.raw_score, det_thre)})
            continue
        near = cand[r] > 0
        if not near.any():
            out.append({"unmatched": 1.0})
            continue
        other = np.delete(cand[:, near], r, axis=0)
        prefer = (np.maximum(other.max(axis=0) - cand[r, near], 0.0)
                  if len(other) else np.zeros(int(near.sum())))
        s = cands["score"][near]
        m = np.where(s < pos_thre, pos_thre - s,
                     np.maximum(prefer, cands["free"][near]))
        out.append({"unmatched": float(m.min())})
    return out


def _decision(label: int, prob: float, raw_score: float,
              det_thre: float) -> tuple:
    """What a box's class and probability make of a target: its class,
    and for a meteor whether its fused score, rounded as the recheck
    rounds it, meets ``det_thre``."""
    if label != Name2Label.METEOR:
        return label, None
    return label, float(np.round((round(prob, 3) + raw_score) / 2, 2)
                        ) >= det_thre


def _others(cands: dict, overlap: np.ndarray, l: int, box: np.ndarray,
            rank_l: float, lose: float, final_of: dict, iou_r: np.ndarray,
            iou: np.ndarray, target_of: dict, decided: tuple,
            raw_score: float, det_thre: float) -> list:
    """[reach, largest probability, alike] of the ``OTHERS`` candidates
    nearest to scoring a matched target in its box ``l``'s place, of each
    candidate that overlaps the target but ``l``'s own; ``alike`` is 1
    where it would decide the target's category as ``l`` did
    (``decided``). Its reach is the larger of its ``free`` margin and how
    near it came to taking the target from ``l``: nothing where it
    overlaps ``l`` by more than the suppression across tiles allows (it
    takes ``l``'s place); for a box before ``l``, how much more it
    overlaps its own target; else its probability's distance from ``l``'s
    or ``l`` losing the target (``lose``: by its IoU, to the runner-up, or
    suppressed itself), the nearer. A candidate whose
    ``free`` margin is ``FAR`` or more is left out: its cost would fail any
    limit alone."""
    out = []
    own = cands["row"][l]
    for c in np.flatnonzero((overlap > 0) & (cands["free"] < FAR)):
        if c == own:
            continue
        k = final_of.get(int(c))
        if dl.iou(box.astype(np.float64), cands["box"][c:c + 1])[0] > \
                dl.MULTISCALE_NMS_THRE:
            take = 0.0
        elif k is not None and k < l:
            take = (iou[k, target_of[k]] - iou_r[k]) if k in target_of \
                else 0.0
        else:
            take = min(max(0.0, rank_l - cands["prob"][c]), lose)
        alike = _decision(int(cands["cls"][c]), float(cands["prob"][c]),
                          raw_score, det_thre) == decided
        out.append([float(max(cands["free"][c], take)),
                    float(cands["prob"][c]), int(alike)])
    out.sort()
    return out[:OTHERS]


class RecheckExporter(MetExporter):
    """The frozen exporter with the recheck on: each clip of an active
    batch is rechecked on its stack, its kept targets exported as one
    record and each dropped target as a record of its own."""

    recheck = True

    def __init__(self, runtime_param, max_interval: float, det_thre: float,
                 stacks: Stacks, yolo: dl.YOLO, nms_thre: float) -> None:
        super().__init__(runtime_param, max_interval)
        self.det_thre, self.stacks, self.yolo = det_thre, stacks, yolo
        self.nms_thre = nms_thre
        self.positive_cates = list(runtime_param.positive_category_list)
        name2id = {v: k for k, v in get_id2name().items()}
        self.positive_ids = [name2id[c] for c in self.positive_cates
                             if c in name2id]
        self.stats = {"clips": 0, "unchecked": 0, "targets": []}

    def export(self, flag: str, data: list) -> None:
        if flag != self.ACTIVE_FLAG:
            super().export(flag, data)
            return
        final, drops = [], []
        for record in self._merge_clips(data):
            if record.end_frame is None:
                continue  # the port logs it and exports nothing of it
            self.stats["clips"] += 1
            stack = self.stacks.stack(record.start_frame,
                                      record.end_frame + 1)
            if stack is None:
                self.stats["unchecked"] += 1
                final.append(record)
                continue
            boxes, probs, obj, cands = forward(self.yolo, stack,
                                               self.nms_thre)
            targets = list(record.target)
            kept, dropped, pairs = frozen.recheck_record(
                record, boxes, probs, self.det_thre, self.positive_cates,
                self.positive_ids)
            for t, m in zip(targets, margins(
                    targets, boxes, probs, obj, cands, pairs, self.det_thre,
                    self.yolo.pos_thre)):
                t.margins = m
                self.stats["targets"].append(
                    {"start": t.start_frame, "last": t.last_activate_frame,
                     "category": t.category, "margins": m})
            if kept is not None:
                final.append(kept)
            drops.extend(dropped)
        for met in final:
            self.meteor_list.append(self.rescale(met))
        for t in drops:
            self.meteor_list.append(self.rescale(
                SingleMDRecord.from_target(t, self.raw_size)))
