"""The comparison that decides ``correct``: a call against the plain
reference over the same clip, as the numbers a cell's workload file
limits.

``output_gap`` (the widest gap) is the larger of two Hausdorff distances:

- of the per-frame outputs of the detector as the collector receives them
  (``collector.update``'s lines or boxes and their class probabilities):
  in each frame every line is paired with the nearest line on the other
  side, the gap of a pair being the largest of its end-point coordinate
  differences in px and 100 times its largest class-probability
  difference;
- of the MDRF records: every target (a meteor or another category, with
  its frames, end points, point count and score) is paired with the
  nearest target of the same category on the other side, the gap of a pair
  being the largest of its start and last-active frame differences, its
  end-point coordinate differences in px of the analysed frame (the
  records give them at the clip's size), its point-count difference and
  100 times its score difference.

Each side's distance is the largest gap of any item to its nearest
counterpart; an item with no counterpart reads ``MISSING``.

``box_gap`` judges a model's boxes, whose coordinates are truncated to
whole px and which a score threshold and a non-maximum suppression keep or
drop. It is the sum of two parts.

- The mean gap of the boxes with a counterpart, less the worst fifth
  (``TRIM``, at least one box kept): every box of either side is paired
  with its closest box of the same frame on the other side within ``NEAR``
  px, its gap being the larger of 100 times the largest class-probability
  difference and the coordinate difference beyond the 1 px that truncation
  moves. The trim is there for the suppression's choice between two tiles'
  copies of one meteor a few px apart, which rounding alone can flip.
- The widest absence (``box_missing``): every box of either side with no
  counterpart (their diagonals' orientation aside) costs 100 times how far
  its largest class probability squared (at most its objectness, which the
  threshold was applied to) lies above the threshold, so that a box one
  precision keeps and another drops at the threshold costs near 0 and a
  confident box that is missing costs far more; the part is the largest
  such cost, untrimmed. A box that the suppression could have flipped costs
  nothing: where the other side kept instead a box that overlaps it by an
  IoU above the suppression's threshold and has no counterpart on this side
  (two tiles' copies, the other one chosen), or where the other side kept a
  box that overlaps it there by more than that threshold while this side's
  counterpart of that box overlaps it by at most the threshold and by at
  least ``FLIP_IOU`` less (a suppression decided by a hair).

Records and outputs come from either package: only their values are read.

These three are built in (``BUILT_IN``). Any other number that a workload
file's ``limits`` names is a file of its own, ``comparisons/<name>.py``,
found by name as a metric is (``comparison``).
"""

from __future__ import annotations

import functools
import importlib.util
import math
import os

import numpy as np

MISSING = 10000.0
BUILT_IN = ("output_gap", "box_gap", "box_missing")
COMPARISONS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "comparisons")


def targets(records, px_scale: float = 1.0) -> list[dict]:
    """The records' targets as plain values, end points times
    ``px_scale`` (the analysed frame's width over the clip's)."""
    out = []
    for rec in records or []:
        for t in rec.target:
            out.append({
                "category": t.category, "start": int(t.start_frame),
                "last": int(t.last_activate_frame),
                "pts": [float(v) * px_scale
                        for v in list(t.pt1) + list(t.pt2)],
                "num_pts": int(t.num_pts),
                "score": float(t.score) if t.score is not None else 0.0})
    return out


def _target_gap(a: dict, b: dict) -> float:
    if a["category"] != b["category"]:
        return MISSING
    return max([abs(a["start"] - b["start"]), abs(a["last"] - b["last"]),
                abs(a["num_pts"] - b["num_pts"]),
                100.0 * abs(a["score"] - b["score"])]
               + [abs(x - y) for x, y in zip(a["pts"], b["pts"])])


def _hausdorff(xs: list, ys: list, gap) -> float:
    worst = 0.0
    for side, other in ((xs, ys), (ys, xs)):
        for a in side:
            worst = max(worst, min((gap(a, b) for b in other),
                                   default=MISSING))
    return float(worst)


def record_gap(run: list[dict], ref: list[dict]) -> float:
    """Hausdorff distance between two lists of ``targets``."""
    return _hausdorff(run, ref, _target_gap)


def frame_outputs(sink: list) -> dict:
    """{frame: [(line, probabilities), ...]} of a collector's updates, the
    frames with no line left out."""
    out: dict = {}
    for frame, lines, cates in sink:
        lines = np.asarray(lines, dtype=np.float64).reshape(-1, 4)
        if len(lines):
            cates = np.asarray(cates, dtype=np.float64).reshape(
                len(lines), -1)
            out[int(frame)] = list(zip(lines, cates))
    return out


def _line_gap(a, b) -> float:
    (la, ca), (lb, cb) = a, b
    g = float(np.abs(la - lb).max())
    if ca.shape == cb.shape and ca.size:
        g = max(g, 100.0 * float(np.abs(ca - cb).max()))
    return g


def frames_gap(run: dict, ref: dict) -> float:
    """The largest Hausdorff distance of any frame's outputs."""
    worst = 0.0
    for frame in set(run) | set(ref):
        worst = max(worst, _hausdorff(run.get(frame, []),
                                      ref.get(frame, []), _line_gap))
    return worst


def output_gap(run_targets, run_frames, ref_targets, ref_frames) -> float:
    return max(record_gap(run_targets, ref_targets),
               frames_gap(run_frames, ref_frames))


NEAR = 16.0       # px within which two boxes of a frame may be one box
TRUNCATION = 1.0  # px that truncating a coordinate moves it
TRIM = 0.2        # share of the worst boxes left out of the mean
NMS_IOU = 0.1     # the suppression's threshold across tiles and levels
FLIP_IOU = 0.03   # how far under it an overlap may lie and still flip


def box_gap(run: dict, ref: dict, score_threshold: float) -> float:
    """The trimmed mean gap of the boxes with a counterpart plus the widest
    absence (see above)."""
    gaps = []
    for side, other in ((run, ref), (ref, run)):
        for frame, items in side.items():
            near = other.get(frame, [])
            for line, probs in items:
                best = None
                for line2, probs2 in near:
                    px = float(np.abs(line - line2).max())
                    if px <= NEAR:
                        g = max(px - TRUNCATION, 0.0)
                        if probs.shape == probs2.shape and probs.size:
                            g = max(g, 100.0 * float(
                                np.abs(probs - probs2).max()))
                        best = g if best is None else min(best, g)
                if best is not None:
                    gaps.append(best)
    mean = 0.0
    if gaps:
        gaps.sort()
        keep = max(1, len(gaps) - math.ceil(len(gaps) * TRIM))
        mean = float(np.mean(gaps[:keep]))
    return mean + box_missing(run, ref, score_threshold)


def _xyxy(line) -> np.ndarray:
    return np.array([min(line[0], line[2]), min(line[1], line[3]),
                     max(line[0], line[2]), max(line[1], line[3])],
                    dtype=np.float64)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-9)


def box_missing(run: dict, ref: dict, score_threshold: float) -> float:
    """The widest absence: the largest cost of a box with no counterpart
    that the suppression could not have flipped (see above)."""
    worst = 0.0
    for side, other in ((run, ref), (ref, run)):
        for frame in set(side) | set(other):
            mine = [_xyxy(line) for line, _ in side.get(frame, [])]
            theirs = [_xyxy(line) for line, _ in other.get(frame, [])]

            def near(box, boxes):
                return [j for j, b in enumerate(boxes)
                        if np.abs(box - b).max() <= NEAR]
            for i, (box, (_, probs)) in enumerate(zip(
                    mine, side.get(frame, []))):
                if near(box, theirs):
                    continue
                flipped = False
                for c in theirs:
                    if _iou(box, c) <= NMS_IOU:
                        continue
                    here = near(c, mine)
                    if not here or any(
                            NMS_IOU - FLIP_IOU <= _iou(box, mine[k])
                            <= NMS_IOU for k in here):
                        flipped = True
                        break
                if flipped:
                    continue
                top = float(probs.max()) if probs.size else 0.0
                worst = max(worst, 100.0 * max(0.0, top * top
                                               - score_threshold))
    return float(worst)


def numbers(names, run_targets, run_frames, ref_targets, ref_frames,
            score_threshold=None) -> dict:
    """The numbers ``names`` of one call against the reference."""
    out = {}
    for name in names:
        if name == "output_gap":
            out[name] = output_gap(run_targets, run_frames, ref_targets,
                                   ref_frames)
        elif name == "box_gap":
            out[name] = box_gap(run_frames, ref_frames, score_threshold)
        elif name == "box_missing":
            out[name] = box_missing(run_frames, ref_frames, score_threshold)
        else:
            raise KeyError(f"no comparison named {name!r}")
    return out


@functools.lru_cache(maxsize=None)
def comparison(name: str):
    """``compare(call, reference, entry)`` of ``comparisons/<name>.py``,
    loaded by its path: the number ``name`` of one call (its ``records``
    and per-frame ``outputs``) against the reference's (records, stats,
    rows), as a float. KeyError for a name with no file."""
    path = os.path.join(COMPARISONS, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no comparison named {name!r}")
    spec = importlib.util.spec_from_file_location(
        "benchmark.comparisons." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.compare


def check(gaps: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} with each number's worst reading."""
    return {k: {"value": gaps[k], "limit": limits[k]} for k in limits}


def failed(gaps: dict, limits: dict) -> bool:
    return any(gaps[k] > limits[k] for k in limits)


def within(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


class Sink:
    """Wraps a collector class's ``update`` so that every call appends
    (frame, lines, probabilities) to ``self.rows`` while the sink is open;
    the wrapped method then runs as before."""

    def __init__(self, collector_cls) -> None:
        self.rows: list | None = None
        orig = collector_cls.update
        sink = self

        def update(obj, cur_frame, lines, cates, *args, **kwargs):
            if sink.rows is not None:
                sink.rows.append((cur_frame, np.array(lines),
                                  np.array(cates)))
            return orig(obj, cur_frame, lines, cates, *args, **kwargs)
        update.__wrapped__ = orig
        collector_cls.update = update

    def open(self) -> None:
        self.rows = []

    def close(self) -> list:
        rows, self.rows = self.rows or [], None
        return rows
