"""The port's recheck of one exported clip (``track/exporter.py``
``MetExporter.recheck_progress`` and ``utils.box_matching`` as of 3dfd19a):
the model's boxes on the clip's colour max-stack are matched greedily to
the clip's targets by IoU; a matched target takes its box's class of
largest probability and that probability, rounded to 3 digits, as its
``recheck_score``; a meteor's score becomes the mean of its raw score and
that one, another class's score the probability, rounded to 2 digits; a
meteor under the detection threshold, or a class outside the positive
ones, is dropped, a meteor renamed with ``Name2Label.DROPPED``'s name; an
unmatched target of a positive category is dropped with
``Name2Label.OTHERS``'s name (the port's ids and names, as they are).

The brightness and aesthetic scores the port adds to a kept target are
left out: no comparison reads them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .records import Box, MDTarget, SingleMDRecord
from .utils import Name2Label, get_id2name


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
                 tgt_seq: Sequence[Sequence[int]]) -> list[tuple[int, int]]:
    """Greedy best-IoU matching src->tgt (reference MetLib/utils.py:956-979):
    each source in turn takes the unmatched target of the largest IoU above
    0."""
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


def recheck_record(record: SingleMDRecord, bbox_list: np.ndarray,
                   score_list: np.ndarray, det_thre: float,
                   positive_cates: list, positive_cate_ids: list):
    """(the clip's kept record or None, its dropped targets, the matches
    [(box, target)]) of one clip; its targets are changed in place."""
    id2name = get_id2name()
    raw_boxes = [[*t.pt1, *t.pt2] for t in record.target]
    matched_pairs = box_matching(bbox_list, raw_boxes)
    fixed: list[MDTarget] = []
    drops: list[MDTarget] = []
    unmatched = [True] * len(record.target)
    for l, r in matched_pairs:
        label = int(np.argmax(score_list[l, :], axis=0))
        score = float(score_list[l, label])
        tgt = record.target[r]
        tgt.category = id2name.get(label, id2name[Name2Label.OTHERS()])
        tgt.raw_score = tgt.score
        tgt.recheck_score = round(score, ndigits=3)
        if label == Name2Label.METEOR:
            mge_score = (tgt.recheck_score + tgt.raw_score) / 2
        else:
            mge_score = score
        tgt.score = float(np.round(mge_score, 2))
        if ((label != Name2Label.METEOR and label in positive_cate_ids)
                or (label == Name2Label.METEOR and tgt.score >= det_thre)):
            fixed.append(tgt)
        else:
            if label == Name2Label.METEOR:
                tgt.category = id2name[Name2Label.DROPPED()]
            drops.append(tgt)
        unmatched[r] = False
    kept = (SingleMDRecord.from_target_list(fixed, record.video_size)
            if fixed else None)
    for idx, still in enumerate(unmatched):
        if not still:
            continue
        if record.target[idx].category in positive_cates:
            record.target[idx].category = id2name[Name2Label.OTHERS()]
        drops.append(record.target[idx])
    return kept, drops, matched_pairs
