"""``recheck_gap``: the records of a run with the recheck on against the
reference's, a changed decision priced by how near the reference's lay to
it.

Targets pair by what M3 gave them, which the recheck does not change: each
target of either side is paired with the target of the other side of the
least M3 gap (the largest of its start and last-active frame differences,
its end-point coordinate differences in px of the analysed frame and its
point-count difference). One whose least M3 gap is over ``NEAR`` has no
counterpart.

- A pair whose targets have one category and were both rechecked, or both
  not, agrees. The two sides may have scored it from one box or from two
  (a suppression or a match decided by a hair): a rechecked pair's gap is
  its M3 gap or ``score_gap``, the larger: 100 times the least gap that
  explains the program's ``recheck_score``, from the reference's box by
  their difference, or from another candidate that decides the category
  alike by its reach (how near it came to scoring the target,
  ``reference.recheck``) or its difference, the larger. A score taken
  from another box by a hair costs its difference from that box; one
  that no near candidate explains costs its whole difference. (That
  score is rounded to 3 digits; the fused score is not compared: it is
  rounded to 2, and its rounding alone can move it by 0.01.)
- A pair whose categories differ, or which one side rechecked and the
  other did not, costs its M3 gap or 100 times the smallest of the
  reference target's margins by which the program's side can have come
  to its decision (``smallest_margin``), the larger; so does a reference
  target with no counterpart, by any of its margins. A decision the reference
  made by a hair costs near 0, a confident one that flipped costs much.
  The fused score meets ``det_thre`` after its rounding to 2 digits, so
  its margin is taken from half a step under the threshold
  (``ROUNDING``). A program's target with no counterpart, or a reference
  target without margins (its clip passed unchecked), costs
  ``judge.MISSING``.

The number is the mean gap of the rechecked pairs that agree, each taken
once from its reference target, less the worst fifth (``TRIM``; at least
one kept), plus the largest of the costs of a changed decision, the M3
gaps of the other pairs and the gaps that the trim left out: untrimmed,
as ``judge.box_gap``'s widest absence, so that no pair goes unpriced. The
unrechecked pairs stay out of the mean, which they would only dilute:
their gap is M3's, which ``line_gap`` judges per frame. The readings it
was set from are in PERF.md.
"""

from __future__ import annotations

import math

from benchmark import judge

NEAR = 16.0       # frames, px or points within which two targets are one
TRIM = 0.2        # share of the worst agreeing pairs left out of the mean
ROUNDING = 0.005  # the fused score's rounding to 2 digits, half a step


def targets(records, px_scale: float = 1.0) -> list[dict]:
    """``judge.targets`` with each target's ``raw_score`` and
    ``recheck_score`` and, on the reference's, its ``margins``."""
    out = judge.targets(records, px_scale)
    for plain, t in zip(out, [t for rec in records or []
                              for t in rec.target]):
        plain["raw_score"] = getattr(t, "raw_score", None)
        plain["recheck_score"] = getattr(t, "recheck_score", None)
        plain["margins"] = getattr(t, "margins", None)
    return out


def m3_gap(a: dict, b: dict) -> float:
    return float(max([abs(a["start"] - b["start"]),
                      abs(a["last"] - b["last"]),
                      abs(a["num_pts"] - b["num_pts"])]
                     + [abs(x - y) for x, y in zip(a["pts"], b["pts"])]))


def smallest_margin(m: dict, rescored: bool | None = None) -> float:
    """The least of a reference target's margins (``reference.recheck``)
    by which the other side can have come to its target: where it was
    rechecked (``rescored``) and decided otherwise, by its box's class,
    the fused score's threshold or another candidate that decides
    otherwise; where it was not, by the box lost (its IoU, the runner-up,
    another box first, a suppression, ``pos_thre``); where the other side
    has no such target (None), by either."""
    if "unmatched" in m:
        return max(0.0, m["unmatched"])
    lost = [m["iou"], m["iou"] - m["iou_runner_up"], m["order"],
            m["suppress"], m["box_less_thre"]]
    other = [m["p1"] - m["p2"]]
    other += [reach for reach, _, alike in m["others"] if not alike]
    if m["score_less_thre"] is not None:
        other.append(abs(m["score_less_thre"] + ROUNDING))
    parts = {True: other, False: lost, None: lost + other}[rescored]
    return max(0.0, min(parts))


def score_gap(score: float, m: dict | None, ref_score: float) -> float:
    """100 times the least gap that explains a ``recheck_score`` of the
    program's: from the reference's box, its difference from the
    reference's; from another candidate that decides alike, that
    candidate's reach or its difference, the larger."""
    d = abs(score - ref_score)
    for reach, prob, alike in (m or {}).get("others", []):
        if alike:
            d = min(d, max(reach, abs(score - prob)))
    return 100.0 * d


def _cost(ref_target: dict, rescored: bool | None = None) -> float:
    m = ref_target["margins"]
    return (judge.MISSING if m is None
            else 100.0 * smallest_margin(m, rescored))


def gap(run: list[dict], ref: list[dict]) -> float:
    """The number of two lists of ``targets`` (see above)."""
    agree, flips = [], [0.0]
    for side, other, is_ref in ((run, ref, False), (ref, run, True)):
        for a in side:
            b = min(other, key=lambda o: m3_gap(a, o), default=None)
            if b is None or m3_gap(a, b) > NEAR:
                flips.append(_cost(a) if is_ref else judge.MISSING)
                continue
            g = m3_gap(a, b)
            rescored = a["recheck_score"] is not None
            if (a["category"] == b["category"]
                    and rescored == (b["recheck_score"] is not None)):
                if rescored and is_ref:
                    agree.append(max(g, score_gap(
                        b["recheck_score"], a["margins"],
                        a["recheck_score"])))
                else:
                    flips.append(g)
            elif is_ref:
                flips.append(max(g, _cost(a, b["recheck_score"] is not None)))
            else:
                flips.append(max(g, _cost(b, rescored)))
    mean = 0.0
    if agree:
        agree.sort()
        keep = max(1, len(agree) - math.ceil(len(agree) * TRIM))
        mean = sum(agree[:keep]) / keep
        flips += agree[keep:]
    return mean + max(flips)


def compare(call, reference, entry) -> float:
    return gap(targets(call.records, entry.px_scale),
               targets(reference[0], entry.px_scale))
