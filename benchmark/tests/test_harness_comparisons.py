"""Comparisons found by name: a workload file's number beyond the built-in
three is ``comparisons/<name>.py``; the built-ins read as they did; and
``recheck_gap`` prices a changed recheck decision by the reference's
margin."""

from types import SimpleNamespace as NS

import pytest

from _cpu import ROOT  # noqa: F401  (puts the checkout on the path)


def test_a_comparison_is_found_by_name():
    from benchmark import judge
    for name in ("line_gap", "recheck_gap"):
        assert callable(judge.comparison(name))
    with pytest.raises(KeyError):
        judge.comparison("no_such_gap")


def _target(category, start, last, pt1, pt2, n, score, recheck=None,
            margins=None):
    t = NS(category=category, start_frame=start, last_activate_frame=last,
           pt1=pt1, pt2=pt2, num_pts=n, score=score, recheck_score=recheck)
    if margins is not None:
        t.margins = margins
    return t


def test_the_built_ins_read_as_before():
    """A fixed case, its values as the harness read them before
    comparisons were found by name."""
    from benchmark import judge
    run = [NS(target=[
        _target("METEOR", 10, 40, [100, 200], [300, 260], 50, 0.91),
        _target("PLANE/SATELLITE", 100, 400, [10, 20], [900, 30], 120, 0.6)])]
    ref = [NS(target=[
        _target("METEOR", 11, 40, [102, 200], [300, 262], 51, 0.9),
        _target("PLANE/SATELLITE", 100, 398, [10, 20], [900, 30], 120,
                0.62)])]
    run_rows = [(0, [[100, 100, 160, 140], [400, 300, 460, 340]],
                 [[0.8, 0.1, 0.0], [0.6, 0.3, 0.0]]),
                (25, [[10, 10, 50, 50]], [[0.5, 0.2, 0.0]])]
    ref_rows = [(0, [[103, 100, 161, 140]], [[0.78, 0.12, 0.0]]),
                (25, [[10, 12, 50, 50]], [[0.52, 0.2, 0.0]])]
    got = judge.numbers(
        ["output_gap", "box_gap", "box_missing"], judge.targets(run, 0.5),
        judge.frame_outputs(run_rows), judge.targets(ref, 0.5),
        judge.frame_outputs(ref_rows), 0.25)
    assert got == {"output_gap": 299.0, "box_gap": 13.0,
                   "box_missing": 10.999999999999998}


MATCHED = {"iou": 0.5, "iou_runner_up": 0.05, "order": 1.0, "suppress": 0.4,
           "p1": 0.8, "p2": 0.01, "score_less_thre": 0.3,
           "box_less_thre": 0.4, "others": []}


def _meteor(category="METEOR", recheck=0.8, margins=None, start=10):
    return _target(category, start, 40, [100, 200], [300, 260], 50, 0.9,
                   recheck, margins)


def _gap(run, ref):
    from benchmark.comparisons import recheck_gap
    return recheck_gap.compare(NS(records=[NS(target=run)]),
                               ([NS(target=ref)], {}, []), NS(px_scale=1.0))


def test_recheck_gap_of_the_same_records_is_0():
    assert _gap([_meteor(), _meteor("DROPPED", None, start=200)],
                [_meteor(margins=MATCHED),
                 _meteor("DROPPED", None, {"unmatched": 0.2}, start=200)]
                ) == 0.0


def test_recheck_gap_counts_the_recheck_score():
    assert _gap([_meteor(recheck=0.804)],
                [_meteor(margins=MATCHED)]) == pytest.approx(0.4)


@pytest.mark.parametrize("margin, expected", [(0.001, 0.1), (0.3, 30.0)])
def test_recheck_gap_prices_a_demotion_by_its_margin(margin, expected):
    """The program demoted a meteor that the reference kept with its merged
    score ``margin`` over the point where its rounding to 2 digits meets
    the threshold (0.005 under it)."""
    margins = dict(MATCHED, score_less_thre=margin - 0.005)
    assert _gap([_meteor("OTHERS", recheck=0.8)],
                [_meteor(margins=margins)]) == pytest.approx(expected)


def test_recheck_gap_prices_a_missing_target_by_its_margin():
    ref = [_meteor(margins=MATCHED),
           _meteor("DROPPED", None, {"unmatched": 0.07}, start=200)]
    assert _gap([_meteor()], ref) == pytest.approx(7.0)
    # a target the reference does not have has no margin to price it
    from benchmark import judge
    assert _gap([_meteor(), _meteor(start=200)],
                [_meteor(margins=MATCHED)]) == judge.MISSING


@pytest.mark.parametrize("reach, expected", [(0.003, 0.3), (0.3, 26.1)])
def test_recheck_gap_prices_a_score_from_another_box_by_its_reach(
        reach, expected):
    """One of four meteors took its ``recheck_score`` from another box than
    the reference's (0.513 against 0.774), a candidate of the reference's
    with that probability ``reach`` from scoring it: the trim does not hide
    the pair, the candidate's reach prices it, and where that is more than
    the whole difference, the difference."""
    others = [[reach, 0.513, 1], [0.001, 0.9, 0]]
    ref = [_meteor(margins=dict(MATCHED, others=others), recheck=0.774)]
    ref += [_meteor(margins=MATCHED, start=s) for s in (100, 200, 300)]
    run = [_meteor(recheck=0.513)] + [_meteor(start=s)
                                      for s in (100, 200, 300)]
    assert _gap(run, ref) == pytest.approx(expected)


def test_recheck_gap_prices_a_flip_by_another_candidate_s_reach():
    """The program demoted a meteor that a candidate deciding otherwise
    came 0.002 from scoring in the reference."""
    margins = dict(MATCHED, others=[[0.002, 0.3, 0], [0.001, 0.8, 1]])
    assert _gap([_meteor("OTHERS", recheck=0.3)],
                [_meteor(margins=margins)]) == pytest.approx(0.2)


@pytest.mark.parametrize("program, expected", [
    (("DROPPED", None), 0.3), (("PLANE", 0.81), 50.0)])
def test_recheck_gap_prices_a_flip_by_the_routes_to_it(program, expected):
    """The reference's box survived a suppression by 0.003: losing it
    leaves the target unchecked (0.3), but does not give it another class,
    which costs the class's lead of 0.5 (the fused score clears the
    threshold by more)."""
    margins = dict(MATCHED, suppress=0.003, p2=0.3, score_less_thre=0.6)
    category, recheck = program
    assert _gap([_meteor(category, recheck)],
                [_meteor(margins=margins)]) == pytest.approx(expected)


def test_a_draft_recheck_cell_runs_with_only_new_files(tmp_path):
    """A recheck cell's configuration and workload file, written outside
    the checkout and handed to ``cell.Run`` with a ``BENCHMARK.json`` that
    names them, run with the benchmark's files as they are."""
    import time
    from _cpu import DRAFT_SMALL, MODEL_HW, SEED, draft
    from benchmark import cell
    name, b = draft(str(tmp_path))
    run = cell.Run(name, SEED, 0, False, "cpu", time.time(), bench=b,
                   traffic=DRAFT_SMALL, model_hw=MODEL_HW)
    out = run.execute()
    assert out["correct"] is True
    assert set(out["checks"]) == {"line_gap", "recheck_gap"}
    assert run.ref_stats["recheck"]["clips"] >= 1
    assert any("margins" in t for t in run.ref_stats["recheck"]["targets"])


def test_fates_give_each_candidate_its_suppression_margin():
    """A kept box 0.01 ahead of the one it suppressed (IoU 0.82 over 0.45):
    both are 0.01 from trading places; a box that nothing overlaps is 1
    away; one under the score threshold its distance from it."""
    import numpy as np
    from benchmark.reference import dl, recheck
    boxes = np.array([[0, 0, 10, 10], [1, 0, 11, 10], [20, 20, 30, 30],
                      [40, 40, 50, 50]], np.float64)
    scores = np.array([0.9, 0.89, 0.5, 0.1], np.float32)
    kept = dl.nms(boxes, scores, 0.25, 0.45)
    assert kept == [0, 2]
    assert recheck.fates(boxes, scores, kept, 0.25, 0.45) == pytest.approx(
        [0.01, 0.01, 1.0, 0.15], abs=1e-6)
