"""``judge.box_missing``: a box with no counterpart costs its margin over the
threshold, unless the suppression could have flipped it."""

import numpy as np
import pytest

from _cpu import ROOT  # noqa: F401  (puts the checkout on the path)

THR = 0.25


def _frames(*boxes):
    """{frame 0: [(line, probabilities)]} with top probability 0.8."""
    return {0: [(np.array(b, dtype=np.float64), np.array([0.8, 0.1, 0.0]))
                for b in boxes]}


@pytest.mark.parametrize("run, ref, expected", [
    # the same box, 3 px apart: a counterpart
    (((100, 100, 160, 140),), ((103, 100, 160, 140),), 0.0),
    # the meteor's box missing from the run
    ((), ((100, 100, 160, 140),), 100 * (0.8 * 0.8 - THR)),
    # a box far from any on the other side
    (((400, 300, 460, 340),), ((100, 100, 160, 140),),
     100 * (0.8 * 0.8 - THR)),
    # two tiles' copies of one meteor, 30 px apart: the other one kept
    (((100, 100, 190, 160),), ((130, 100, 220, 160),), 0.0),
    # kept beside a box at an overlap just under the threshold on one
    # side, suppressed by it just over on the other
    (((0, 0, 100, 100), (82, 0, 182, 100)), ((0, 0, 102, 100),), 0.0),
])
def test_box_missing(run, ref, expected):
    from benchmark import judge
    got = judge.box_missing(_frames(*run) if run else {}, _frames(*ref), THR)
    assert got == pytest.approx(expected)


def test_a_diagonal_the_other_way_is_a_counterpart():
    from benchmark import judge
    assert judge.box_missing(_frames((100, 140, 160, 100)),
                             _frames((100, 100, 160, 140)), THR) == 0.0
