"""The traffic generator: the same seed gives the same clip, another seed
another one, and the scene keeps to the mix's ranges."""

import json
import os

import numpy as np
import pytest

from _cpu import ROOT, SMALL
from benchmark.traffic import sky


def _mix(name):
    with open(os.path.join(ROOT, "benchmark", "traffic", name + ".json"),
              encoding="utf-8") as f:
        p = json.load(f)
    p.update(SMALL)
    return p


@pytest.mark.parametrize("mix", ["quiet_1080p_gray_60s",
                                 "color_1080p_20s_3meteors",
                                 "busy_1080p_color_30s"])
def test_deterministic_by_seed(mix):
    p = _mix(mix)
    seed = 2**31 + 12345  # more than 32 signed bits hold
    a, = sky.make(p, seed, "cpu")
    b, = sky.make(p, seed, "cpu")
    c, = sky.make(p, seed + 1, "cpu")
    assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert (a != c).mean() > 0.5
    n = int(round(p["seconds"] * p["fps"]))
    assert a.shape[:3] == (n, p["height"], p["width"])
    if p["color"]:
        assert a.shape[3] == 3 and np.array_equal(a[..., 0], a[..., 2])


def test_scene_within_ranges():
    p = _mix("quiet_1080p_gray_60s")
    p.update(seconds=60.0, width=1920, height=1080, meteor_start_s=[2.0, 57.0])
    diag = np.hypot(1920, 1080)
    for seed in range(20):
        sc = sky.scene(p, seed)
        (m,) = sc["meteors"]
        assert 0.6 <= m["end"] - m["start"] <= 1.6
        assert 2.0 <= m["start"] and m["end"] <= 59.0
        length = np.hypot(m["pt2"][0] - m["pt1"][0], m["pt2"][1] - m["pt1"][1])
        assert 0.08 * diag <= length <= 0.25 * diag + 1e-6
        for x, y in (m["pt1"], m["pt2"]):
            assert 0 <= x < 1920 and 0 <= y < 1080


def test_meteor_is_drawn():
    p = _mix("quiet_1080p_gray_60s")
    p.update(noise_sigma=0.0, stars=0)
    clip, = sky.make(p, 5, "cpu")
    sc = sky.scene(p, 5)
    (m,) = sc["meteors"]
    t = int(np.ceil((m["start"] + m["end"]) / 2 * p["fps"]))
    assert clip[t].max() >= 150 and clip[0].max() == 12


def test_planes_are_drawn():
    p = _mix("quiet_1080p_gray_60s")
    p.update(noise_sigma=0.0, stars=0, meteors=0, planes=3,
             plane_seconds=[20.0, 60.0], plane_blink_share=0.5)
    clip, = sky.make(p, 9, "cpu")
    assert clip.max() > 100
