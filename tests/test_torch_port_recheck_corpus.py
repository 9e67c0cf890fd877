"""PyTorch port: the colour scenes of ``tests/test_recheck_corpus.py``
(recheck on, the shipped weights) through the port against the JAX
package, on the CPU.

Each of the three scenes (320x180, 8 s, its seeds) is built once with the
JAX package's ``synth.generate_meteor_video``; each package's
``detect_video`` gets its own copy of the frames (the JAX loader writes
its colour stacks into an in-memory source) with ``m3det_normal`` as the
corpus sets it up, the model at its default input size. The records must
agree as ``test_torch_port_recheck_e2e.py`` requires: records, categories
and frames equal, ``pt1``/``pt2`` within 2 px, ``score`` and
``recheck_score`` within 0.03 (the two bfloat16 bodies round
differently). The port's surviving meteors carry a recheck score.
"""

import pytest
import torch

from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.models import yolo as tyolo
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg
from test_recheck_corpus import DURATION, FPS, H, SCENARIOS, W

torch.set_num_threads(2)


def _cfg(cls):
    cfg = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = True
    return cfg


def _targets(mdrf):
    return [t for rec in mdrf.results for t in rec.target]


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_scene_records_match_jax(sc):
    frames = generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=DURATION,
        meteors=sc.meteors, planes=sc.planes, n_stars=40, noise_sigma=3.0,
        seed=sc.seed, color=True)
    want = jax_detect_video(frames.copy(), None, _cfg(MainDetectCfg),
                            work_mode="backend")
    tyolo.CALLS.clear()
    got = detect_video(frames.copy(), None, _cfg(TMainDetectCfg),
                       work_mode="backend", device="cpu")
    assert got.performance["recovered_blocks"] == 0
    assert [(r.start_frame, r.end_frame) for r in got.results] == \
        [(r.start_frame, r.end_frame) for r in want.results]
    gt, wt = _targets(got), _targets(want)
    assert len(gt) == len(wt)
    for g, w in zip(gt, wt):
        assert g.category == w.category, (g.to_dict(), w.to_dict())
        assert (g.start_frame, g.last_activate_frame) == \
            (w.start_frame, w.last_activate_frame)
        assert max(abs(a - b) for a, b in zip([*g.pt1, *g.pt2],
                                              [*w.pt1, *w.pt2])) <= 2
        assert (g.recheck_score is None) == (w.recheck_score is None)
        assert abs(g.score - w.score) <= 0.03
        if g.recheck_score is not None:
            assert abs(g.recheck_score - w.recheck_score) <= 0.03
    meteors = [t for t in gt if t.category == "METEOR"]
    assert all(t.recheck_score is not None for t in meteors)
    if sc.meteors:
        assert meteors and tyolo.CALLS["forward"] >= 1
    else:
        assert not meteors
