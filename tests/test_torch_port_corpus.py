"""PyTorch port: the hard-case corpus of ``tests/test_detection_corpus.py``
(recheck off) through the port against the JAX package, on the CPU.

Each of the corpus's six scenes (256x144, 8 s, its seeds; the jpg mask of
``masked_tower_light``) is built once with the JAX package's
``synth.generate_meteor_video``, and each package's ``detect_video`` gets
its own copy of the frames with ``m3det_normal`` as the corpus sets it up.
The port's records must equal the JAX package's exactly, scene by scene,
and on its own records the port must pass the corpus's bar: precision and
recall >= 0.8 with the corpus's ``_match``, no METEOR in the
distractor-only scenes.
"""

import cv2
import numpy as np
import pytest
import torch

from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg
from test_detection_corpus import DURATION, FPS, H, SCENARIOS, W, _match

torch.set_num_threads(2)

_RUNS: dict = {}


def _cfg(cls):
    cfg = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(scene)`` -> (JAX MDRF, port MDRF), each scene run once."""
    mask_dir = tmp_path_factory.mktemp("corpus_masks")

    def run_scene(sc):
        if sc.name not in _RUNS:
            frames = generate_meteor_video(
                width=W, height=H, fps=FPS, duration_sec=DURATION,
                meteors=sc.meteors, planes=sc.planes, clouds=sc.clouds,
                n_stars=40, noise_sigma=3.0, seed=sc.seed)
            mask_path = None
            if sc.mask:
                mask = np.full((H, W), 255, np.uint8)
                mask[:, : W // 4] = 0
                mask_path = str(mask_dir / f"{sc.name}_mask.jpg")
                cv2.imwrite(mask_path, mask)
            _RUNS[sc.name] = (
                jax_detect_video(frames.copy(), mask_path,
                                 _cfg(MainDetectCfg), work_mode="backend"),
                detect_video(frames.copy(), mask_path, _cfg(TMainDetectCfg),
                             work_mode="backend", device="cpu"))
        return _RUNS[sc.name]
    return run_scene


def _meteors(mdrf):
    return [t for rec in mdrf.results for t in rec.target
            if t.category == "METEOR"]


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_scene_records_equal_jax(run, sc):
    want, got = run(sc)
    assert ([r.to_dict() for r in got.results]
            == [r.to_dict() for r in want.results])
    assert got.performance["recovered_blocks"] == 0


def test_port_passes_the_corpus_bar(run):
    per_scene = {sc.name: _match(_meteors(run(sc)[1]), sc.meteors)
                 for sc in SCENARIOS}
    tp, fp, fn = (sum(v[i] for v in per_scene.values()) for i in range(3))
    assert tp / max(tp + fp, 1) >= 0.8, per_scene
    assert tp / max(tp + fn, 1) >= 0.8, per_scene
    assert per_scene["plane_blinking"][1] == 0, per_scene
    assert per_scene["cloud_flicker"][1] == 0, per_scene
