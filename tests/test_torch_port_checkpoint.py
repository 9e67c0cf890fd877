"""PyTorch port's checkpoint/resume on the CPU, and its file format
against the JAX package's, both ways.

A run of the first 64-frame block writes a checkpoint; a run on the whole
clip resumes from it and must give the uninterrupted run's METEOR (start
time and box), as ``tests/test_checkpoint.py`` asks of the JAX package.
The two packages write the same keys with the same dtypes and values, and
each resumes from the other's file, for M3Detector, ClassicDetector and
(the carry alone) MLDetector.
"""

import json

import numpy as np
import pytest
import torch

from metdetpy_tpu import checkpoint as jck
from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.detectors import mldet as jml
from metdetpy_tpu.log import get_default_logger
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import get_num_class, relative2abs_path
from metdetpy_tpu_torch import checkpoint as tck
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.detectors import mldet as tml
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg

torch.set_num_threads(2)

W, H, FPS = 192, 108, 25.0


@pytest.fixture(scope="module")
def frames():
    m = SynthMeteor(start_sec=2.8, end_sec=4.8,
                    pt1=(int(W * .70), int(H * .30)),
                    pt2=(int(W * .45), int(H * .62)))
    return generate_meteor_video(width=W, height=H, fps=FPS,
                                 duration_sec=6.0, meteors=[m],
                                 n_stars=25, noise_sigma=2.5)


def _cfg(cls, detector="M3Detector"):
    cfg = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    cfg.detector.name = detector
    return cfg


def _port(frames, detector, **kw):
    return detect_video(frames.copy(), None, _cfg(TMainDetectCfg, detector),
                        work_mode="backend", device="cpu",
                        checkpoint_interval_sec=1e9, **kw)


def _jax(frames, detector, **kw):
    return jax_detect_video(frames.copy(), None, _cfg(MainDetectCfg, detector),
                            work_mode="backend", checkpoint_interval_sec=1e9,
                            **kw)


def _meteors(mdrf):
    return [(t.start_time, t.pt1, t.pt2) for r in mdrf.results
            for t in r.target if t.category == "METEOR"]


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_resume_matches_uninterrupted(frames, tmp_path, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    full = _port(frames, "M3Detector")
    assert _meteors(full)
    ckpt = str(tmp_path / "state.npz")
    _port(frames[:64], "M3Detector", checkpoint_path=ckpt)
    assert json.loads(bytes(_npz(ckpt)["__meta__"]).decode())[
        "merged_idx"] == 64
    resumed = _port(frames, "M3Detector", checkpoint_path=ckpt, resume=True)
    assert _meteors(resumed) == _meteors(full)
    # the final save holds the end of the run
    assert json.loads(bytes(_npz(ckpt)["__meta__"]).decode())[
        "merged_idx"] == frames.shape[0]


def test_periodic_checkpoint_drains_the_pipeline(frames, tmp_path,
                                                 monkeypatch):
    """With an interval of 0 every block is followed by a save of a
    drained pipeline: the run's MDRF is unchanged and the last save holds
    the whole run."""
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    ckpt = str(tmp_path / "p.npz")
    full = _port(frames, "M3Detector")
    got = detect_video(frames.copy(), None, _cfg(TMainDetectCfg),
                       work_mode="backend", device="cpu",
                       checkpoint_path=ckpt, checkpoint_interval_sec=0.0)
    assert [r.to_dict() for r in got.results] == \
        [r.to_dict() for r in full.results]
    assert got.performance["checkpoint_calls"] >= 2


@pytest.mark.parametrize("detector", ["M3Detector", "ClassicDetector"])
def test_checkpoint_files_match_jax_both_ways(frames, tmp_path, monkeypatch,
                                              detector):
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _jax(frames[:64], detector, checkpoint_path=jpath)
    _port(frames[:64], detector, checkpoint_path=tpath)
    a, b = _npz(jpath), _npz(tpath)
    assert set(a) == set(b)
    want_keys = {"__meta__", "gray_hist", "sub_hist", "dy_hist", "timer",
                 *(f"ema_{i}" for i in range(6))}
    if detector == "ClassicDetector":
        want_keys.add("classic_hist")
    assert set(a) == want_keys
    for k in a:
        if k == "__meta__":
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert json.loads(bytes(a["__meta__"]).decode()) == \
        json.loads(bytes(b["__meta__"]).decode())
    # each package resumes from the other's file
    full = _jax(frames, detector)
    from_jax = _port(frames, detector, checkpoint_path=jpath, resume=True)
    from_port = _jax(frames, detector, checkpoint_path=tpath, resume=True)
    if detector == "M3Detector":
        assert _meteors(full)
    assert _meteors(from_jax) == _meteors(from_port) == _meteors(full)
    assert [r.to_dict() for r in from_jax.results] == \
        [r.to_dict() for r in from_port.results]


def test_mldetector_carry_both_ways(monkeypatch):
    """MLDetector's window-max history: the same key and array from both
    packages after the same block, and each restores the other's."""
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    path = relative2abs_path("./config/dldet.json")
    jcfg = MainDetectCfg.from_json_file(path).detector.cfg
    tcfg = TMainDetectCfg.from_json_file(path).detector.cfg
    for c in (jcfg, tcfg):
        c.model.warmup = False
    mask = np.ones((24, 48, 3), np.uint8)
    log = get_default_logger()
    jd = jml.MLDetector(1.0, 3.0, mask, get_num_class(), jcfg, log)
    td = tml.MLDetector(1.0, 3.0, mask, get_num_class(), tcfg, log,
                        device="cpu")
    block = np.random.default_rng(0).integers(0, 255, (4, 24, 48, 3),
                                              np.uint8)
    jd.process_block(block)
    td.process_block(block)
    js, ts = jck.detector_state(jd), tck.detector_state(td)
    assert set(js) == set(ts) == {"ml_hist"}
    assert js["ml_hist"].dtype == ts["ml_hist"].dtype
    np.testing.assert_array_equal(js["ml_hist"], ts["ml_hist"])
    td.reset_device_state()
    jd.reset_device_state()
    tck.restore_detector(td, js)
    jck.restore_detector(jd, ts)
    np.testing.assert_array_equal(td._hist.numpy(), js["ml_hist"])
    np.testing.assert_array_equal(np.asarray(jd._hist), ts["ml_hist"])
    with pytest.raises(ValueError, match="ml_hist shape"):
        tck.restore_detector(td, {"ml_hist": js["ml_hist"][:, :4]})
