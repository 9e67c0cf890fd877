"""PyTorch port: ``ClassicDetector`` and ``DiffAreaGuidingDetecor`` against
the JAX package on the CPU.

``_classic_block_step`` from shared carries, exact: the dst block, ``thr``,
``valid``, ``lines[valid]``, the diff sum, the pixel and overflow counts and
every carry. (The noise std's EMA and ``thr_f`` are held to rtol 1e-6 as for
the M3 step: the JAX package sums the sub-ROI's f32 terms in XLA's order.)
``DiffAreaGuidingDetecor`` is host numpy on both sides and must agree
exactly; both detectors run through ``detect_video`` against the JAX
package's MDRF.
"""

import numpy as np
import pytest
import torch

from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.detectors import m3det as jm3
from metdetpy_tpu.log import get_default_logger
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import get_detector
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.detectors import m3det as tm3
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg

torch.set_num_threads(2)

W, H, FPS, K = 256, 144, 25.0, 64


@pytest.fixture(scope="module")
def clip():
    meteor = SynthMeteor(start_sec=0.5, end_sec=2.4,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    return generate_meteor_video(width=W, height=H, fps=FPS,
                                 duration_sec=3.2, meteors=[meteor],
                                 n_stars=40, noise_sigma=3.0)


def _detectors(**kw):
    path = relative2abs_path("./config/m3det_normal.json")
    jcfg = MainDetectCfg.from_json_file(path).detector.cfg
    tcfg = TMainDetectCfg.from_json_file(path).detector.cfg
    mask = np.ones((H, W), np.uint8)
    log = get_default_logger()
    jd = jm3.ClassicDetector(1.0, FPS, mask, 4, jcfg, log, **kw)
    td = tm3.ClassicDetector(1.0, FPS, mask, 4, tcfg, log, device="cpu",
                             **kw)
    return jd, td


def _jax_state(jd):
    return dict(gray_hist=np.asarray(jd._gray_hist),
                sub_hist=np.asarray(jd._sub_hist),
                dy_hist=np.asarray(jd._dy_hist),
                classic_hist=np.asarray(jd._classic_hist),
                ema=[np.asarray(v) for v in jd._ema],
                timer=np.asarray(jd._timer_dev))


def test_classic_block_step_matches_jax_from_shared_carries(clip,
                                                            monkeypatch):
    monkeypatch.delenv("METDETPY_TPU_MAX_POINTS", raising=False)
    jd, td = _detectors()
    assert td.n == jd.n == 4 and td.max_points == jd.max_points == 8192
    n_lines = 0
    for b in range(0, clip.shape[0], 16):
        tm3.load_state_numpy(td, _jax_state(jd))
        block = clip[b:b + 16]
        jp, jdst, jstart = jd.process_block_async(block)
        tp, tdst, tstart = td.process_block_async(block)
        assert tstart == jstart == b
        np.testing.assert_array_equal(tdst.numpy(), np.asarray(jdst))
        jl, jv, je = jm3._unpack(np.asarray(jp), K)
        tl, tv, te = tm3._unpack(tp.numpy(), K)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tl[tv], jl[jv])
        # extras: dst_sum, npix, overflow, thr exact; ema, thr_f rtol 1e-6
        np.testing.assert_array_equal(te[:, [0, 1, 2, 5]], je[:, [0, 1, 2, 5]])
        np.testing.assert_allclose(te[:, 3:5], je[:, 3:5], rtol=1e-6, atol=0)
        # the carries after the step
        for name in ("_classic_hist", "_gray_hist", "_sub_hist"):
            np.testing.assert_array_equal(getattr(td, name).numpy(),
                                          np.asarray(getattr(jd, name)))
        # the collected results, warm-up blanking included
        jr = jd.collect((jp, jdst, jstart))
        tr = td.collect((tp, tdst, tstart))
        for (jl_, jc_), (tl_, tc_) in zip(jr, tr):
            np.testing.assert_array_equal(tl_, jl_)
            np.testing.assert_array_equal(tc_, jc_)
        if b == 0:
            assert all(len(r[0]) == 0 for r in tr[:3])
        n_lines += int(jv.sum())
    assert n_lines > 0
    assert td.timer == int(np.asarray(jd._timer_dev))


def test_classic_diff_sum_above_2_to_24_matches_jax():
    """Frames that light nearly every pixel (a dark frame followed by three
    bright ones: the newest pair agrees, the oldest differs): the uint32
    sum, 255 x 147,456 > 2^24 at 512x288, is rounded to f32 and scaled as
    XLA does it."""
    h, w = 288, 512
    path = relative2abs_path("./config/m3det_normal.json")
    jcfg = MainDetectCfg.from_json_file(path).detector.cfg
    tcfg = TMainDetectCfg.from_json_file(path).detector.cfg
    for c in (jcfg, tcfg):      # a fixed threshold: the level steps would
        c.binary.adaptive_bi_thre = False   # drive the adaptive one to 255
    mask = np.ones((h, w), np.uint8)
    log = get_default_logger()
    jd = jm3.ClassicDetector(1.0, FPS, mask, 4, jcfg, log, max_points=1024)
    td = tm3.ClassicDetector(1.0, FPS, mask, 4, tcfg, log, max_points=1024,
                             device="cpu")
    rng = np.random.default_rng(3)
    block = rng.integers(0, 3, (8, h, w), dtype=np.uint8)
    block[[1, 2, 3, 5, 6, 7]] += 120
    je = jm3._unpack(np.asarray(jd.process_block_async(block)[0]), K)[2]
    te = tm3._unpack(td.process_block_async(block)[0].numpy(), K)[2]
    assert je[:, 0].max() * 255 > 2 ** 24
    np.testing.assert_array_equal(te[:, [0, 1, 2]], je[:, [0, 1, 2]])


@pytest.mark.parametrize("hw,env,want", [
    ((144, 256), None, 8192), ((540, 960), None, 64800),
    ((1080, 1920), None, 65536), ((540, 960), "4096", 4096)])
def test_classic_point_budget_follows_the_frame_area(monkeypatch, hw, env,
                                                     want):
    if env is None:
        monkeypatch.delenv("METDETPY_TPU_MAX_POINTS", raising=False)
    else:
        monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", env)
    tcfg = TMainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json")).detector.cfg
    det = tm3.ClassicDetector(1.0, FPS, np.ones(hw, np.uint8), 4, tcfg,
                              get_default_logger(), device="cpu")
    assert det.max_points == want
    assert tuple(det._classic_hist.shape) == (3, *hw)
    det._classic_hist += 1
    det.reset_device_state()
    assert int(det._classic_hist.sum()) == 0
    with pytest.raises(ValueError, match="carry shape"):
        tm3.load_state_numpy(det, dict(
            gray_hist=np.zeros((3, *hw), np.uint8),
            sub_hist=np.asarray(det._sub_hist), dy_hist=np.zeros((3, *hw),
                                                                 np.uint8),
            classic_hist=np.zeros((2, *hw), np.uint8),
            ema=[0.0, 0, True, 0.9, 5.0, 5.0], timer=0))


def test_diff_area_guiding_detector_matches_jax(clip):
    log = get_default_logger()
    jd = jm3.DiffAreaGuidingDetecor(1.0, FPS, None, 4, None, log)
    td = tm3.DiffAreaGuidingDetecor(1.0, FPS, None, 4, None, log,
                                    device="cpu")
    for frame in clip[:12]:
        jd.update(frame)
        td.update(frame)
        jr, tr = jd.detect(), td.detect()
        assert tr[0].shape == jr[0].shape == (0, 4)
        assert tr[1].shape == jr[1].shape
        np.testing.assert_array_equal(td.diff_img, jd.diff_img)
        np.testing.assert_array_equal(td.bg_maintainer.cur_value,
                                      jd.bg_maintainer.cur_value)
    assert not hasattr(td, "process_block_async")
    assert len(td.process_block(clip[12:16])) == 4


def _cfg(cls, detector):
    cfg = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    cfg.detector.name = detector
    return cfg


@pytest.mark.parametrize("detector", ["ClassicDetector",
                                      "DiffAreaGuidingDetecor"])
def test_detect_video_matches_jax(clip, monkeypatch, detector):
    """The port's MDRF equals the JAX package's, record for record."""
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    want = jax_detect_video(clip.copy(), None, _cfg(MainDetectCfg, detector),
                            work_mode="backend")
    got = detect_video(clip.copy(), None, _cfg(TMainDetectCfg, detector),
                       work_mode="backend", device="cpu")
    assert ([r.to_dict() for r in got.results]
            == [r.to_dict() for r in want.results])
    assert bool(got.results) == (detector == "ClassicDetector")


def test_registry_resolves_every_detector():
    """No detector of the registry is left unported."""
    for name in ("M3Detector", "ClassicDetector", "DiffAreaGuidingDetecor",
                 "MLDetector"):
        assert get_detector(name).__name__ == name
    with pytest.raises(Exception, match="No class named"):
        get_detector("NoSuchDetector")
