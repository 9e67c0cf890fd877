"""PyTorch port: the M3 detector's block step against the JAX package on
the CPU.

Both detectors start every block from the same carries (read off the JAX
``M3Detector`` and loaded into the port with ``load_state_numpy``) and get
the same frames. Exact: ``thr``, the dst block, ``valid``, ``lines[valid]``,
the diff area, the EMA value and ``thr_f``. The JAX package sums the
sub-ROI's f32 terms in XLA's order and the port sums the same integers
exactly, so the noise std could differ by f32 rounding once a frame's sum
passes 2^24 (not at these sizes); its root is correctly rounded on both
sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.detectors import m3det as jm3
from metdetpy_tpu.log import get_default_logger
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import get_detector, get_loader, resolve_device
from metdetpy_tpu_torch.detectors import m3det as tm3
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg

# the tensors here are small: two threads run them fastest and leave the
# host's other cores to the other test workers
torch.set_num_threads(2)

W, H, FPS, K = 256, 144, 25.0, 64


@pytest.fixture(scope="module")
def clip():
    meteor = SynthMeteor(start_sec=1.2, end_sec=2.6,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    return generate_meteor_video(width=W, height=H, fps=FPS,
                                 duration_sec=3.84, meteors=[meteor],
                                 n_stars=40, noise_sigma=3.0)


def _detectors(preset: str, max_points: int = 2048):
    path = relative2abs_path(f"./config/{preset}.json")
    jcfg = MainDetectCfg.from_json_file(path).detector.cfg
    tcfg = TMainDetectCfg.from_json_file(path).detector.cfg
    mask = np.ones((H, W), np.uint8)
    log = get_default_logger()
    jd = jm3.M3Detector(1.0, FPS, mask, 4, jcfg, log, max_points=max_points)
    td = tm3.M3Detector(1.0, FPS, mask, 4, tcfg, log, max_points=max_points,
                        device="cpu")
    return jd, td


def _jax_state(jd):
    return dict(gray_hist=np.asarray(jd._gray_hist),
                sub_hist=np.asarray(jd._sub_hist),
                dy_hist=np.asarray(jd._dy_hist),
                ema=[np.asarray(v) for v in jd._ema],
                timer=np.asarray(jd._timer_dev))


@pytest.mark.parametrize("preset", ["m3det_normal", "m3det_low"])
def test_block_step_matches_jax_from_shared_carries(clip, preset):
    jd, td = _detectors(preset)
    t_block = 16
    n_lines = 0
    for b in range(0, clip.shape[0], t_block):
        tm3.load_state_numpy(td, _jax_state(jd))
        block = clip[b:b + t_block]
        jp, jdst = jd.process_block_async(block)
        tp, tdst = td.process_block_async(block)
        np.testing.assert_array_equal(tdst.numpy(), np.asarray(jdst))
        jl, jv, je = jm3._unpack(np.asarray(jp), K)
        tl, tv, te = tm3._unpack(tp.numpy(), K)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tl[tv], jl[jv])
        # extras: dst_sum, npix, overflow, ema, thr_f, thr (exact at these
        # sizes, see the module docstring)
        np.testing.assert_array_equal(te, je)
        n_lines += int(jv.sum())
    assert n_lines > 0  # the meteor block produced lines on both sides
    assert td.timer == int(np.asarray(jd._timer_dev))


def test_ema_threshold_scan_matches_jax():
    """The EMA + threshold scan over warmup and steady state, adaptive and
    not, from the same stds (exact: the same f32 operations and
    contractions)."""
    rng = np.random.default_rng(7)
    n, std_interval = 25, 50
    for adaptive, (a, b) in ((True, (1.2, 3.6)), (False, (0.0, 0.0))):
        jstate = jm3.EmaState.init(1 - 2 / 60, 5.0)
        tstate = tm3.EmaState.init(1 - 2 / 60, 5.0, torch.device("cpu"))
        for timer0 in range(0, 64 * 6, 64):
            stds = rng.uniform(0.5, 12.0, 64).astype(np.float32)
            kw = dict(n=n, std_interval=std_interval, momentum=1 - 2 / 60,
                      warmup_speed=float(n), adaptive=adaptive, coef_a=a,
                      coef_b=b)
            jthr, jthr_f, jvals, jstate = jm3._ema_threshold_scan(
                jnp.asarray(stds), jnp.int32(timer0), jstate, **kw)
            tthr, tthr_f, tvals, tstate = tm3._ema_threshold_scan(
                torch.from_numpy(stds), timer0, tstate, **kw)
            np.testing.assert_array_equal(tthr.numpy(), np.asarray(jthr))
            np.testing.assert_array_equal(tthr_f.numpy(), np.asarray(jthr_f))
            np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
            assert int(tstate.t) == int(jstate.t)
            assert bool(tstate.warmup_on) == bool(jstate.warmup_on)
            np.testing.assert_array_equal(tstate.cur_momentum.numpy(),
                                          np.asarray(jstate.cur_momentum))


def test_threshold_saturates_like_xla():
    """A noise level whose threshold exceeds 255 converts to u8 as XLA's
    saturating conversion does."""
    stds = np.full(8, 40.0, np.float32)
    kw = dict(n=5, std_interval=10, momentum=0.5, warmup_speed=5.0,
              adaptive=True, coef_a=1.2, coef_b=3.6)
    jthr = jm3._ema_threshold_scan(jnp.asarray(stds), jnp.int32(0),
                                   jm3.EmaState.init(0.5, 5.0), **kw)[0]
    tthr = tm3._ema_threshold_scan(
        torch.from_numpy(stds), 0,
        tm3.EmaState.init(0.5, 5.0, torch.device("cpu")), **kw)[0]
    np.testing.assert_array_equal(tthr.numpy(), np.asarray(jthr))
    assert tthr.max() == 255


def test_load_state_numpy_checks_shapes_and_reset():
    _, td = _detectors("m3det_normal")
    state = dict(gray_hist=np.zeros((3, H, W), np.uint8),
                 sub_hist=np.zeros((24, 1, 1), np.uint8),
                 dy_hist=np.zeros((24, H, W), np.uint8),
                 ema=[0.0, 0, True, 0.9, 5.0, 5.0], timer=0)
    with pytest.raises(ValueError, match="carry shape"):
        tm3.load_state_numpy(td, state)
    td.timer = 99
    td.reset_device_state()
    assert td.timer == 0 and int(td._gray_hist.sum()) == 0


def test_registry_and_device_contract(monkeypatch):
    # every detector and every loader is ported
    for name in ("ClassicDetector", "DiffAreaGuidingDetecor", "MLDetector"):
        assert get_detector(name).__name__ == name
    for name in ("ThreadVideoLoader", "ProcessVideoLoader",
                 "VanillaVideoLoader", "BlockVideoLoader"):
        assert get_loader(name).__name__ == name
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    tcfg = TMainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json")).detector.cfg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm3.M3Detector(1.0, FPS, np.ones((H, W), np.uint8), 4, tcfg,
                       get_default_logger())


def test_noise_std_root_is_correctly_rounded():
    """The sub-ROI std is the correctly rounded f32 root, as XLA's: the
    frame whose variance is 89.953125 gives 9.484362602233887, where
    torch's vectorised f32 ``sqrt`` on the CPU gives 1 ulp less."""
    from metdetpy_tpu.ops import windows as jwin
    from metdetpy_tpu_torch.ops import windows as twin
    frames = np.ascontiguousarray(np.random.default_rng(2).integers(
        0, 40, (6, 48, 64), np.uint8)[:, 16:32, 24:40])
    hist = np.zeros((3, 16, 16), np.uint8)
    want, _ = jwin.window_noise_std(jnp.asarray(hist), jnp.asarray(frames),
                                    4, jnp.int32(0))
    got, _ = twin.window_noise_std(torch.from_numpy(hist),
                                   torch.from_numpy(frames), 4, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2].item() == np.sqrt(np.float32(89.953125)) \
        == np.float32(9.484362602233887)


ENV_32 = {"METDETPY_TPU_BLOCK_FRAMES": "32",
          "METDETPY_TPU_MAX_POINTS": "2048"}


def _frames_160(clip):
    frames = np.concatenate([clip, clip[:160 - clip.shape[0]]])
    assert frames.shape[0] == 160
    return frames


def _e2e_cfg(cls):
    c = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    c.loader.name = "BlockVideoLoader"
    c.loader.wrapper = "NumpyVideoWrapper"
    c.loader.resize = None
    c.loader.exp_time = "real-time"
    c.collector.recheck_cfg.switch = False
    return c


@pytest.fixture(scope="module")
def jax_160(clip):
    """The JAX package's MDRF of the 160-frame clip in 32-frame blocks."""
    from metdetpy_tpu.api import detect_video as jax_detect_video
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV_32.items():
            mp.setenv(k, v)
        return jax_detect_video(_frames_160(clip), None,
                                _e2e_cfg(MainDetectCfg), work_mode="backend")


@pytest.mark.parametrize("group", [1, 3, 8])
def test_collect_group_sets_the_copies_not_the_records(clip, jax_160,
                                                       monkeypatch, group):
    """``METDETPY_TPU_COLLECT_GROUP`` = 1, 3, 8 over 5 dispatched blocks of
    32 frames: ``detect_video``'s records equal the JAX package's (at its
    default group), and ``collect_many`` reads the 5 packed buffers back
    in ceil(5 / group) device->host copies."""
    from metdetpy_tpu_torch.api import detect_video

    for k, v in ENV_32.items():
        monkeypatch.setenv(k, v)
    copies, calls = [], []
    orig_many, orig_cpu = tm3.LineDetector.collect_many, torch.Tensor.cpu

    def many(self, handles):
        calls.append(len(handles))
        copies.append(0)
        return orig_many(self, handles)

    def cpu(self, *a, **k):
        if copies:
            copies[-1] += 1
        return orig_cpu(self, *a, **k)

    monkeypatch.setattr(tm3.LineDetector, "collect_many", many)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    monkeypatch.setenv("METDETPY_TPU_COLLECT_GROUP", str(group))
    got = detect_video(_frames_160(clip), None, _e2e_cfg(TMainDetectCfg),
                       work_mode="backend", device="cpu")
    monkeypatch.setattr(torch.Tensor, "cpu", orig_cpu)
    assert calls == [5]
    assert copies == [-(-5 // group)]
    assert any(t.category == "METEOR" for r in jax_160.results
               for t in r.target)
    assert [r.to_dict() for r in got.results] == \
        [r.to_dict() for r in jax_160.results]
