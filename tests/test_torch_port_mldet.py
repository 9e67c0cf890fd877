"""PyTorch port: ``detectors/mldet.py`` against the JAX package on the CPU.

Exact: ``_window_max_color``, ``_reflect101``, ``_gather_gray_rois`` and the
``ok`` flag and quadrant of ``_orient_from_packed``; its three sums to rtol
1e-4 (float32 additions in another order; atol 1e-6 x the weight total for
sums that cancel). ``MLDetector`` block by block against the JAX
``MLDetector`` (boxes within 2 px with the same diagonal orientation,
scores within 0.03; only boxes at the objectness threshold may differ), its
reset, and ``collect_many`` equal to ``collect``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.detectors import mldet as jml
from metdetpy_tpu.log import get_default_logger
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import get_num_class, relative2abs_path
from metdetpy_tpu_torch.detectors import mldet as tml
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg

torch.set_num_threads(2)

W, H = 256, 144


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [1, 2, 3, 25])
def test_window_max_color_matches_jax(n):
    rng = np.random.default_rng(n)
    hist = rng.integers(0, 255, (n - 1, 20, 30, 3), dtype=np.uint8)
    frames = rng.integers(0, 255, (8, 20, 30, 3), dtype=np.uint8)
    want = jml._window_max_color(jnp.asarray(hist), jnp.asarray(frames), n)
    got = tml._window_max_color(t(hist), t(frames), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_reflect101_matches_jax():
    idx = np.arange(-3, 40)
    for length in (1, 2, 5, 17):
        want = np.asarray(jml._reflect101(jnp.asarray(idx), length))
        got = tml._reflect101(t(idx), torch.tensor(length)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stacks():
    """[T, H, W, 3] uint8 noise with bright streaks, so ROIs have edges."""
    rng = np.random.default_rng(5)
    out = rng.integers(0, 255, (6, 120, 160, 3), dtype=np.uint8)
    for f in range(6):
        for k in range(3):
            x0, y0 = rng.integers(10, 120), rng.integers(10, 80)
            for i in range(30):
                out[f, y0 + i // (k + 1), x0 + i] = 255
    return out


def test_gather_gray_rois_matches_jax(stacks):
    rng = np.random.default_rng(6)
    ts = rng.integers(0, 6, 10).astype(np.int32)
    ys = rng.integers(0, 120 - 32, 10).astype(np.int32)
    xs = rng.integers(0, 160 - 32, 10).astype(np.int32)
    want = np.asarray(jml._gather_gray_rois(
        jnp.asarray(stacks), jnp.asarray(ts), jnp.asarray(ys),
        jnp.asarray(xs), 32))
    got = tml._gather_gray_rois(t(stacks), t(ts), t(ys), t(xs), 32)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def _packed_rows(rng, cap=64):
    """Packed kept rows (owner, x1, y1, x2, y2, obj, cls...) with boxes
    that hang over every edge, are empty, lie outside, or are too large."""
    packed = np.zeros((cap, 14), np.float32)
    packed[:, 0] = rng.integers(0, 6, cap)
    c = rng.uniform(0, 160, (cap, 2))
    wh = rng.uniform(2, 60, (cap, 2))
    packed[:, 1] = c[:, 0] - wh[:, 0] / 2
    packed[:, 2] = c[:, 1] * 0.75 - wh[:, 1] / 2
    packed[:, 3] = c[:, 0] + wh[:, 0] / 2
    packed[:, 4] = c[:, 1] * 0.75 + wh[:, 1] / 2
    packed[3, 1:5] = [-10, -5, 20, 30]
    packed[4, 1:5] = [100, 50, 100, 80]      # empty
    packed[5, 1:5] = [0, 0, 160, 120]        # larger than the window
    packed[6, 1:5] = [150, 100, 200, 140]
    packed[7, 1:5] = [-30, -30, -5, -5]      # python-slice clamp from below
    packed[40:] = 0                          # the buffer's zero tail
    return packed


def _quadrant(o):
    drct = np.arctan2(o[:, 0], o[:, 1]) % (2 * np.pi)
    return (drct // (np.pi / 2)).astype(int) % 2


@pytest.mark.parametrize("sw,sh,p", [(1.0, 1.0, 48),
                                     (160 / 96, 120 / 96, 96)])
def test_orient_from_packed_matches_jax(stacks, sw, sh, p):
    """``ok`` and the quadrant exact; the sums rtol 1e-4 (atol 1e-6 x the
    row's weight total, for circular sums that cancel)."""
    packed = _packed_rows(np.random.default_rng(7))
    want = np.asarray(jml._orient_from_packed(
        jnp.asarray(stacks), jnp.asarray(packed), jnp.float32(sw),
        jnp.float32(sh), p))
    got = tml._orient_from_packed(
        t(stacks), t(packed), float(np.float32(sw)), float(np.float32(sh)),
        p).numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    ok = want[:, 3] > 0
    assert 30 < ok.sum() < len(ok)          # both kinds of row are present
    np.testing.assert_array_equal(_quadrant(got[ok]), _quadrant(want[ok]))
    for col in range(3):
        np.testing.assert_allclose(
            got[ok, col], want[ok, col], rtol=1e-4,
            atol=1e-6 * float(want[ok, 2].max()))


# -- the detector ----------------------------------------------------------

@pytest.fixture(scope="module")
def clip():
    meteor = SynthMeteor(start_sec=0.4, end_sec=3.2,
                         pt1=(int(W * 0.7), int(H * 0.2)),
                         pt2=(int(W * 0.2), int(H * 0.8)))
    return generate_meteor_video(width=W, height=H, fps=25.0,
                                 duration_sec=3.84, meteors=[meteor],
                                 n_stars=40, noise_sigma=3.0, color=True)


def _detectors(monkeypatch, multiscale_pred):
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    path = relative2abs_path("./config/dldet.json")
    jcfg = MainDetectCfg.from_json_file(path).detector.cfg
    tcfg = TMainDetectCfg.from_json_file(path).detector.cfg
    for c in (jcfg, tcfg):
        c.model.multiscale_pred = multiscale_pred
        c.model.warmup = False
    mask = np.ones((H, W, 3), np.uint8)
    log = get_default_logger()
    jd = jml.MLDetector(0.4, 25.0, mask, get_num_class(), jcfg, log)
    td = tml.MLDetector(0.4, 25.0, mask, get_num_class(), tcfg, log,
                        device="cpu")
    assert td.n == jd.n == 10
    return jd, td


def _assert_results_close(got, want):
    """Per frame: every box pairs with one of the other side within 2 px
    (the diagonal's orientation included: y1/y2 are swapped by it) and
    0.03 in every score. A box may stay unpaired only if it sits at the
    objectness threshold, where the two bfloat16 bodies may fall on either
    side: its score sqrt(cls * obj) is then at most sqrt(0.25) + 0.03.
    Returns the number of pairs."""
    assert len(got) == len(want)
    n = 0
    for (gp, gc), (wp, wc) in zip(got, want):
        left = list(range(len(wp)))
        for p, c in zip(gp, gc):
            near = [i for i in left if np.abs(wp[i] - p).max() <= 2]
            if not near:
                assert c.max() <= 0.53, (p, c, wp)
                continue
            j = near[0]
            left.remove(j)
            assert np.abs(c - wc[j]).max() <= 0.03
            n += 1
        for i in left:
            assert wc[i].max() <= 0.53, (wp[i], wc[i], gp)
    return n


@pytest.mark.parametrize("multiscale_pred", [1, 0],
                         ids=["multiscale", "single_scale_compact"])
def test_mldetector_blocks_match_jax(monkeypatch, clip, multiscale_pred):
    """Two 16-frame blocks through both detectors: the shipped multiscale
    path (orientation from ROIs copied back) and the single-scale path
    (kept rows compacted and oriented on the device)."""
    jd, td = _detectors(monkeypatch, multiscale_pred)
    n = 0
    for b in range(32, 64, 16):
        block = clip[b:b + 16]
        jh = jd.process_block_async(block)
        th = td.process_block_async(block)
        assert (th[2] is not None) == (multiscale_pred == 0)
        np.testing.assert_array_equal(th[0].numpy(), np.asarray(jh[0]))
        np.testing.assert_array_equal(td._hist.numpy(), np.asarray(jd._hist))
        n += _assert_results_close(td.collect(th), jd.collect(jh))
    assert n >= 3
    assert td.result_pos.shape[1] == 4


def test_mldetector_reset_and_collect_many(monkeypatch, clip):
    """``collect_many`` over a horizon gives what ``collect`` gives block by
    block; ``reset_device_state`` zeroes the window history."""
    _, td = _detectors(monkeypatch, 1)
    handles = [td.process_block_async(clip[b:b + 16])
               for b in range(32, 80, 16)]
    singles = [td.collect(h) for h in handles]
    many = td.collect_many(handles)
    assert len(many) == len(singles) == 3
    for a, b in zip(many, singles):
        for (ap, ac), (bp, bc) in zip(a, b):
            np.testing.assert_array_equal(ap, bp)
            np.testing.assert_array_equal(ac, bc)
    assert sum(len(p) for blk in many for p, _ in blk) > 0
    totals, _, values = td.spans.snapshot()
    assert values["collect.fetch_bytes"] > 0 and totals["collect.post"] > 0
    assert td.collect_many([]) == []
    assert td.max_deferred_horizon == 16
    assert int(td._hist.sum()) > 0
    td.reset_device_state()
    assert int(td._hist.sum()) == 0 and tuple(td._hist.shape) == (9, H, W, 3)
    # per-frame API on top of the block path
    td.update(clip[40])
    pos, cls = td.detect()
    assert pos.shape[1] == 4 and cls.shape[1] == get_num_class()
