"""PyTorch port: the stream axis of the window ops and of the M3 step,
``parallel/mesh.py``, ``parallel/multistream.py`` and
``parallel/dataparallel.py``'s helpers against the JAX package on the CPU
(its parallel functions on the 8-device CPU mesh of ``tests/conftest.py``,
the port's on an 8-shard CPU mesh), and the two small ops of this slice.

Exact throughout. The packed buffers are compared on every value they
define: the port zeroes the line slots of invalid peaks (``valid`` is 0)
where the JAX package leaves whatever its segment walk produced, so those
slots are zeroed on both sides first (``ops/hough.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.log import BaseMetLog
from metdetpy_tpu.ops import filters as jfilters
from metdetpy_tpu.ops import hough as jhough
from metdetpy_tpu.parallel.mesh import build_mesh as jax_mesh
from metdetpy_tpu.parallel import multistream as jms
from metdetpy_tpu.structs import (BinaryCfg, BinaryCoreCfg, DynamicCfg,
                                  HoughLineCfg, MainDetectCfg,
                                  RuntimeParams)
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import structs as ts
from metdetpy_tpu_torch.detectors import m3det as tm3
from metdetpy_tpu_torch.ops import filters, hough, kernels, windows
from metdetpy_tpu_torch.parallel import dataparallel, mesh
from metdetpy_tpu_torch.parallel import multistream as tms

torch.set_num_threads(2)

S, W, H, FPS, K = 8, 96, 64, 25.0, 16
N_WIN = 8   # window_sec 0.32 at 25 fps


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def masked(packed, k=K):
    """The packed buffer with the line slots of invalid peaks zeroed."""
    p = np.array(packed, dtype=np.float32)
    valid = p[..., k * 4:k * 5] > 0.5
    lines = p[..., :k * 4].reshape(*p.shape[:-1], k, 4)
    lines[~valid] = 0
    p[..., :k * 4] = lines.reshape(*p.shape[:-1], k * 4)
    return p


# -- the stream axis of the window ops -------------------------------------

@pytest.mark.parametrize("n,timer0,step", [(1, 0, 0), (4, 0, 0), (4, 2, 5),
                                           (9, 0, 6), (9, 30, 0)])
def test_window_ops_stream_axis_equal_single_streams(n, timer0, step):
    """[S, T, H, W] with history [S, n-1, H, W] equals S single-stream
    calls, stream s starting at timer0 + s * step (T=6 < n-1=8 in the
    n=9 cases)."""
    rng = np.random.default_rng(n + timer0)
    s, tb = 3, 6
    hist = rng.integers(0, 256, (s, n - 1, 12, 20), dtype=np.uint8)
    frames = rng.integers(0, 256, (s, tb, 12, 20), dtype=np.uint8)
    diff, new_hist = kernels.window_diff(t(hist), t(frames), n, timer0, step)
    stats, _ = windows.window_stats(t(hist), t(frames), n, timer0, step)
    stds, new_sub = windows.window_noise_std(t(hist), t(frames), n, timer0,
                                             step)
    sums, new_dy = windows.rolling_sum_u32(t(hist), t(frames), n)
    for i in range(s):
        tim = timer0 + i * step
        d1, h1 = kernels.window_diff_plain(t(hist[i]), t(frames[i]), n, tim)
        st1, _ = windows.window_stats(t(hist[i]), t(frames[i]), n, tim)
        sd1, _ = windows.window_noise_std(t(hist[i]), t(frames[i]), n, tim)
        su1, _ = windows.rolling_sum_u32(t(hist[i]), t(frames[i]), n)
        assert torch.equal(diff[i], d1) and torch.equal(new_hist[i], h1)
        for a, b in zip(stats, st1):
            assert torch.equal(a[i], b)
        assert torch.equal(stds[i], sd1) and torch.equal(sums[i], su1)
        assert torch.equal(new_sub[i], h1) and torch.equal(new_dy[i], h1)


def test_ema_scan_stream_axis_equals_single_streams():
    rng = np.random.default_rng(3)
    stds = t(rng.uniform(0.5, 4.0, (4, 40)).astype(np.float32))
    stds[1, :7] = 0.0   # a stream whose EMA stays 0 at first
    kw = dict(n=6, std_interval=12, momentum=1 - 2 / 60, warmup_speed=6.0,
              coef_a=1.2, coef_b=3.6)
    for adaptive in (True, False):
        st = tm3.EmaState.init(1 - 2 / 60, 5.0, torch.device("cpu"), (4,))
        got = tm3._ema_threshold_scan(stds, 0, st, adaptive=adaptive, **kw)
        for i in range(4):
            st1 = tm3.EmaState.init(1 - 2 / 60, 5.0, torch.device("cpu"))
            want = tm3._ema_threshold_scan(stds[i], 0, st1,
                                           adaptive=adaptive, **kw)
            for g, w in zip(got[:3], want[:3]):
                assert torch.equal(g[i], w)
            for f in ("cur_value", "bi_threshold", "bi_thr_float"):
                assert torch.equal(getattr(got[3], f)[i],
                                   getattr(want[3], f))
            assert (got[3].t, got[3].warmup_on, got[3].cur_momentum) == (
                want[3].t, want[3].warmup_on, want[3].cur_momentum)


# -- the M3 step and the multi-stream detector -------------------------------

CFG = dict(binary=dict(adaptive_bi_thre=True, init_value=5,
                       sensitivity="normal", area=0.1, interval=2),
           hough_line=dict(threshold=10, min_len=10, max_gap=10),
           dynamic=dict(dy_mask=True, window_sec=5))


def _cfgs():
    jcfg = BinaryCfg(binary=BinaryCoreCfg(**CFG["binary"]),
                     hough_line=HoughLineCfg(**CFG["hough_line"]),
                     dynamic=DynamicCfg(**CFG["dynamic"]))
    tcfg = ts.BinaryCfg(binary=ts.BinaryCoreCfg(**CFG["binary"]),
                        hough_line=ts.HoughLineCfg(**CFG["hough_line"]),
                        dynamic=ts.DynamicCfg(**CFG["dynamic"]))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def streams():
    """[S, 48, H, W]: meteors in streams 1, 3 and 6 at different times."""
    out = []
    for s in range(S):
        meteors = ([SynthMeteor(0.2 + 0.3 * (s % 3), 1.2 + 0.3 * (s % 3),
                                (int(W * .8), int(H * .2)),
                                (int(W * .2), int(H * .8)))]
                   if s in (1, 3, 6) else [])
        out.append(generate_meteor_video(
            width=W, height=H, fps=FPS, duration_sec=48 / FPS,
            meteors=meteors, n_stars=10, noise_sigma=2.5, seed=100 + s))
    return np.stack(out)


def test_block_step_streams_equal_single_streams(streams):
    """The batched step's rows equal each stream's own single-stream step,
    bit for bit with the same fold of the diff area; with the other fold
    only the diff area may differ, in its last two bits."""
    _, tcfg = _cfgs()
    det = tm3.M3Detector(N_WIN / FPS, FPS, np.ones((H, W), np.uint8), 9,
                         tcfg, BaseMetLog(), max_points=1024, max_peaks=K,
                         device="cpu")
    kw = det._step_static_kwargs()
    r1, c1, r2, c2 = det.std_roi
    cpu = torch.device("cpu")
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.uint8)  # noqa: E731
    s = 3
    batched = [zeros(s, N_WIN - 1, H, W), zeros(s, N_WIN - 1, r2 - r1,
               c2 - c1), zeros(s, N_WIN - 1, H, W),
               tm3.EmaState.init(kw["momentum"], 5.0, cpu, (s,))]
    singles = [[zeros(N_WIN - 1, H, W), zeros(N_WIN - 1, r2 - r1, c2 - c1),
                zeros(N_WIN - 1, H, W),
                tm3.EmaState.init(kw["momentum"], 5.0, cpu)]
               for _ in range(s)]
    for b, fold in ((0, True), (16, False)):
        block = t(streams[:s, b:b + 16])
        packed, _, *batched = tm3._m3_block_step(
            *batched, block, b, **kw, sharded_fold=fold)
        for i in range(s):
            want, _, *singles[i] = tm3._m3_block_step(
                *singles[i], block[i], b, **kw, sharded_fold=True)
            if fold:
                assert torch.equal(packed[i], want)
            else:
                area = K * 5
                keep = [c for c in range(want.shape[1]) if c != area]
                assert torch.equal(packed[i][:, keep], want[:, keep])
                np.testing.assert_array_max_ulp(
                    packed[i][:, area].numpy(), want[:, area].numpy(), 2)


def test_multistream_detector_matches_jax(streams):
    """Two block groups, so the per-stream carries persist; 8 streams on
    the JAX package's 8 devices and on the port's 8 CPU shards."""
    jcfg, tcfg = _cfgs()
    args = (S, N_WIN / FPS, FPS, np.ones((H, W), np.uint8), 9)
    jd = jms.MultiStreamM3Detector(*args, jcfg, BaseMetLog(),
                                   mesh=jax_mesh(S, axis_name="stream"),
                                   max_points=1024, max_peaks=K)
    td = tms.MultiStreamM3Detector(*args, tcfg, BaseMetLog(),
                                   mesh=mesh.build_mesh(S, device="cpu"),
                                   max_points=1024, max_peaks=K,
                                   device="cpu")
    n_valid = 0
    for b in (0, 24):
        blocks = streams[:, b:b + 24].copy()
        want = masked(jd.process_blocks_async(blocks))
        got = masked(np.concatenate(
            [p.numpy() for p in td.process_blocks_async(blocks)]))
        np.testing.assert_array_equal(got, want)
        n_valid += int((want[..., K * 4:K * 5] > 0.5).sum())
    assert td.timer == 48 and n_valid > 10


def _main_cfgs():
    path = relative2abs_path("./config/m3det_normal.json")
    cfgs = (MainDetectCfg.from_json_file(path),
            ts.MainDetectCfg.from_json_file(path))
    for c in cfgs:
        c.detector.window_sec = N_WIN / FPS
        c.detector.cfg.hough_line.threshold = 10
        c.detector.cfg.hough_line.min_len = 10
        c.collector.recheck_cfg.switch = False
        c.collector.meteor_cfg.min_len = 5
        c.collector.meteor_cfg.speed_range = [2, 60]
    return cfgs


def test_detect_multi_stream_records_match_jax(streams):
    jcfg, tcfg = _main_cfgs()
    rt = dict(fps=FPS, exp_frame=1, eq_fps=FPS, eq_int_fps=int(FPS),
              exp_time=1 / FPS, runtime_size=[W, H], raw_size=[W, H],
              positive_category_list=["METEOR"])
    frames = list(streams)
    want = jms.detect_multi_stream(
        frames, jcfg, RuntimeParams(**rt), BaseMetLog(),
        mesh=jax_mesh(S, axis_name="stream"), block_frames=16,
        max_points=1024, max_peaks=K)
    got = tms.detect_multi_stream(
        frames, tcfg, ts.RuntimeParams(**rt), BaseMetLog(),
        mesh=mesh.build_mesh(S, device="cpu"), block_frames=16,
        max_points=1024, max_peaks=K, device="cpu")
    assert [[r.to_dict() for r in rs] for rs in got] == \
        [[r.to_dict() for r in rs] for rs in want]
    assert sum(len(rs) for rs in got) >= 2


# -- meshes ----------------------------------------------------------------

def test_build_mesh_needs_enough_cards(monkeypatch):
    """On ``cuda`` the mesh takes the first n cards, and raises as the JAX
    package does where there are fewer (the count is monkeypatched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mesh.build_mesh(2, axis_name="time")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        dataparallel.batch_sharding(2)
    one = mesh.build_mesh(axis_name="time")
    assert one.devices == (torch.device("cuda", 0),) and one.size == 1
    assert one.axis_name == "time"


def test_mesh_groups_and_split_leading():
    cpu, meta = torch.device("cpu"), torch.device("meta")
    m = mesh.DeviceMesh((cpu, cpu, meta, meta, cpu))
    assert m.size == 5
    assert m.groups() == [(cpu, 0, 2), (meta, 2, 4), (cpu, 4, 5)]
    parts = mesh.split_leading(np.arange(10 * 3).reshape(10, 3), m)
    assert [tuple(p.shape) for p in parts] == [(4, 3), (4, 3), (2, 3)]
    assert [p.device for p in parts] == [cpu, meta, cpu]
    assert parts[2].tolist() == [[24, 25, 26], [27, 28, 29]]
    with pytest.raises(ValueError, match="does not divide"):
        mesh.split_leading(np.zeros((7, 2)), m)
    shared = mesh.shared_mesh(4, "cpu")
    assert shared.groups() == [(cpu, 0, 4)]
    assert mesh.build_mesh(3, device="cpu") == mesh.DeviceMesh((cpu,) * 3)


def test_put_batch_sharded_pads_with_the_last_image():
    imgs = np.arange(5 * 2 * 2 * 3, dtype=np.uint8).reshape(5, 2, 2, 3)
    parts, n_real = dataparallel.put_batch_sharded(
        imgs, mesh.shared_mesh(4, "cpu"))
    assert n_real == 5 and len(parts) == 1 and parts[0].shape[0] == 8
    np.testing.assert_array_equal(parts[0][:5].numpy(), imgs)
    for row in parts[0][5:]:
        np.testing.assert_array_equal(row.numpy(), imgs[-1])


# -- two ops of the JAX package the port lacked ------------------------------

def test_open3x3_matches_jax():
    rng = np.random.default_rng(11)
    img = (rng.random((3, 17, 23)) < 0.4).astype(np.uint8) * 255
    img[:, 5:9, 6:12] = 255
    want = np.asarray(jfilters.open3x3(jnp.asarray(img)))
    got = filters.open3x3(t(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < img.sum()


@pytest.mark.parametrize("gap", [10.0, 2.0])
def test_hough_lines_single_matches_jax(gap):
    img = np.zeros((64, 96), np.uint8)
    for x in range(10, 80):
        y = 8 + (x - 10) * 40 // 70
        if not 40 <= x < 44:       # a 4-px gap: bridged at 10, not at 2
            img[y, x] = 255
    want = jhough.hough_lines_single(jnp.asarray(img), gap, threshold=10,
                                     min_len=10, max_points=512,
                                     max_peaks=K)
    got = hough.hough_lines_single(t(img), gap, threshold=10, min_len=10,
                                   max_points=512, max_peaks=K)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.lines.numpy()[valid],
                                  np.asarray(want.lines)[valid])
    np.testing.assert_array_equal(got.npix.numpy(), np.asarray(want.npix))
    assert valid.any()
