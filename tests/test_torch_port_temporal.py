"""PyTorch port: ``parallel/temporal.py`` and ``api.detect_video_temporal``
against the JAX package on the CPU (the JAX functions on the 8-device CPU
mesh of ``tests/conftest.py``, the port's on CPU meshes of as many
shards).

Exact: the window stats, the dst blocks, the packed buffers on every value
they define (line slots of invalid peaks zeroed on both sides first: the
port zeroes them, the JAX package does not, ``ops/hough.py``), and the
records of the batch, streaming and video entry points.
"""

import json

import numpy as np
import pytest
import torch

from metdetpy_tpu.api import detect_video_temporal as jax_detect_temporal
from metdetpy_tpu.parallel import temporal as jt
from metdetpy_tpu.parallel.mesh import build_mesh as jax_mesh
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video, write_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import structs as ts
from metdetpy_tpu_torch.__main__ import main as cli_main
from metdetpy_tpu_torch.api import detect_video_temporal
from metdetpy_tpu_torch.detectors import m3det as tm3
from metdetpy_tpu_torch.parallel import temporal as tt
from metdetpy_tpu_torch.parallel.mesh import build_mesh

torch.set_num_threads(2)

N = 6               # window frames
T = 64              # 8 shards x 8 frames
H, W = 96, 128
K = 16
ROI = (36, 48, 60, 80)
VW, VH = 256, 144   # the video of the loader tests
PARAMS = dict(n=N, roi=ROI, dy_mask=True, mask_area=H * W,
              std_interval=2 * N, momentum=1 - 2 / 60,
              warmup_speed=float(N), adaptive=True, coef_a=1.2, coef_b=3.6,
              hough_threshold=6, min_len=6, max_gap=6.0, max_points=512,
              max_peaks=K)


def masked(packed):
    p = np.array(packed, dtype=np.float32)
    valid = p[..., K * 4:K * 5] > 0.5
    lines = p[..., :K * 4].reshape(*p.shape[:-1], K, 4)
    lines[~valid] = 0
    p[..., :K * 4] = lines.reshape(*p.shape[:-1], K * 4)
    return p


@pytest.fixture(scope="module")
def clip():
    frames = generate_meteor_video(
        width=W, height=H, fps=25.0, duration_sec=T / 25.0,
        meteors=[
            SynthMeteor(0.4, 1.4, pt1=(int(W * 0.7), int(H * 0.2)),
                        pt2=(int(W * 0.4), int(H * 0.6))),
            SynthMeteor(1.2, 2.2, pt1=(int(W * 0.15), int(H * 0.75)),
                        pt2=(int(W * 0.45), int(H * 0.35))),
        ],
        n_stars=40, noise_sigma=3.0, seed=5)
    return np.asarray(frames[:T])


@pytest.fixture(scope="module")
def jax_whole(clip):
    packed, dst = jt.temporal_m3_detect(clip, mesh=jax_mesh(8, "time"),
                                        axis_name="time",
                                        init_threshold=5.0, **PARAMS)
    return masked(packed), np.asarray(dst)


def test_temporal_window_stats_match_jax(clip):
    want = jt.temporal_window_stats(clip, N, mesh=jax_mesh(8, "time"))
    got = tt.temporal_window_stats(clip, N,
                                   mesh=build_mesh(8, device="cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_temporal_m3_detect_matches_jax_and_the_block_step(clip, jax_whole):
    """The whole clip over 8 shards equals the JAX package's sharded run,
    and the port's own single-device step over the whole block (with the
    sharded programs' fold of the diff area)."""
    packed, dst = tt.temporal_m3_detect(clip, mesh=build_mesh(8, "time",
                                                              "cpu"),
                                        init_threshold=5.0, **PARAMS)
    np.testing.assert_array_equal(dst.numpy(), jax_whole[1])
    np.testing.assert_array_equal(masked(packed), jax_whole[0])
    assert (jax_whole[0][:, K * 4:K * 5] > 0.5).sum() >= 5
    r1, c1, r2, c2 = ROI
    z = torch.zeros
    ref, ref_dst, *_ = tm3._m3_block_step(
        z(N - 1, H, W, dtype=torch.uint8),
        z(N - 1, r2 - r1, c2 - c1, dtype=torch.uint8),
        z(N - 1, H, W, dtype=torch.uint8),
        tm3.EmaState.init(PARAMS["momentum"], 5.0, torch.device("cpu")),
        torch.from_numpy(clip), 0,
        **{k: v for k, v in PARAMS.items()}, sharded_fold=True)
    assert torch.equal(packed, ref) and torch.equal(dst, ref_dst)


def test_carried_super_blocks_match_jax_and_whole_clip(clip, jax_whole):
    """4 super-blocks of 16 frames over 2 shards, the carry passed on:
    equal to the JAX package's carried run and to the whole clip."""
    jmesh, tmesh = jax_mesh(2, "time"), build_mesh(2, "time", "cpu")
    jcarry = tcarry = None
    got, want, dsts = [], [], []
    for start in range(0, T, 16):
        part = clip[start:start + 16]
        jp, _, jcarry = jt.temporal_m3_detect(
            part, mesh=jmesh, axis_name="time", init_threshold=5.0,
            carry=jcarry, return_carry=True, **PARAMS)
        tp, td, tcarry = tt.temporal_m3_detect(
            part, mesh=tmesh, init_threshold=5.0, carry=tcarry,
            return_carry=True, **PARAMS)
        want.append(masked(jp))
        got.append(masked(tp))
        dsts.append(td.numpy())
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    np.testing.assert_array_equal(np.concatenate(got), jax_whole[0])
    np.testing.assert_array_equal(np.concatenate(dsts), jax_whole[1])
    assert tcarry[3] == T and tcarry[0].t == jcarry[0].t[0]


def test_shards_shorter_than_the_halo_raise(clip):
    with pytest.raises(ValueError, match="at least n-1"):
        tt.temporal_m3_detect(clip[:16], mesh=build_mesh(4, device="cpu"),
                              **PARAMS)
    with pytest.raises(ValueError, match="divide"):
        tt.temporal_window_stats(clip[:15], N,
                                 mesh=build_mesh(2, device="cpu"))


def _cfgs():
    path = relative2abs_path("./config/m3det_normal.json")
    out = []
    for cls in (MainDetectCfg, ts.MainDetectCfg):
        cfg = cls.from_json_file(path)
        cfg.detector.window_sec = N / 25.0
        cfg.detector.cfg.hough_line.threshold = PARAMS["hough_threshold"]
        cfg.detector.cfg.hough_line.min_len = PARAMS["min_len"]
        cfg.detector.cfg.hough_line.max_gap = PARAMS["max_gap"]
        cfg.collector.recheck_cfg.switch = False
        cfg.collector.meteor_cfg.min_len = 5
        cfg.collector.meteor_cfg.speed_range = [2, 60]
        out.append(cfg)
    return out


def _dicts(records):
    return [r.to_dict() for r in records]


def test_detect_frames_temporal_records_match_jax(clip):
    """The batch API and the streaming API (odd 12-frame chunks re-batched
    into 16-frame super-blocks) against the JAX package's."""
    jcfg, tcfg = _cfgs()
    kw = dict(fps=25.0, max_points=PARAMS["max_points"], max_peaks=K)
    want, used = jt.detect_frames_temporal(clip, jcfg,
                                           mesh=jax_mesh(8, "time"), **kw)
    got, used_t = tt.detect_frames_temporal(
        clip, tcfg, mesh=build_mesh(8, device="cpu"), **kw)
    assert used == used_t == T
    assert _dicts(got) == _dicts(want) and len(got) >= 1

    def chunks():
        for start in range(0, T, 12):
            yield clip[start:start + 12]
    want_st, _ = jt.detect_frames_temporal_streaming(
        chunks(), jcfg, mesh=jax_mesh(2, "time"), super_block_frames=16,
        **kw)
    got_st, used_st = tt.detect_frames_temporal_streaming(
        chunks(), tcfg, mesh=build_mesh(2, device="cpu"),
        super_block_frames=16, **kw)
    assert used_st == T
    assert _dicts(got_st) == _dicts(want_st) == _dicts(got)


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    """A 100-frame clip: two shards (or two super-blocks) of 50 frames
    each hold the 24-frame halo of m3det_normal's 25-frame window."""
    frames = generate_meteor_video(
        width=VW, height=VH, fps=25.0, duration_sec=4.0,
        meteors=[SynthMeteor(1.6, 3.2, pt1=(int(VW * 0.45), int(VH * 0.25)),
                             pt2=(int(VW * 0.30), int(VH * 0.55)))],
        n_stars=40, noise_sigma=3.0, seed=6)
    path = str(tmp_path_factory.mktemp("temporal") / "clip.avi")
    write_video(frames, path, fps=25.0)
    return path


def _video_cfgs():
    path = relative2abs_path("./config/m3det_normal.json")
    cfgs = []
    for cls in (MainDetectCfg, ts.MainDetectCfg):
        cfg = cls.from_json_file(path)
        cfg.loader.resize = VW
        cfg.loader.exp_time = "real-time"
        cfg.collector.recheck_cfg.switch = False
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope="module")
def whole_video(video_path):
    """(JAX, port) MDRFs of the whole video over 2 shards."""
    jcfg, tcfg = _video_cfgs()
    return (jax_detect_temporal(video_path, None, jcfg, n_shards=2),
            detect_video_temporal(video_path, None, tcfg, n_shards=2,
                                  device="cpu"))


def test_detect_video_temporal_matches_jax(whole_video):
    """A video file through the loader, 2 shards, m3det_normal (25-frame
    window; recheck off), the whole clip."""
    want, got = whole_video
    assert got.basic_info.to_dict() == want.basic_info.to_dict()
    assert _dicts(got.results) == _dicts(want.results)
    assert any(t.category == "METEOR" for r in got.results
               for t in r.target)


def test_cli_temporal_super_blocks_match_jax(video_path, whole_video,
                                             tmp_path):
    """``--temporal-shards 2 --temporal-super-block 2`` (two 50-frame
    super-blocks) writes the MDRF of the JAX package's super-block run,
    which is the whole-clip mode's."""
    out = tmp_path / "out.json"
    cli_main([video_path, "--mode", "backend", "--exp-time", "real-time",
              "--recheck", "off", "--resize", str(VW), "--temporal-shards",
              "2", "--temporal-super-block", "2", "--device", "cpu",
              "--save-path", str(out)])
    mdrf = json.loads(out.read_text())
    want = jax_detect_temporal(video_path, None, _video_cfgs()[0],
                               n_shards=2, super_block_sec=2.0)
    assert mdrf["type"] == "prediction"
    assert mdrf["basic_info"] == want.basic_info.to_dict()
    assert mdrf["results"] == _dicts(want.results)
    assert mdrf["results"] == _dicts(whole_video[1].results)
