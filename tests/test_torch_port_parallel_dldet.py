"""PyTorch port: ``parallel/multistream_dldet.py``,
``parallel/temporal_dldet.py`` and ``BatchPipeline(sharding=)`` against the
JAX package on the CPU, single-scale with the repository's weights on
180x320 frames (the model input shrunk to 96x96 for both packages by
``METDETPY_TPU_YOLO_HW``, as ``tests/test_torch_port_mldet.py`` does).

Tolerance (that of ``tests/test_torch_port_mldet.py``): the port runs the
network's body in bfloat16 and the JAX package in the dtype it is given,
so boxes agree within 2 px and scores within 0.03; a box may stay
unpaired only at the objectness threshold (score at most sqrt(0.25) +
0.03). Records: the same targets, categories and frames, points within
2 px, scores within 0.03. Among the port's own runs (sharded against
unsharded, streaming against whole clip) the results are equal.
"""

import numpy as np
import pytest
import torch

from metdetpy_tpu.log import get_default_logger
from metdetpy_tpu.models.pipeline import BatchPipeline as JBatchPipeline
from metdetpy_tpu.parallel import multistream_dldet as jmsd
from metdetpy_tpu.parallel import temporal_dldet as jtd
from metdetpy_tpu.parallel.dataparallel import batch_sharding as jsharding
from metdetpy_tpu.parallel.mesh import build_mesh as jax_mesh
from metdetpy_tpu.structs import DLCfg, MainDetectCfg
from metdetpy_tpu.synth import (SynthMeteor, _draw_gaussian_dot,
                                generate_meteor_video)
from metdetpy_tpu.utils import get_num_class, relative2abs_path
from metdetpy_tpu_torch import structs as ts
from metdetpy_tpu_torch.detectors.mldet import MLDetector
from metdetpy_tpu_torch.models import init_model
from metdetpy_tpu_torch.models.pipeline import BatchPipeline
from metdetpy_tpu_torch.parallel import multistream_dldet as tmsd
from metdetpy_tpu_torch.parallel import temporal_dldet as ttd
from metdetpy_tpu_torch.parallel.mesh import build_mesh, shared_mesh

torch.set_num_threads(2)

MODEL = {"name": "YOLOModel", "weight_path": "weights/yolov5s_v5.flax.npz",
         "dtype": "float32", "nms": True, "warmup": False, "pos_thre": 0.25,
         "nms_thre": 0.45, "multiscale_pred": 0, "multiscale_partition": 2}


@pytest.fixture(autouse=True)
def small_model_input(monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")


def _assert_frames_close(got, want):
    """Per frame: every box pairs with one of the other side within 2 px
    and 0.03 in every score, except boxes at the objectness threshold.
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
            left.remove(near[0])
            assert np.abs(c - wc[near[0]]).max() <= 0.03
            n += 1
        for i in left:
            assert wc[i].max() <= 0.53, (wp[i], wc[i], gp)
    return n


def _streak(img, x1, y1, dx, dy):
    for k in range(150):
        a = k / 149
        _draw_gaussian_dot(img, x1 + dx * a, y1 + dy * a,
                           200 * (1 - 0.3 * a), 1.5)


def _stream_blocks(n_streams: int, t: int) -> np.ndarray:
    """[S, T, 180, 320, 3] uint8: a bright streak in a different frame of
    each stream, over its own noise floor."""
    rng = np.random.default_rng(13)
    out = np.empty((n_streams, t, 180, 320, 3), np.uint8)
    for s in range(n_streams):
        base = rng.integers(5, 20, (180, 320)).astype(np.float32)
        for tt in range(t):
            img = base.copy()
            if tt == s % t:
                _streak(img, 50.0 + 12 * s, 35.0 + 6 * s, 150, 100)
            out[s, tt] = np.repeat(
                np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)
    return out


def test_multistream_dldet_matches_jax_and_sequential():
    """4 streams of 3 frames, two block groups (the history carries
    persist): against the JAX package's MultiStreamMLDetector on 4
    devices, and exactly against the port's own MLDetector per stream."""
    logger = get_default_logger()
    blocks = _stream_blocks(4, 3)
    mask = np.ones((180, 320, 3), np.uint8)
    args = (4, 1.0, 2.0, mask, get_num_class())
    jd = jmsd.MultiStreamMLDetector(*args, DLCfg.from_dict(
        {"model": MODEL}), logger, mesh=jax_mesh(4, axis_name="stream"))
    td = tmsd.MultiStreamMLDetector(*args, ts.DLCfg.from_dict(
        {"model": MODEL}), logger, mesh=build_mesh(4, device="cpu"),
        device="cpu")
    rev = blocks[:, ::-1].copy()
    got = [td.process_blocks(blocks), td.process_blocks(rev)]
    want = [jd.process_blocks(blocks), jd.process_blocks(rev)]
    n = 0
    for s in range(4):
        seq = MLDetector(1.0, 2.0, mask, get_num_class(), ts.DLCfg.from_dict(
            {"model": MODEL}), logger, device="cpu")
        ref = seq.process_block(blocks[s]) + seq.process_block(rev[s])
        mine = got[0][s] + got[1][s]
        for (gp, gc), (rp, rc) in zip(mine, ref):
            np.testing.assert_array_equal(gp, rp)
            np.testing.assert_array_equal(gc, rc)
        n += _assert_frames_close(mine, want[0][s] + want[1][s])
    assert n >= 4, "no stream detected its streak"


@pytest.fixture(scope="module")
def color_clip():
    """36 colour frames of 180x320 with one meteor across the frame."""
    m = SynthMeteor(start_sec=0.3, end_sec=1.2, pt1=(int(320 * .85),
                                                    int(180 * .1)),
                    pt2=(int(320 * .15), int(180 * .9)))
    return generate_meteor_video(width=320, height=180, fps=25.0,
                                 duration_sec=36 / 25.0, meteors=[m],
                                 n_stars=30, color=True, seed=3)


def _dl_cfgs():
    path = relative2abs_path("./config/dldet.json")
    out = []
    for cls in (MainDetectCfg, ts.MainDetectCfg):
        cfg = cls.from_json_file(path)
        cfg.collector.recheck_cfg.switch = False
        cfg.detector.window_sec = 0.2      # n = 5 at 25 fps
        cfg.detector.cfg.model.multiscale_pred = 0
        cfg.detector.cfg.model.warmup = False
        out.append(cfg)
    return out


def _assert_records_close(got, want):
    a_t = [t for r in got for t in r.target]
    b_t = [t for r in want for t in r.target]
    assert len(a_t) == len(b_t)
    for a, b in zip(a_t, b_t):
        assert (a.category, a.start_frame, a.last_activate_frame) == (
            b.category, b.start_frame, b.last_activate_frame)
        assert max(abs(p - q) for p, q in zip([*a.pt1, *a.pt2],
                                              [*b.pt1, *b.pt2])) <= 2
        assert abs(a.score - b.score) <= 0.03


def test_temporal_dldet_matches_jax(color_clip):
    """The whole clip over 4 shards (35 frames: padded to 36), then
    super-blocks of 16 frames with the carried tail (the last one padded):
    records against the JAX package's on 4 devices, and the port's
    streaming run equal to its whole-clip run."""
    jcfg, tcfg = _dl_cfgs()
    clip = color_clip[:35]
    kw = dict(fps=25.0)
    want, used = jtd.detect_frames_temporal_dldet(
        clip, jcfg, mesh=jax_mesh(4, "time"), **kw)
    got, used_t = ttd.detect_frames_temporal_dldet(
        clip, tcfg, mesh=build_mesh(4, device="cpu"), **kw)
    assert used == used_t == 35
    _assert_records_close(got, want)
    assert got, "the streak gave no record"

    def chunks():
        for start in range(0, 35, 10):
            yield clip[start:start + 10]
    got_st, used_st = ttd.detect_frames_temporal_dldet_streaming(
        chunks(), tcfg, mesh=build_mesh(4, device="cpu"),
        super_block_frames=16, **kw)
    assert used_st == 35
    assert [r.to_dict() for r in got_st] == [r.to_dict() for r in got]


def test_temporal_window_max_color_equals_mldetector(color_clip):
    """The sharded window-max over 3 shards, two super-blocks with the
    carry, equals MLDetector's rolling window-max block by block."""
    from metdetpy_tpu_torch.detectors.mldet import _window_max_color
    n = 5
    hist = torch.zeros((n - 1, 180, 320, 3), dtype=torch.uint8)
    carry = None
    for part in (color_clip[:18], color_clip[18:36]):
        stacks, carry = ttd.temporal_window_max_color(
            part, n, build_mesh(3, device="cpu"), carry=carry)
        want, hist = _window_max_color(hist, torch.from_numpy(part), n)
        assert len(stacks) == 1 and torch.equal(stacks[0], want)
        assert torch.equal(carry, hist)


def _photos(n: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        img = np.full((180, 320), 12.0, np.float32)
        _streak(img, rng.uniform(40, 100), rng.uniform(20, 60), 80, 50)
        out.append(np.repeat(
            np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1))
    return np.stack(out)


def test_batch_pipeline_sharded_matches_jax_and_unsharded():
    """A batch of 5 over a 2-shard CPU mesh (padded to 6): equal to the
    port's unsharded pipeline, and within the tolerance of the JAX
    package's pipeline sharded over 8 devices."""
    from metdetpy_tpu.models.yolo import YOLOModel as JYOLOModel
    model_cfg = dict(MODEL, multiscale_pred=1)
    logger = get_default_logger()
    imgs = _photos(5)
    tm = init_model(ts.ModelCfg(**model_cfg), logger, device="cpu")
    got = BatchPipeline(tm, inflight=0, sharding=shared_mesh(2, "cpu")
                        ).submit(list(range(5)), imgs)
    plain = BatchPipeline(tm, inflight=0).submit(list(range(5)), imgs)
    jm = JYOLOModel(weight_path="weights/yolov5s_v5.flax.npz",
                    dtype="float32", nms=True, warmup=False,
                    multiscale_pred=1, multiscale_partition=2,
                    logger=logger)
    want = JBatchPipeline(jm, inflight=0, sharding=jsharding(8)).submit(
        list(range(5)), imgs)
    assert [tag for tag, _ in got] == list(range(5))
    for (_, (gp, gc)), (_, (pp, pc)) in zip(got, plain):
        np.testing.assert_array_equal(gp, pp)
        np.testing.assert_array_equal(gc, pc)
    assert _assert_frames_close([r for _, r in got],
                                [r for _, r in want]) >= 3
