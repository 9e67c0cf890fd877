"""PyTorch port: the multistream M3 step and the Classic step through
``detectors/step_graph.py::StepGraph`` on the CPU.

On a card ``MultiStreamM3Detector`` replays one CUDA graph of
``_m3_block_step`` per device group a block, and ``ClassicDetector`` one of
``_classic_block_step``; on the CPU the multistream detector runs the same
``StepGraph``, whose body is the step on the graph's buffers with each new
carry copied back (the gray history, a strided view of the frames buffer
where n-1 <= T, too). Held here:

- the detector's packed rows equal the functional step's bit for bit and
  the JAX package's ``MultiStreamM3Detector`` (8-device CPU mesh of
  ``tests/conftest.py``) on every value they define, for S = 2 and 8 and
  the history within and beyond the block;
- a mesh whose shards lie on two device names (``cpu`` and ``cpu:0``,
  which compare unequal) has one ``StepGraph`` a device group and gives
  the one-device mesh's results;
- the carries are the graph's buffers (their storage never moves) and
  the handles of earlier blocks keep their values;
- a dropped detector's graph is adopted by the next one of its shapes,
  also across two ``detect_multi_stream`` calls;
- ``StepGraph`` over a ``ClassicDetector``'s carries (its ``_replay``, the
  card's path) equals the functional step through the 4-frame warm-up and
  after ``reset_device_state``;
- ``detect_multi_stream``'s records equal the JAX package's with the
  history beyond the block (``tests/test_torch_port_parallel.py`` holds
  them within it, ``tests/test_torch_port_classic.py`` ClassicDetector's
  ``detect_video``).

The line slots of invalid peaks are zeroed on both sides before a
comparison with the JAX package (the port zeroes them, JAX does not).
"""

import gc

import numpy as np
import pytest
import torch

from metdetpy_tpu.log import BaseMetLog
from metdetpy_tpu.parallel import multistream as jms
from metdetpy_tpu.parallel.mesh import build_mesh as jax_mesh
from metdetpy_tpu.structs import (BinaryCfg, BinaryCoreCfg, DynamicCfg,
                                  HoughLineCfg, MainDetectCfg,
                                  RuntimeParams)
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import structs as ts
from metdetpy_tpu_torch.detectors import m3det as tm3
from metdetpy_tpu_torch.detectors import step_graph
from metdetpy_tpu_torch.parallel import mesh
from metdetpy_tpu_torch.parallel import multistream as tms

torch.set_num_threads(2)

W, H, FPS, K = 96, 64, 25.0, 16
N_WIN = 8          # window_sec 0.32 at 25 fps: n - 1 = 7
N_FRAMES = 32
CPU, CPU0 = torch.device("cpu"), torch.device("cpu", 0)
CFG = dict(binary=dict(adaptive_bi_thre=True, init_value=5,
                       sensitivity="normal", area=0.1, interval=2),
           hough_line=dict(threshold=10, min_len=10, max_gap=10),
           dynamic=dict(dy_mask=True, window_sec=5))


def masked(packed, k=K):
    """The packed buffer with the line slots of invalid peaks zeroed."""
    p = np.array(packed, dtype=np.float32)
    valid = p[..., k * 4:k * 5] > 0.5
    lines = p[..., :k * 4].reshape(*p.shape[:-1], k, 4)
    lines[~valid] = 0
    p[..., :k * 4] = lines.reshape(*p.shape[:-1], k * 4)
    return p


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
    """[8, 32, H, W]: meteors in streams 1, 3 and 6 at different times."""
    out = []
    for s in range(8):
        meteors = ([SynthMeteor(0.2 + 0.2 * (s % 3), 1.0 + 0.2 * (s % 3),
                                (int(W * .8), int(H * .2)),
                                (int(W * .2), int(H * .8)))]
                   if s in (1, 3, 6) else [])
        out.append(generate_meteor_video(
            width=W, height=H, fps=FPS, duration_sec=N_FRAMES / FPS,
            meteors=meteors, n_stars=10, noise_sigma=2.5, seed=300 + s))
    return np.stack(out)


def _detector(s: int, dmesh=None):
    _, tcfg = _cfgs()
    return tms.MultiStreamM3Detector(
        s, N_WIN / FPS, FPS, np.ones((H, W), np.uint8), 9, tcfg,
        BaseMetLog(), mesh=dmesh or mesh.build_mesh(s, device="cpu"),
        max_points=1024, max_peaks=K, device="cpu")


def _carry_tensors(graph) -> list:
    return step_graph._tensors(graph.carries)


# -- (a) the graph's body against the functional step and the JAX package --

@pytest.mark.parametrize("s,t_block", [(2, 8), (2, 4), (8, 8), (8, 4)])
def test_multistream_graph_equals_functional_step_and_jax(streams, s,
                                                          t_block):
    """S streams over N_FRAMES / T blocks (4 or 8): the history within the
    block (T = 8 >= n-1 = 7) and beyond it (T = 4)."""
    jcfg, _ = _cfgs()
    det = _detector(s)
    jd = jms.MultiStreamM3Detector(
        s, N_WIN / FPS, FPS, np.ones((H, W), np.uint8), 9, jcfg,
        BaseMetLog(), mesh=jax_mesh(s, axis_name="stream"),
        max_points=1024, max_peaks=K)
    (graph, _, _), = det._graphs
    r1, c1, r2, c2 = det.std_roi

    def zeros(*shape):
        return torch.zeros((s, N_WIN - 1) + shape, dtype=torch.uint8)
    carry = [zeros(H, W), zeros(r2 - r1, c2 - c1), zeros(H, W),
             tm3.EmaState.init(1 - 2 / 60, 5.0, CPU, (s,)),
             torch.zeros((), dtype=torch.int32)]
    n_valid = 0
    for b in range(N_FRAMES // t_block):
        blocks = streams[:s, b * t_block:(b + 1) * t_block].copy()
        got, = det.process_blocks_async(blocks)
        out = tm3._m3_block_step(*carry[:4], torch.from_numpy(blocks),
                                 carry[4], **det._step_kw)
        carry = list(out[2:])
        assert torch.equal(got, out[0]), f"block {b}"
        for buf, want in zip(_carry_tensors(graph),
                             step_graph._tensors(carry)):
            assert buf.dtype == want.dtype and torch.equal(buf, want)
        jwant = masked(jd.process_blocks_async(blocks))
        np.testing.assert_array_equal(masked(got.numpy()), jwant,
                                      err_msg=f"block {b}")
        n_valid += int((jwant[..., K * 4:K * 5] > 0.5).sum())
    assert det.timer == int(graph.carries[-1]) == N_FRAMES
    assert n_valid > 0


# -- (b) one StepGraph a device group --------------------------------------

@pytest.mark.parametrize("devices,n_groups", [
    ((CPU,) * 4 + (CPU0,) * 4, 2), ((CPU, CPU0) * 4, 8)])
def test_two_device_names_give_one_graph_a_group(streams, devices,
                                                 n_groups):
    one = _detector(8)
    two = _detector(8, mesh.DeviceMesh(devices))
    graphs = [g for g, _, _ in two._graphs]
    assert len(graphs) == n_groups and len(set(map(id, graphs))) == n_groups
    assert [(a, b) for _, a, b in two._graphs] == [
        (i * 8 // n_groups, (i + 1) * 8 // n_groups)
        for i in range(n_groups)]
    for b in range(N_FRAMES // 8):
        blocks = streams[:, b * 8:(b + 1) * 8].copy()
        want, = one.process_blocks_async(blocks)
        got = torch.cat(two.process_blocks_async(blocks))
        assert torch.equal(got, want), f"block {b}"
    for g in graphs:
        assert int(g.carries[-1]) == N_FRAMES


# -- (c) the carries are the graph's buffers --------------------------------

def test_carries_stay_in_place_and_handles_keep_their_values(streams):
    det = _detector(2)
    (graph, _, _), = det._graphs
    ptrs = [x.data_ptr() for x in _carry_tensors(graph)]
    handles, kept = [], []
    for b in range(N_FRAMES // 8):
        blocks = streams[:2, b * 8:(b + 1) * 8].copy()
        handle = det.process_blocks_async(blocks)
        handles.append(handle)
        kept.append([p.clone() for p in handle])
        assert [x.data_ptr() for x in _carry_tensors(graph)] == ptrs
        # the history is the block's last n-1 frames, copied out of the
        # frames buffer
        assert torch.equal(graph.carries[0],
                           torch.from_numpy(blocks[:, 8 - (N_WIN - 1):]))
    for handle, values in zip(handles, kept):
        assert all(torch.equal(p, v) for p, v in zip(handle, values))
    assert len({h[0].data_ptr() for h in handles}) == len(handles)


# -- (d) adoption ------------------------------------------------------------

def test_dropped_detector_graph_is_adopted(streams):
    step_graph.clear_idle()
    blocks = streams[:2, :8].copy()
    first = _detector(2)
    graph = first._graphs[0][0]
    want, = first.process_blocks_async(blocks)
    first.process_blocks_async(streams[:2, 8:16].copy())
    del first
    gc.collect()
    second = _detector(2)
    assert second._graphs[0][0] is graph
    # from the second detector's own fresh state
    assert int(graph.carries[-1]) == 0
    got, = second.process_blocks_async(blocks)
    assert torch.equal(got, want)
    # a detector beside it makes its own
    assert _detector(2)._graphs[0][0] is not graph


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


RT = dict(fps=FPS, exp_frame=1, eq_fps=FPS, eq_int_fps=int(FPS),
          exp_time=1 / FPS, runtime_size=[W, H], raw_size=[W, H],
          positive_category_list=["METEOR"])


def test_second_detect_multi_stream_adopts_the_graph(streams, monkeypatch):
    step_graph.clear_idle()
    made = []
    init = step_graph.StepGraph.__init__

    def counting(self, *args, **kw):
        made.append(self)
        init(self, *args, **kw)
    monkeypatch.setattr(step_graph.StepGraph, "__init__", counting)
    _, tcfg = _main_cfgs()
    runs = []
    for _ in range(2):
        records = tms.detect_multi_stream(
            list(streams[:2]), tcfg, ts.RuntimeParams(**RT), BaseMetLog(),
            mesh=mesh.build_mesh(2, device="cpu"), block_frames=8,
            max_points=1024, max_peaks=K, device="cpu")
        gc.collect()
        runs.append([[r.to_dict() for r in rs] for rs in records])
    assert len(made) == 1
    assert runs[0] == runs[1] and sum(map(len, runs[0])) >= 1


# -- (e) the Classic step through StepGraph ----------------------------------

def test_classic_graph_body_equals_functional_step(streams):
    """Blocks of 2 frames from stream start: the first two lie in the
    4-frame warm-up; then reset_device_state and three blocks more."""
    step_graph.clear_idle()
    path = relative2abs_path("./config/m3det_normal.json")
    cfg = ts.MainDetectCfg.from_json_file(path).detector.cfg
    mask = np.ones((H, W), np.uint8)

    def det():
        return tm3.ClassicDetector(1.0, FPS, mask, 4, cfg, BaseMetLog(),
                                   max_points=1024, device="cpu")
    a, b = det(), det()
    names = ("_gray_hist", "_sub_hist", "_classic_hist", "_ema",
             "_timer_dev")
    frames = streams[1]
    n_valid = 0
    for i in range(8):
        if i == 5:
            a.bi_threshold = b.bi_threshold = 7
            a.reset_device_state()
            b.reset_device_state()
        block = frames[2 * i:2 * i + 2]
        packed, dst = a._replay(tm3._classic_block_step, names,
                                torch.from_numpy(block),
                                a._step_static_kwargs())
        want = b.process_block_async(block)
        assert torch.equal(packed, want[0]) and torch.equal(dst, want[1])
        assert all(getattr(a, n) is buf
                   for n, buf in zip(names, a._graph.carries))
        for x, y in zip(step_graph._tensors([getattr(a, n) for n in names]),
                        step_graph._tensors([getattr(b, n) for n in names])):
            assert x.dtype == y.dtype and torch.equal(x, y)
        n_valid += int((packed[:, K * 4:K * 5] > 0.5).sum())
    assert int(a._timer_dev) == 6
    assert n_valid > 0


# -- (f) records against the JAX package, the history beyond the block ------

def test_detect_multi_stream_records_match_jax_history_beyond_block(
        streams):
    jcfg, tcfg = _main_cfgs()
    frames = list(streams)
    want = jms.detect_multi_stream(
        frames, jcfg, RuntimeParams(**RT), BaseMetLog(),
        mesh=jax_mesh(8, axis_name="stream"), block_frames=4,
        max_points=1024, max_peaks=K)
    got = tms.detect_multi_stream(
        frames, tcfg, ts.RuntimeParams(**RT), BaseMetLog(),
        mesh=mesh.build_mesh(8, device="cpu"), block_frames=4,
        max_points=1024, max_peaks=K, device="cpu")
    assert [[r.to_dict() for r in rs] for rs in got] == \
        [[r.to_dict() for r in rs] for rs in want]
    assert sum(len(rs) for rs in got) >= 2
