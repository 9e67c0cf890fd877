"""PyTorch port: the M3 step as one device program a block, on the CPU.

- The EMA scan as device data (the schedule from the timer tensor) equals
  the JAX package's jitted ``_ema_threshold_scan`` bit for bit: values,
  thresholds and all six state fields, through the warm-up, across
  ``k >= 1``, over every phase of ``std_interval`` against T, and with a
  stream axis.
- ``_m3_block_step`` with a tensor timer equals the JAX step over
  ``lcm(T, std_interval) / T + 2`` consecutive blocks, the advanced timer
  included, with a window history shorter and longer than the block.
- ``StepGraph``'s body (static buffers, in-body copy-back, cloned outputs),
  called block after block, equals the functional step; a handle kept
  across later calls keeps its own outputs.
- Carries load and save in place in the JAX checkpoint format.
- After a forced fault in block k and the block loop's recovery, the
  port's records equal the JAX package's, and both restart the EMA from
  the threshold the host last collected.
- The module imports neither JAX nor the JAX package.
"""

import math
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.detectors import m3det as jm3
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import api as tapi
from metdetpy_tpu_torch import checkpoint as tck
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.detectors import m3det as tm3
from metdetpy_tpu_torch.detectors import step_graph
from metdetpy_tpu_torch.detectors.step_graph import StepGraph
from metdetpy_tpu_torch.log import BaseMetLog
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MOMENTUM = 1 - 2 / 60
FIELDS = ("cur_value", "t", "warmup_on", "cur_momentum", "bi_threshold",
          "bi_thr_float")
SCAN_STATIC = ("n", "std_interval", "momentum", "warmup_speed", "adaptive",
               "coef_a", "coef_b")
jax_scan = jax.jit(jm3._ema_threshold_scan, static_argnames=SCAN_STATIC)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                  err_msg=what)


# -- the EMA scan as device data ---------------------------------------------

# (T, n, std_interval, blocks, streams, adaptive, first timer0)
SCAN_CASES = {
    # the main path's schedule: the warm-up, then all 25 phases of 50
    # against 64 (k >= 1 from the 30th update on)
    "main-path": (64, 25, 50, 27, 0, True, 0),
    "main-path-fixed-threshold": (64, 25, 50, 27, 0, False, 0),
    # the tests' small sizes: lcm(8, 10) / 8 = 5 phases, over and again
    "small": (8, 5, 10, 12, 0, True, 0),
    # several interval updates a block
    "interval-below-block": (16, 5, 4, 6, 0, True, 0),
    # a block shorter than the warm-up
    "block-below-window": (3, 7, 14, 40, 0, True, 0),
    # S streams with one timer and their own values
    "streams": (8, 5, 10, 12, 3, True, 0),
    "streams-fixed-threshold": (8, 5, 10, 12, 3, False, 0),
    # a stream starting mid-way (the timer past the warm-up)
    "from-timer-37": (8, 5, 10, 8, 0, True, 37),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_device_scan_equals_jax_scan(case):
    t, n, interval, blocks, streams, adaptive, timer0 = SCAN_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    kw = dict(n=n, std_interval=interval, momentum=MOMENTUM,
              warmup_speed=float(n), adaptive=adaptive,
              coef_a=1.2 if adaptive else 0.0,
              coef_b=3.6 if adaptive else 0.0)
    n_jax = max(streams, 1)
    jstates = [jm3.EmaState.init(MOMENTUM, 5.0) for _ in range(n_jax)]
    tstate = tm3.EmaState.init(MOMENTUM, 5.0, CPU,
                               (streams,) if streams else ())
    bound = tm3.ema_update_bound(t, n, interval)
    for b in range(blocks):
        stds = rng.uniform(0.5, 12.0, (n_jax, t)).astype(np.float32)
        if b == 0:  # a stream whose EMA stays 0 at first
            stds[0, :t // 3] = 0.0
        timer = timer0 + b * t
        moved = tm3.ema_update_frames(timer, t, n, interval)
        assert len(moved) <= bound
        tin = torch.from_numpy(stds if streams else stds[0])
        got = tm3._ema_threshold_scan(
            tin, torch.tensor(timer, dtype=torch.int32), tstate, **kw)
        for s in range(n_jax):
            want = jax_scan(jnp.asarray(stds[s]), jnp.int32(timer),
                            jstates[s], **kw)
            jstates[s] = want[3]
            at = (s,) if streams else ()
            for i, name in enumerate(("thr", "thr_f", "ema_vals")):
                _same(got[i][at], want[i], f"{case} block {b} {name}")
            for f in FIELDS:
                _same(getattr(got[3], f)[at], getattr(want[3], f),
                      f"{case} block {b} state {f}")
        tstate = got[3]
    assert int(tstate.t.reshape(-1)[0]) == int(jstates[0].t)
    if blocks * t > 40 * n:  # the warm-up has ended
        assert not bool(tstate.warmup_on.reshape(-1)[0])


def test_update_bound_holds_every_phase():
    """The static loop bound covers the most updates of any block phase."""
    for t, n, interval in ((64, 25, 50), (8, 5, 10), (16, 5, 4), (3, 7, 14),
                           (64, 1, 2), (32, 25, 25)):
        bound = tm3.ema_update_bound(t, n, interval)
        most = max(len(tm3.ema_update_frames(t0, t, n, interval))
                   for t0 in range(0, 3 * math.lcm(t, interval) + n))
        assert most <= bound <= t
    assert tm3.ema_update_bound(64, 25, 50) == 26


# -- the diff area's constants ------------------------------------------------

AREAS = [6144, 36864, 518400, 20736, 82944, 1000, 2048, 2073600, 7, 12345,
         100000, 3, 255, 12288, 230400, 1_999_999]


@pytest.mark.parametrize("area", AREAS)
def test_diff_area_factors_fold_as_xla(area):
    """The f32 factors of the diff area and of the gap equal the ones the
    jitted JAX expression applies: read off its output at a sum of 1
    (the area factor) and at 2^20 (the gap's, exact there)."""
    def expr(s):
        d = jnp.sum(s, axis=1) / 255.0 / area * 100.0
        return d, 1.0 - d / jm3.MAX_ALLOW_GAP
    fn = jax.jit(expr)
    got_area = np.asarray(fn(jnp.ones((1, 1), jnp.uint32))[0])[0]
    x = 2 ** 20
    one_less = np.asarray(fn(jnp.full((1, 1), x, jnp.uint32))[1])[0]
    got_gap = np.float32((1 - np.float64(one_less)) / x)
    area_f, gap_f = tm3._dst_sum_scales(area)
    assert np.float32(area_f).view(np.int32) == got_area.view(np.int32)
    assert np.float32(gap_f).view(np.int32) == got_gap.view(np.int32)


# -- the step with a tensor timer --------------------------------------------

H, W = 64, 96


def _step_kw(n: int, interval: int) -> dict:
    return dict(n=n, roi=tm3.select_subarea(np.ones((H, W), np.uint8), 0.1),
                dy_mask=True, mask_area=H * W, std_interval=interval,
                momentum=MOMENTUM, warmup_speed=float(n), adaptive=True,
                coef_a=1.2, coef_b=3.6, hough_threshold=10, min_len=10,
                max_gap=10.0, max_points=1024, max_peaks=16)


def _frames(n_frames: int) -> np.ndarray:
    meteor = SynthMeteor(start_sec=0.6, end_sec=1.6, pt1=(70, 12),
                         pt2=(20, 50))
    return generate_meteor_video(width=W, height=H, fps=25.0,
                                 duration_sec=n_frames / 25.0,
                                 meteors=[meteor], n_stars=12,
                                 noise_sigma=2.5)[:n_frames]


def _zero_carries(n: int, kw: dict, dev=CPU) -> list:
    r1, c1, r2, c2 = kw["roi"]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device=dev)
    return [zeros(n - 1, H, W), zeros(n - 1, r2 - r1, c2 - c1),
            zeros(n - 1, H, W), tm3.EmaState.init(MOMENTUM, 5.0, dev),
            torch.zeros((), dtype=torch.int32, device=dev)]


def _masked(packed: np.ndarray, k: int) -> np.ndarray:
    """The line slots of invalid peaks zeroed (the port zeroes them)."""
    out = np.array(packed)
    valid = out[:, k * 4:k * 5] > 0.5
    lines = out[:, :k * 4].reshape(-1, k, 4)
    lines[~valid] = 0
    out[:, :k * 4] = lines.reshape(out.shape[0], -1)
    return out


# (T, n, std_interval): n-1 <= T and n-1 > T
STEP_CASES = {"history-within-block": (8, 5, 10),
              "history-beyond-block": (8, 12, 24)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_with_tensor_timer_equals_jax_step(case):
    t, n, interval = STEP_CASES[case]
    kw = _step_kw(n, interval)
    blocks = math.lcm(t, interval) // t + 2
    frames = _frames(blocks * t)
    jstep = partial(jm3._m3_block_step, **kw)
    r1, c1, r2, c2 = kw["roi"]
    jcarry = [jnp.zeros((n - 1, H, W), jnp.uint8),
              jnp.zeros((n - 1, r2 - r1, c2 - c1), jnp.uint8),
              jnp.zeros((n - 1, H, W), jnp.uint8),
              jm3.EmaState.init(MOMENTUM, 5.0), jnp.zeros((), jnp.int32)]
    tcarry = _zero_carries(n, kw)
    n_valid = 0
    for b in range(blocks):
        block = frames[b * t:(b + 1) * t]
        jout = jstep(*jcarry[:4], jnp.asarray(block), jcarry[4])
        tout = tm3._m3_block_step(*tcarry[:4], torch.from_numpy(block),
                                  tcarry[4], **kw)
        k = kw["max_peaks"]
        np.testing.assert_array_equal(
            _bits(_masked(tout[0].numpy(), k)),
            _bits(_masked(np.asarray(jout[0]), k)), err_msg=f"block {b}")
        for i, name in ((1, "dst"), (2, "gray"), (3, "sub"), (4, "dy")):
            _same(tout[i], jout[i], f"block {b} {name}")
        for f in FIELDS:
            _same(getattr(tout[5], f), getattr(jout[5], f),
                  f"block {b} state {f}")
        assert tout[6].dtype == torch.int32 and tout[6].dim() == 0
        assert int(tout[6]) == int(jout[6]) == (b + 1) * t
        n_valid += int((np.asarray(jout[0])[:, k * 4:k * 5] > 0.5).sum())
        jcarry, tcarry = list(jout[2:]), list(tout[2:])
    assert n_valid > 0  # the meteor gave lines


# -- StepGraph's body on the CPU ---------------------------------------------

@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_graph_body_equals_functional_step(case):
    t, n, interval = STEP_CASES[case]
    kw = _step_kw(n, interval)
    blocks = math.lcm(t, interval) // t + 2
    frames = _frames(blocks * t)
    buffers = _zero_carries(n, kw)
    graph = StepGraph(tm3._m3_block_step, buffers)
    carry = _zero_carries(n, kw)
    for b in range(blocks):
        block = torch.from_numpy(frames[b * t:(b + 1) * t])
        packed, dst = graph(block, **kw)
        want = tm3._m3_block_step(*carry[:4], block.clone(), carry[4], **kw)
        assert torch.equal(packed, want[0]) and torch.equal(dst, want[1])
        carry = list(want[2:])
        # the buffers are the ones given, updated in place
        assert all(a is b_ for a, b_ in zip(graph.carries, buffers))
        got_t = [buffers[0], buffers[1], buffers[2], *buffers[3].tensors(),
                 buffers[4]]
        want_t = [carry[0], carry[1], carry[2], *carry[3].tensors(),
                  carry[4]]
        for g, w_ in zip(got_t, want_t):
            assert g.dtype == w_.dtype and torch.equal(g, w_)
    assert int(buffers[4]) == blocks * t
    # one key, nothing captured on the CPU
    assert [e.graph for e in graph._entries.values()] == [None]


def test_handles_keep_their_outputs_across_calls():
    t, n, interval = STEP_CASES["history-within-block"]
    kw = _step_kw(n, interval)
    frames = _frames(4 * t)
    graph = StepGraph(tm3._m3_block_step, _zero_carries(n, kw))
    carry = _zero_carries(n, kw)
    handles, wants = [], []
    for b in range(4):
        block = torch.from_numpy(frames[b * t:(b + 1) * t])
        handles.append(graph(block, **kw))
        out = tm3._m3_block_step(*carry[:4], block.clone(), carry[4], **kw)
        wants.append((out[0].clone(), out[1].clone()))
        carry = list(out[2:])
    ptrs = {h[0].data_ptr() for h in handles}
    assert len(ptrs) == 4
    for (packed, dst), (wp, wd) in zip(handles, wants):
        assert torch.equal(packed, wp) and torch.equal(dst, wd)
    assert not torch.equal(handles[0][1], handles[3][1])


def test_acquire_adopts_a_released_graph():
    """A StepGraph given back is adopted by the next acquire of its carry
    signature, with the new caller's values in its buffers; one in use, or
    of other shapes, is not; of two given back, the first is kept."""
    t, n, interval = STEP_CASES["history-within-block"]
    kw = _step_kw(n, interval)
    step = tm3._m3_block_step
    a = StepGraph.acquire(step, _zero_carries(n, kw))
    a(torch.from_numpy(_frames(t)), **kw)
    assert int(a.carries[-1]) == t
    a.release()
    fresh = _zero_carries(n, kw)
    b = StepGraph.acquire(step, fresh)
    assert b is a and b.carries[0] is not fresh[0]
    for buf, value in zip(b.carries[:3] + [b.carries[4]],
                          fresh[:3] + [fresh[4]]):
        assert torch.equal(buf, value)
    assert all(torch.equal(x, y) for x, y in zip(b.carries[3].tensors(),
                                                 fresh[3].tensors()))
    c = StepGraph.acquire(step, _zero_carries(n, kw))
    other = StepGraph.acquire(step, _zero_carries(n + 1, kw))
    assert c is not b and other is not b
    b.release()
    c.release()
    assert StepGraph.acquire(step, _zero_carries(n, kw)) is b
    assert StepGraph.acquire(step, _zero_carries(n, kw)) is not c
    b.release()
    step_graph.clear_idle()
    assert StepGraph.acquire(step, _zero_carries(n, kw)) is not b


def test_detector_carries_are_the_graph_buffers():
    """A StepGraph over an M3Detector's carries advances the detector: its
    results equal a second detector's functional steps, and its reset
    zeroes the buffers the graph holds."""
    path = relative2abs_path("./config/m3det_normal.json")
    cfg = TMainDetectCfg.from_json_file(path).detector.cfg
    mask = np.ones((H, W), np.uint8)

    def det():
        return tm3.M3Detector(0.2, 25.0, mask, 4, cfg, BaseMetLog(),
                              max_points=1024, device="cpu")
    a, b = det(), det()
    graph = StepGraph(tm3._m3_block_step, [a._gray_hist, a._sub_hist,
                                           a._dy_hist, a._ema, a._timer_dev])
    frames = _frames(24)
    kw = a._step_static_kwargs()
    for i in range(3):
        block = frames[i * 8:(i + 1) * 8]
        packed, _ = graph(torch.from_numpy(block), **kw)
        want, _ = b.process_block_async(block)
        assert torch.equal(packed, want)
    assert torch.equal(a._gray_hist, b._gray_hist)
    assert int(a._timer_dev) == int(b._timer_dev) == 24
    a.bi_threshold = 9
    a.reset_device_state()
    assert int(graph.carries[-1]) == 0 and int(graph.carries[0].sum()) == 0
    assert graph.carries[3] is a._ema
    assert float(a._ema.bi_threshold) == 9.0
    assert int(a._ema.t) == 0 and bool(a._ema.warmup_on)


# -- checkpoint format -------------------------------------------------------

def test_checkpoint_round_trip_of_tensor_state():
    """``detector_state`` writes the six EMA fields and the timer with the
    JAX file's dtypes; ``restore_detector`` loads them back in place."""
    path = relative2abs_path("./config/m3det_normal.json")
    cfg = TMainDetectCfg.from_json_file(path).detector.cfg
    mask = np.ones((H, W), np.uint8)
    src = tm3.M3Detector(0.2, 25.0, mask, 4, cfg, BaseMetLog(),
                         max_points=1024, device="cpu")
    frames = _frames(24)
    for i in range(3):
        src.process_block_async(frames[i * 8:(i + 1) * 8])
    arrays = tck.detector_state(src)
    assert [arrays[f"ema_{i}"].dtype for i in range(6)] == [
        np.float32, np.int32, np.bool_, np.float32, np.float32, np.float32]
    assert all(arrays[f"ema_{i}"].shape == () for i in range(6))
    assert int(arrays["timer"]) == 24 and int(arrays["ema_1"]) > 0
    dst = tm3.M3Detector(0.2, 25.0, mask, 4, cfg, BaseMetLog(),
                         max_points=1024, device="cpu")
    before = [dst._gray_hist, dst._timer_dev, *dst._ema.tensors()]
    tck.restore_detector(dst, arrays)
    after = [dst._gray_hist, dst._timer_dev, *dst._ema.tensors()]
    assert all(x is y for x, y in zip(before, after))
    assert dst.timer == 24 and int(dst._timer_dev) == 24
    for f in FIELDS:
        assert torch.equal(getattr(dst._ema, f), getattr(src._ema, f))
    assert torch.equal(dst._dy_hist, src._dy_hist)


# -- the recovery after a fault ----------------------------------------------

FPS = 25.0


@pytest.fixture(scope="module")
def fault_clip():
    meteor = SynthMeteor(start_sec=4.2, end_sec=5.6, pt1=(150, 30),
                         pt2=(80, 100))
    return generate_meteor_video(width=192, height=108, fps=FPS,
                                 duration_sec=7.68, meteors=[meteor],
                                 n_stars=25, noise_sigma=3.0)


def _fault_cfg(cls):
    cfg = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    return cfg


def _run_with_fault(monkeypatch, detector_cls, run, frames, k: int):
    """``run(frames)`` with the k-th collect raising; returns the records
    and each reset's (host threshold, EMA fields) right after it."""
    seen = {"collects": 0}
    resets = []
    orig_collect = detector_cls.collect
    orig_reset = detector_cls.reset_device_state

    def flaky_collect(self, handle):
        seen["collects"] += 1
        if seen["collects"] == k:
            raise RuntimeError("injected step fault")
        return orig_collect(self, handle)

    def watched_reset(self):
        orig_reset(self)
        resets.append((self.bi_threshold,
                       [np.asarray(getattr(self._ema, f)) for f in FIELDS],
                       int(np.asarray(self._timer_dev))))

    with monkeypatch.context() as m:
        m.setattr(detector_cls, "collect", flaky_collect)
        m.setattr(detector_cls, "reset_device_state", watched_reset)
        mdrf = run(frames.copy())
    return [r.to_dict() for r in mdrf.results], resets


@pytest.mark.parametrize("k", [2, 6])
def test_records_after_recovery_equal_jax(fault_clip, monkeypatch, k):
    # the JAX package reads its switches; the port takes the same choices
    # through its own seams
    monkeypatch.setenv("METDETPY_TPU_DEFERRED_COLLECT", "0")
    monkeypatch.setenv("METDETPY_TPU_PIPELINE_DEPTH", "1")
    monkeypatch.setattr(tapi, "_collect_deferred", lambda *a: False)
    monkeypatch.setattr(tapi, "PIPELINE_DEPTH", 1)
    monkeypatch.setenv("METDETPY_TPU_BLOCK_FRAMES", "32")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    want, jresets = _run_with_fault(
        monkeypatch, jm3.M3Detector,
        lambda f: jax_detect_video(f, None, _fault_cfg(MainDetectCfg),
                                   work_mode="backend"), fault_clip, k)
    got, tresets = _run_with_fault(
        monkeypatch, tm3.M3Detector,
        lambda f: detect_video(f, None, _fault_cfg(TMainDetectCfg),
                               work_mode="backend", device="cpu"),
        fault_clip, k)
    assert len(jresets) == len(tresets) == 1
    assert got == want and any(
        t["category"] == "METEOR" for r in got for t in r["target"])
    (jthr, jema, jtimer), (tthr, tema, ttimer) = jresets[0], tresets[0]
    # both restart the EMA from the threshold the host last collected,
    # which the noise had moved off the preset's initial value
    assert tthr == jthr and tthr != 5
    assert jtimer == ttimer == 0
    for f, a, b in zip(FIELDS, tema, jema):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    assert float(tema[4]) == float(tthr)


# -- independence from JAX ---------------------------------------------------

def test_module_imports_no_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['metdetpy_tpu'] = None\n"
            "import metdetpy_tpu_torch.detectors.step_graph\n"
            "import metdetpy_tpu_torch.detectors.m3det\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'metdetpy_tpu.')) for m in sys.modules if sys.modules[m])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
