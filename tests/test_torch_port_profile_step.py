"""The stage profilers of the M3 step, ``python -m
metdetpy_tpu_torch.profile_step block|dense|split``, on the CPU against
the JAX side's ``tools/profile_block.py``, ``profile_dense.py`` and
``profile_worstcase_split.py``.

The inputs equal the tools' constructions; ``chain_only`` (the step
before the Hough stage) equals the JAX tools' composition of the JAX
package's functions under ``jax.jit`` and the port's own step; the Hough
stages composed as the dense tool splits them equal ``hough_lines_batch``
of both packages (on ``valid``, ``lines[valid]``, ``npix`` and
``overflow``; the port zeroes invalid slots). All of it bit for bit, at
64x96 with 8-frame blocks. The CLI prints its lines with null device
readings on the CPU, raises for ``cuda`` without a card, and runs with
JAX and the JAX package unimportable.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.detectors import m3det as jm3
from metdetpy_tpu.log import BaseMetLog as JBaseMetLog
from metdetpy_tpu.ops import filters as jfilters
from metdetpy_tpu.ops import hough as jhough
from metdetpy_tpu.ops import windows as jwindows
from metdetpy_tpu.ops.pallas_kernels import (fused_median_binarize_close,
                                             window_diff)
from metdetpy_tpu.structs import MainDetectCfg as JMainDetectCfg
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import bench, profile_step
from metdetpy_tpu_torch.detectors import m3det as tm3
from metdetpy_tpu_torch.ops import hough as though

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T = 64, 96, 8
CPU = torch.device("cpu")


def _tool(name: str):
    """A module of ``tools/`` (each imports JAX inside ``main`` only)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_source(name: str) -> str:
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        return f.read()


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# -- inputs ------------------------------------------------------------------

def test_worstcase_frames_equal_make_dense_frames():
    """The active sky of ``split`` is ``bench.worstcase_frames``; it equals
    ``profile_worstcase_split.make_dense_frames`` at 4 blocks."""
    want = _tool("profile_worstcase_split").make_dense_frames(4, T, H, W)
    got = bench.worstcase_frames(4 * T, H, W)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_quiet_frames_and_dense_dst_equal_the_tools():
    """``profile_block.py:33-34`` and ``profile_dense.py:27-38``, as the
    tools write them."""
    src = _tool_source("profile_block")
    assert "rng = np.random.default_rng(0)" in src
    assert "rng.integers(0, 24, (t * 5, h, w), np.uint8)" in src
    rng = np.random.default_rng(0)
    want = rng.integers(0, 24, (T * 5, H, W), np.uint8)
    np.testing.assert_array_equal(profile_step.quiet_frames(T * 5, H, W),
                                  want)

    src = _tool_source("profile_dense")
    assert "rng = np.random.default_rng(7)" in src
    assert "dst[t, ys[t] + dy, xs[t] + dx] = 255" in src
    n_blobs = 680
    rng = np.random.default_rng(7)
    dst = np.zeros((T, H, W), np.uint8)
    ys = rng.integers(1, H - 1, (T, n_blobs))
    xs = rng.integers(1, W - 1, (T, n_blobs))
    for t in range(T):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                dst[t, ys[t] + dy, xs[t] + dx] = 255
    np.testing.assert_array_equal(profile_step.dense_dst(T, H, W), dst)


# -- chain_only ----------------------------------------------------------------

def _jax_chain_only(kw):
    """``profile_worstcase_split.py:74-98``: the chain under ``jax.jit``."""
    n = kw["n"]
    r1, c1, r2, c2 = kw["roi"]

    @jax.jit
    def chain_only(gray_hist, sub_hist, dy_hist, ema_state, frames_, timer0):
        diff, new_gray = window_diff(gray_hist, frames_, n, timer0)
        stds, new_sub = jwindows.window_noise_std(
            sub_hist, frames_[:, r1:r2, c1:c2], n, timer0)
        thr, thr_f, ema_vals, new_ema = jm3._ema_threshold_scan(
            stds, timer0, ema_state, n=n, std_interval=kw["std_interval"],
            momentum=kw["momentum"], warmup_speed=kw["warmup_speed"],
            adaptive=kw["adaptive"], coef_a=kw["coef_a"],
            coef_b=kw["coef_b"])
        closed = fused_median_binarize_close(diff, thr)
        new_dy = dy_hist
        dst = closed
        if kw["dy_mask"]:
            dy_sum, new_dy = jwindows.rolling_sum_u32(dy_hist, closed, n)
            t_block = closed.shape[0]
            timers = timer0 + 1 + jnp.arange(t_block, dtype=jnp.int32)
            lens = jnp.minimum(timers, n).astype(jnp.uint32)[:, None, None]
            passmask = (dy_sum <= (lens - 1) * 255).astype(jnp.uint8)
            passmask = jfilters.erode3x3(passmask)
            dst = closed * passmask
        dst_sum = (jnp.sum(dst.astype(jnp.uint32), axis=(1, 2)) / 255.0
                   / kw["mask_area"] * 100.0)
        new_timer = timer0 + jnp.int32(frames_.shape[0])
        return (dst_sum, dst, new_gray, new_sub, new_dy, new_ema,
                new_timer)
    return chain_only


def _sky(sky: str):
    """(frames of 4 blocks, the JAX config, the port's) of a sky."""
    path = relative2abs_path("./config/m3det_normal.json")
    jcfg = JMainDetectCfg.from_json_file(path)
    if sky == "active":
        jcfg.detector.cfg.binary.adaptive_bi_thre = False
        jcfg.detector.cfg.binary.init_value = 30
        return (bench.worstcase_frames(4 * T, H, W), jcfg,
                bench.worstcase_cfg())
    return (profile_step.quiet_frames(4 * T, H, W), jcfg,
            bench._preset("m3det_normal"))


@pytest.mark.parametrize("sky", ["quiet", "active"])
def test_chain_only_matches_jax_composition_and_the_step(sky):
    """Four blocks from zero carries (the window's warm-up and steady
    state): ``chain_only``'s diff area, dst and carries equal the JAX
    tools' composition bit for bit (the diff area with that program's fold,
    ``sharded_fold``), and equal the port's ``_m3_block_step`` from the
    same carries (dst, carries, the packed diff-area column)."""
    frames, jcfg, tcfg = _sky(sky)
    mask = np.ones((H, W), np.uint8)
    jdet = jm3.M3Detector(window_sec=jcfg.detector.window_sec, fps=25.0,
                          mask=mask, num_cls=4, cfg=jcfg.detector.cfg,
                          logger=JBaseMetLog())
    tdet = bench._m3_detector(tcfg, H, W, CPU)
    kw = tdet._step_static_kwargs()
    jkw = jdet._step_static_kwargs()
    assert {k: jkw[k] for k in kw} == kw
    jchain = _jax_chain_only(jkw)
    n = kw["n"]
    r1, c1, r2, c2 = kw["roi"]
    jcarry = (jnp.zeros((n - 1, H, W), jnp.uint8),
              jnp.zeros((n - 1, r2 - r1, c2 - c1), jnp.uint8),
              jnp.zeros((n - 1, H, W), jnp.uint8), jdet._ema)
    jtimer = jnp.zeros((), jnp.int32)
    tcarry = (torch.zeros((n - 1, H, W), dtype=torch.uint8),
              torch.zeros((n - 1, r2 - r1, c2 - c1), dtype=torch.uint8),
              torch.zeros((n - 1, H, W), dtype=torch.uint8), tdet._ema)
    k5 = kw["max_peaks"] * 5
    area_cols = []
    for b in range(4):
        block = frames[b * T:(b + 1) * T]
        timer0 = b * T
        jout = jchain(*jcarry, jnp.asarray(block), jtimer)
        tblock = torch.from_numpy(block.copy())
        tout = profile_step.chain_only(*tcarry, tblock, timer0, **kw)
        # XLA folds the diff area's constants of the tool's program in two
        # f32 roundings (as in the sharded programs), the step's in one
        tsh = profile_step.chain_only(*tcarry, tblock, timer0,
                                      sharded_fold=True, **kw)
        step = tm3._m3_block_step(*tcarry, tblock, timer0, **kw)
        area_cols.append(step[0][:, k5].numpy())
        np.testing.assert_array_equal(_bits(tsh[0].numpy()),
                                      _bits(jout[0]))
        # the diff area, dst and the three histories
        for i, (a, b_) in enumerate(zip(tout[1:5], jout[1:5])):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b_),
                                          err_msg=f"output {i}")
        np.testing.assert_array_equal(_bits(step[0][:, k5].numpy()),
                                      _bits(tout[0].numpy()))
        for a, b_ in zip(step[1:5], tout[1:5]):
            assert torch.equal(a, b_)
        for got in (tout[5], step[5]):
            for f, want in zip(("cur_value", "t", "warmup_on",
                                "cur_momentum", "bi_threshold",
                                "bi_thr_float"), jout[5]):
                np.testing.assert_array_equal(
                    _bits(np.asarray(getattr(got, f))), _bits(want),
                    err_msg=f)
        jcarry, jtimer = jout[2:6], jout[6]
        tcarry = tout[2:6]
    assert int(jtimer) == 4 * T
    assert float(tcarry[3].cur_value) > 0  # the noise EMA moved
    if sky == "active":  # the quiet sky binarizes nothing
        assert np.concatenate(area_cols).max() > 0


def test_ema_update_frames_follow_the_jax_scan():
    """The frames whose EMA updates, as the line of a captured block
    states them, are the frames where the JAX scan's value moves."""
    rng = np.random.default_rng(3)
    n, interval = 25, 50
    state = jm3.EmaState.init(1 - 2 / 60, 5.0)
    kw = dict(n=n, std_interval=interval, momentum=1 - 2 / 60,
              warmup_speed=float(n), adaptive=False, coef_a=0.0, coef_b=0.0)
    for timer0 in range(0, 64 * 5, 64):
        stds = rng.uniform(1.0, 9.0, 64).astype(np.float32)
        prev = np.asarray(state.cur_value)
        _, _, vals, state = jm3._ema_threshold_scan(
            jnp.asarray(stds), jnp.int32(timer0), state, **kw)
        vals = np.asarray(vals)
        moved = [i for i in range(64)
                 if vals[i] != (vals[i - 1] if i else prev)]
        assert tm3.ema_update_frames(timer0, 64, n, interval) == moved


# -- the dense stages --------------------------------------------------------

@pytest.mark.parametrize("n_blobs, max_points",
                         [(680, 8192), (40, 8192), (120, 512)])
def test_dense_stages_compose_to_hough_lines_batch(n_blobs, max_points):
    """compact -> vote -> peaks -> walk -> finish over ``dense_dst``
    equals the port's and the JAX package's ``hough_lines_batch``; the
    last case overflows every frame's point capacity but the first."""
    dst = profile_step.dense_dst(T, H, W, n_blobs)
    if max_points == 512:
        dst[0, :, :] = 0
        dst[0, 20:23, 10:80] = 255
    gaps = np.full((T,), 10.0, np.float32)
    kw = dict(threshold=10, min_len=10, max_points=max_points, max_peaks=64)
    got = profile_step.hough_by_stages(torch.from_numpy(dst),
                                       torch.from_numpy(gaps), **kw)
    port = though.hough_lines_batch(torch.from_numpy(dst),
                                 torch.from_numpy(gaps), **kw)
    want = jhough.hough_lines_batch(jnp.asarray(dst), jnp.asarray(gaps),
                                    **kw)
    for a, b in zip(got, port):
        assert torch.equal(a, b)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.lines.numpy()[valid],
                                  np.asarray(want.lines)[valid])
    np.testing.assert_array_equal(got.lines.numpy()[~valid], 0)
    np.testing.assert_array_equal(got.npix.numpy(), np.asarray(want.npix))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    assert valid.sum() > 0
    if max_points == 512:
        assert list(np.asarray(want.overflow)) == [False] + [True] * 7


# -- the readings and the CLI ------------------------------------------------

def test_same_bits_tells_apart_what_equality_does_not():
    a = torch.tensor([0.0, float("nan")])
    b = torch.tensor([-0.0, float("nan")])
    assert not profile_step._same_bits([a], [b])
    assert profile_step._same_bits([a], [a.clone()])
    assert not profile_step._same_bits([a], [a.double()])
    ema = tm3.EmaState.init(0.9, 5.0, CPU)
    leaves = profile_step._leaves((a, [ema, 3], None))
    assert len(leaves) == 7 and leaves[0] is a
    assert leaves[1:] == ema.tensors()


EXPECTED = {"block": ["step", "window_diff", "median_binarize_close",
                      "rolling_sum_u32", "window_noise_std", "segment_walk",
                      "rest"],
            "dense": ["hough_lines_batch", "compaction", "hough_vote",
                      "find_peaks", "segment_walk"],
            "split": ["chain_only", "step", "hough"]}


@pytest.mark.parametrize("tool", sorted(EXPECTED))
def test_cli_on_the_cpu_prints_a_line_a_stage(tool):
    out = io.StringIO()
    with redirect_stdout(out):
        records = profile_step.main([tool, "--device", "cpu", "--h", str(H),
                                     "--w", str(W), "--t", str(T),
                                     "--quick"])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert lines == json.loads(json.dumps(records))
    assert [ln["stage"] for ln in lines] == EXPECTED[tool]
    for ln in lines:
        assert ln["tool"] == tool and ln["device"] == "cpu"
        assert ln["shape"] == [T, H, W]
        assert ln["slope_ms"] > 0 or ln["stage"] in ("rest", "hough")
        assert ln["device_ms"] is None and ln["graph_ms"] is None
        assert ln["launches"] is None
        assert "not measured" in ln["note"]
    by = {ln["stage"]: ln for ln in lines}
    if tool != "dense":
        step = by["step"] if tool == "block" else by["chain_only"]
        assert step["timer0"] == (5 if tool == "block" else 4) * T
        assert step["ema_update_frames"] == tm3.ema_update_frames(
            step["timer0"], T, 25, 50)
    else:
        assert by["find_peaks"]["max_peaks_per_frame"] > 0
        assert 0 < by["hough_lines_batch"]["npix_per_frame_max"] <= H * W


def test_cuda_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.main(["block"])
    assert capsys.readouterr().out == ""


def test_runs_with_jax_and_the_jax_package_unimportable():
    code = ("import runpy, sys, torch\n"
            "torch.set_num_threads(2)\n"
            "for m in ('jax', 'jaxlib', 'metdetpy_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['profile_step', 'split', '--device', 'cpu', "
            f"'--h', '{H}', '--w', '{W}', '--t', '{T}', '--quick']\n"
            "runpy.run_module('metdetpy_tpu_torch.profile_step', "
            "run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    assert [ln["stage"] for ln in lines] == EXPECTED["split"]
