"""PyTorch port: ``python -m metdetpy_tpu_torch.dryrun`` against
``__graft_entry__.py`` on the CPU.

``entry()``'s step against the JAX entry's under ``jax.jit``, and each of
the six programs of ``dryrun_multichip`` at n = 2 and n = 8 shards
against the JAX function it ports, on the same numpy inputs (the JAX
programs on the first n of the 8 virtual CPU devices of
``tests/conftest.py``, the port's on an n-shard CPU mesh). Tolerances:

- the M3 step of ``entry()``, programs 1-3 and 6: bit for bit (packed
  buffers with the line slots of invalid peaks zeroed on both sides, as in
  ``test_torch_port_parallel.py``: the port zeroes them, JAX does not),
  program 1's cross-stream total exactly;
- program 4, the first step's loss from JAX's ``init_params(seed=0)``
  carried across by ``models/weights.py``: rtol 2e-4 against the JAX
  step's under ``optax.sgd(1e-3)`` (the loss is taken before the update);
- program 5: the same number of boxes per image, points within 2 px and
  scores within 0.03 (the two bfloat16 bodies round differently).
"""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
from metdetpy_tpu.detectors.m3det import _m3_block_step as jax_step
from metdetpy_tpu.log import BaseMetLog
from metdetpy_tpu.models import train as jtrain
from metdetpy_tpu.models import weights as jw
from metdetpy_tpu.models import yolov5 as jv5
from metdetpy_tpu.models.yolo import YOLOModel
from metdetpy_tpu.parallel.dataparallel import (batch_sharding,
                                                put_batch_sharded)
from metdetpy_tpu.parallel.temporal import temporal_m3_detect
from metdetpy_tpu.parallel.temporal_dldet import temporal_window_max_color
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import dryrun
from metdetpy_tpu_torch.parallel.mesh import DeviceMesh, build_mesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, CPU0 = torch.device("cpu"), torch.device("cpu", 0)
SIZES = [2, 8]
KW = dryrun.STREAM_KW


def masked(packed, k):
    """The packed buffer with the line slots of invalid peaks zeroed."""
    p = np.array(packed, dtype=np.float32)
    valid = p[..., k * 4:k * 5] > 0.5
    lines = p[..., :k * 4].reshape(*p.shape[:-1], k, 4)
    lines[~valid] = 0
    p[..., :k * 4] = lines.reshape(*p.shape[:-1], k * 4)
    return p


def _devices(n):
    return np.array(jax.devices()[:n])


def _port_mesh(n):
    return build_mesh(n, device="cpu")


# -- entry() ---------------------------------------------------------------

def test_entry_matches_jax_entry():
    fn, args = graft.entry()
    want = jax.jit(fn)(*args)
    tfn, targs = dryrun.entry("cpu")
    got = tfn(*targs)
    np.testing.assert_array_equal(masked(got[0].numpy(), 32),
                                  masked(want[0], 32))
    for i in (1, 2, 3, 4):      # dst and the three histories
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for f in ("cur_value", "bi_threshold", "bi_thr_float"):
        np.testing.assert_array_equal(getattr(got[5], f).numpy(),
                                      np.asarray(getattr(want[5], f)))
    assert int(got[5].t) == int(want[5].t)
    assert int(got[6]) == int(want[6]) == 116  # the advanced timer


# -- program 1: the stream step ----------------------------------------------

def _jax_stream_step(nd):
    """``dryrun_multichip``'s first program, returning its outputs."""
    mesh = Mesh(_devices(nd), ("stream",))
    step = partial(jax_step, **KW)

    def per_stream(gray, sub, dy, ema, frames, timer0):
        ema_local = jax.tree.map(lambda x: x[0], ema)
        packed = step(gray[0], sub[0], dy[0], ema_local, frames[0],
                      timer0[0])[0]
        total = jax.lax.psum(jnp.sum(packed[:, -6]), axis_name="stream")
        return packed[None], total[None]

    spec = P("stream")
    fn = jax.jit(shard_map(per_stream, mesh=mesh, in_specs=(spec,) * 6,
                           out_specs=(spec, spec)))
    base = graft._m3_args(dryrun.STREAM_N, dryrun.STREAM_T, dryrun.STREAM_H,
                          dryrun.STREAM_W, dryrun.STREAM_ROI, 256, 8)
    stacked = jax.tree.map(
        lambda x: jax.device_put(jnp.broadcast_to(x[None], (nd,) + x.shape),
                                 NamedSharding(mesh, spec)), base)
    packed, total = fn(*stacked)
    return np.asarray(packed), np.asarray(total)


@pytest.mark.parametrize("nd", SIZES)
def test_stream_step_matches_jax(nd):
    want_packed, want_total = _jax_stream_step(nd)
    packed, total = dryrun.stream_step(_port_mesh(nd))
    assert packed.shape == want_packed.shape == (nd, dryrun.STREAM_T, 46)
    np.testing.assert_array_equal(masked(packed, 8), masked(want_packed, 8))
    assert np.all(want_total == total), (total, want_total)


# -- programs 2 and 3: temporal shards ----------------------------------------

@pytest.mark.parametrize("nd", SIZES)
def test_temporal_matches_jax(nd):
    mesh = Mesh(_devices(nd), ("time",))
    frames = dryrun._temporal_frames(nd)
    want_packed, want_dst = temporal_m3_detect(frames, **KW, mesh=mesh,
                                               axis_name="time")
    packed, dst = dryrun.temporal(_port_mesh(nd))
    assert packed.shape == (nd * (dryrun.STREAM_N + 2), 46)
    np.testing.assert_array_equal(masked(packed, 8), masked(want_packed, 8))
    np.testing.assert_array_equal(dst, np.asarray(want_dst))


@pytest.mark.parametrize("nd", SIZES)
def test_streaming_temporal_matches_jax(nd):
    mesh = Mesh(_devices(nd), ("time",))
    frames = dryrun._temporal_frames(nd)
    half = frames.shape[0] // 2 // nd * nd
    w1, _, carry = temporal_m3_detect(frames[:half], **KW, mesh=mesh,
                                      axis_name="time", return_carry=True)
    w2, _, _ = temporal_m3_detect(frames[half:2 * half], **KW, mesh=mesh,
                                  axis_name="time", carry=carry,
                                  return_carry=True)
    p1, p2, got_half = dryrun.streaming_temporal(_port_mesh(nd))
    assert got_half == half
    np.testing.assert_array_equal(masked(p1, 8), masked(w1, 8))
    np.testing.assert_array_equal(masked(p2, 8), masked(w2, 8))


# -- program 4: the sharded train step ----------------------------------------

@pytest.mark.parametrize("nd", SIZES)
def test_train_step_loss_matches_jax(nd):
    mdl = 2 if nd % 2 == 0 else 1
    dp = nd // mdl
    mesh = Mesh(_devices(nd).reshape(dp, mdl), ("dp", "mdl"))
    _, variables = jv5.init_params(nc=8, input_hw=(64, 64), seed=0)
    tx = optax.sgd(1e-3)
    step, shard_vars, place = jtrain.make_sharded_train_step(
        jv5.YOLOv5(nc=8), tx, 8, mesh)
    sharded, _ = shard_vars(variables)
    imgs, targets = jtrain.synth_batch(np.random.default_rng(1), dp,
                                       (64, 64), 8)
    _, _, want = step(sharded, tx.init(sharded["params"]),
                      *place(jnp.asarray(imgs), targets))
    loss, grid = dryrun.train_step(
        _port_mesh(nd), params=jw.flatten_tree(jax.device_get(variables)))
    assert grid.shape == {"dp": dp, "mdl": mdl}
    np.testing.assert_allclose(loss, float(want), rtol=2e-4)


def test_train_grid_lays_dp_slice_k_on_shard_k():
    """On a mesh of distinct devices the (n/2, 2) grid lies over the first
    n/2 of them, dp slice k on shard k's device; an odd mesh is (n, 1)."""
    mesh = DeviceMesh((CPU, CPU0, CPU, CPU0))
    grid = dryrun.train_grid(mesh)
    assert grid.devices == ((CPU, CPU), (CPU0, CPU0))
    assert grid.along("dp").devices == (CPU, CPU0)
    assert dryrun.train_grid(DeviceMesh((CPU,) * 3)).shape == {"dp": 3,
                                                               "mdl": 1}


# -- program 5: data-parallel inference with the pad path ---------------------

@pytest.mark.parametrize("nd", SIZES)
def test_data_parallel_matches_jax(nd):
    model = YOLOModel(weight_path=relative2abs_path(
                          "./weights/yolov5s_v5.flax.npz"),
                      dtype="float32", nms=True, warmup=False,
                      multiscale_pred=0, logger=BaseMetLog(),
                      input_hw=(64, 64))
    imgs = np.random.default_rng(0).integers(0, 255, (nd + 3, 64, 64, 3),
                                             np.uint8)
    dev, n_real = put_batch_sharded(imgs, batch_sharding(nd))
    want = model.forward_batch_device(dev)[:n_real]
    got = dryrun.data_parallel(_port_mesh(nd))
    assert len(got) == len(want) == nd + 3
    for (gb, gs), (wb, ws) in zip(got, want):
        assert gb.shape == np.asarray(wb).shape
        if len(gb):
            assert np.abs(gb - np.asarray(wb)).max() <= 2
            assert np.abs(gs - np.asarray(ws)).max() <= 0.03


# -- program 6: time-sharded colour window-max --------------------------------

@pytest.mark.parametrize("nd", SIZES)
def test_temporal_dldet_matches_jax_and_numpy(nd):
    mesh = Mesh(_devices(nd), ("time",))
    tfr, stacks, stacks2 = dryrun.temporal_dldet(_port_mesh(nd))
    w1, carry = temporal_window_max_color(tfr, 3, mesh, "time")
    w2, _ = temporal_window_max_color(tfr, 3, mesh, "time", carry=carry)
    np.testing.assert_array_equal(stacks, np.asarray(w1))
    np.testing.assert_array_equal(stacks2, np.asarray(w2))
    ext = np.concatenate([tfr[-2:], tfr])       # the carried tail first
    ref = np.max(np.stack([ext[:-2], ext[1:-1], ext[2:]]), axis=0)
    np.testing.assert_array_equal(stacks2, ref)
    np.testing.assert_array_equal(stacks[2:], ref[2:])


# -- the mesh across devices, the command line, the refusals -----------------

def test_programs_across_two_devices_equal_one_device():
    """A mesh whose shards lie on two devices (the CPU under two names,
    which compare unequal: halos and partial totals move by ``.to()``, the
    train step and the model get replicas) gives what one device gives:
    programs 1-3, 5 and 6 bit for bit, the loss within rtol 1e-6."""
    one = DeviceMesh((CPU,) * 4)
    two = DeviceMesh((CPU, CPU, CPU0, CPU0))
    assert len(two.groups()) == 2
    for prog in (dryrun.stream_step, dryrun.temporal,
                 dryrun.streaming_temporal, dryrun.temporal_dldet):
        for a, b in zip(prog(one), prog(two)):
            np.testing.assert_array_equal(a, b, err_msg=prog.__name__)
    for (ab, as_), (bb, bs) in zip(dryrun.data_parallel(one),
                                   dryrun.data_parallel(two)):
        np.testing.assert_array_equal(ab, bb)
        np.testing.assert_array_equal(as_, bs)
    loss_one, _ = dryrun.train_step(DeviceMesh((CPU,) * 4))
    loss_two, grid = dryrun.train_step(DeviceMesh((CPU, CPU0, CPU, CPU0)))
    assert grid.along("dp").devices == (CPU, CPU0)
    np.testing.assert_allclose(loss_two, loss_one, rtol=1e-6)


def test_cli_on_the_cpu_prints_seven_lines_and_loads_no_jax():
    """``python -m metdetpy_tpu_torch.dryrun 2 --device cpu`` with JAX and
    the JAX package made unimportable: exit 0, ``entry OK`` and the six
    program lines, each naming its shards and devices."""
    code = ("import runpy, sys, torch\n"
            "torch.set_num_threads(2)\n"
            "for m in ('jax', 'jaxlib', 'optax', 'flax', 'metdetpy_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['dryrun', '2', '--device', 'cpu']\n"
            "runpy.run_module('metdetpy_tpu_torch.dryrun', "
            "run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 7, lines
    assert lines[0].startswith("entry OK: [(16, 166), (16, 216, 384)")
    assert lines[1].startswith("dryrun_multichip OK on 2 shards over 1 "
                               "device (cpu): packed (2, 4, 46)")
    assert all("2 shards over 1 device (cpu)" in ln for ln in lines[1:])
    assert "train step OK on (1x2) mesh" in lines[4]
    assert "batch 5 (+pad)" in lines[5]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


def test_too_few_cards_raise_the_jax_message(monkeypatch, capsys):
    """Without ``shared`` the mesh needs n cards: on a machine with one,
    ``dryrun_multichip(8)`` ends with "need 8 devices, have 1" before any
    program runs, as ``__graft_entry__.py`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        dryrun.dryrun_multichip(8)
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        build_mesh(8)
    assert capsys.readouterr().out == ""
