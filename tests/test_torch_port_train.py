"""PyTorch port: the training path (``models/train.py``,
``yolov5.init_params``, the flax-format ``save_params`` /
``params_to_flax``, ``convert_torch_checkpoint`` and ``python -m
metdetpy_tpu_torch.train``) against the JAX package on the CPU.

Full-width YOLOv5s (nc 8) at the JAX test's size (96x96, batch 2), inputs
from numpy seeds, the JAX functions jitted. Tolerances, as stated at each
test:

- ``build_dense_targets`` and ``synth_batch``: bit for bit (3 seeds);
- ``yolo_loss`` on the same heads and targets: rtol 1e-6;
- a float32 body, the loss and every gradient leaf against
  ``jax.value_and_grad``: rtol 2e-4, atol 2e-4 x max|g| (the heads'
  tolerance: the convolutions sum in different orders);
- the optimiser alone, fed JAX's gradients for 5 updates: bit for bit
  where the clip does not trigger; where it does, rtol 1e-6 with atol
  1e-6 x max|p| of the leaf (XLA sums the global norm in float32 in its
  own order, within 1e-6 of the port's correctly rounded one, and that
  moves every clipped gradient); the cosine schedule rtol 1e-6 (XLA's
  cosine is its own approximation), exact at 5 steps;
- the sharded step's loss against JAX's on 8 virtual CPU devices: rtol
  2e-4; against the unsharded step: bit for bit on one device, rtol 1e-6
  (loss) and the gradients' tolerance above across two devices;
- the flax-format round trip: bit for bit; a port-saved npz in the flax
  model: the heads' tolerance; the torch checkpoint converter: exact.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metdetpy_tpu.models import train as jtrain
from metdetpy_tpu.models import weights as jw
from metdetpy_tpu.models import yolov5 as jv5
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch.models import train as ttrain
from metdetpy_tpu_torch.models import weights as tw
from metdetpy_tpu_torch.models import yolov5 as tv5
from metdetpy_tpu_torch.parallel.mesh import GridMesh, shared_grid
from test_torch_port_yolo import _ultralytics_state_dict

torch.set_num_threads(2)

HW = (96, 96)
NC = 8
WEIGHTS = relative2abs_path("./weights/yolov5s_v5.flax.npz")
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _targets_t(targets):
    return [(t(tg), t(m)) for tg, m in targets]


@pytest.fixture(scope="module")
def flat():
    with np.load(WEIGHTS) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def batch():
    """Seed 4 gives positives at every head ([7, 7, 1] anchors)."""
    imgs, targets = jtrain.synth_batch(np.random.default_rng(4), 2, HW, NC)
    assert all(m.sum() > 0 for _, m in targets)
    return imgs, targets


def _port_net(flat, dtype=torch.float32):
    net = tv5.YOLOv5(nc=NC, dtype=dtype)
    net.load_state_dict(tw.params_from_flax(flat), strict=True)
    return net


def _jax_loss_fn(model):
    def loss_fn(params, batch_stats, imgs, targets):
        heads = model.apply({"params": params, "batch_stats": batch_stats},
                            imgs)
        return jtrain.yolo_loss(heads, targets, NC)
    return loss_fn


@pytest.fixture(scope="module")
def jax_grads(flat, batch):
    """JAX's float32 loss and gradients on the shipped weights."""
    imgs, targets = batch
    variables = jw.unflatten_tree(flat)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(
        jv5.YOLOv5(nc=NC, dtype=jnp.float32))))(
        variables["params"], variables["batch_stats"], jnp.asarray(imgs),
        targets)
    return float(loss), jw.flatten_tree({"params": jax.device_get(grads)})


# -- targets, data, loss ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_targets_and_synth_batch_match_jax(seed):
    """Bit for bit: the same ``np.random.Generator`` gives the same batch
    bytes and targets in both packages."""
    want = jtrain.synth_batch(np.random.default_rng(seed), 2, HW, NC)
    got = ttrain.synth_batch(np.random.default_rng(seed), 2, HW, NC)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.float32
    for (gt, gm), (wt, wm) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gm, wm)
    rng = np.random.default_rng(seed)
    boxes = []
    for _ in range(2):
        xs = np.sort(rng.uniform(0, 96, (3, 2)), axis=1)
        ys = np.sort(rng.uniform(0, 96, (3, 2)), axis=1)
        boxes.append(np.stack([xs[:, 0], ys[:, 0], xs[:, 1], ys[:, 1]],
                              -1).astype(np.float32))
    labels = [rng.integers(0, NC, 3).astype(np.int32) for _ in range(2)]
    for (gt, gm), (wt, wm) in zip(
            ttrain.build_dense_targets(boxes, labels, HW, NC),
            jtrain.build_dense_targets(boxes, labels, HW, NC)):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gm, wm)


def test_yolo_loss_matches_jax(batch):
    """rtol 1e-6 on the same heads and targets; the whole batch's divisors
    passed as ``norms`` give the default's value bit for bit."""
    _, targets = batch
    rng = np.random.default_rng(5)
    heads = [rng.normal(0, 3, (2, HW[0] // s, HW[1] // s, 3 * (5 + NC)))
             .astype(np.float32) for s in (8, 16, 32)]
    want = float(jax.jit(lambda h, tg: jtrain.yolo_loss(h, tg, NC))(
        [jnp.asarray(h) for h in heads], targets))
    got = ttrain.yolo_loss([t(h) for h in heads], _targets_t(targets), NC)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    normed = ttrain.yolo_loss([t(h) for h in heads], _targets_t(targets),
                              NC, norms=ttrain.target_norms(targets))
    assert float(normed) == float(got)


def test_float32_loss_and_gradients_match_jax(flat, batch, jax_grads):
    """A float32 body on the shipped weights: the loss and every gradient
    leaf at rtol 2e-4, atol 2e-4 x max|g|; the batch norms' running
    statistics get no gradient."""
    imgs, targets = batch
    want_loss, want = jax_grads
    net = _port_net(flat)
    loss = ttrain.yolo_loss(net(t(imgs)), _targets_t(targets), NC)
    loss.backward()
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-4)
    got = tw.params_to_flax({k: p.grad for k, p in net.named_parameters()})
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=2e-4,
                                   atol=2e-4 * np.abs(g).max(), err_msg=k)
    assert all(b.grad is None for b in net.buffers())


# -- the optimiser ---------------------------------------------------------

def _optax_params(flat, grads, target_norm: float):
    """5 updates of optax's chain and of the port's Adam from the shipped
    weights, gradient i being JAX's scaled to a global norm of
    target_norm * (1 + 0.25 i)."""
    keys = list(grads)
    gn = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                     for g in grads.values()))
    p0 = {k: flat[k] for k in keys}
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(optax.cosine_decay_schedule(1e-3, 5,
                                                            alpha=0.05)))
    jp = jw.unflatten_tree({k: jnp.asarray(v) for k, v in p0.items()})
    state = tx.init(jp)
    update = jax.jit(lambda p, s, g: (lambda u, s2: (
        optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    tp = [torch.tensor(p0[k], requires_grad=True) for k in keys]
    opt = ttrain.Adam(tp, ttrain.cosine_decay_schedule(1e-3, 5, alpha=0.05),
                      max_norm=5.0)
    for i in range(5):
        scaled = {k: (g * (target_norm / gn * (1 + 0.25 * i))).astype(
            np.float32) for k, g in grads.items()}
        jp, state = update(jp, state, jw.unflatten_tree(
            {k: jnp.asarray(v) for k, v in scaled.items()}))
        for p, k in zip(tp, keys):
            p.grad = t(scaled[k].copy())
        opt.step()
    want = jw.flatten_tree(jax.device_get(jp))
    return {k: p.detach().numpy() for k, p in zip(keys, tp)}, want, p0


@pytest.mark.parametrize("clip", ["untriggered", "triggered"])
def test_optimizer_matches_optax_chain(flat, jax_grads, clip):
    """clip_by_global_norm(5) + adam(cosine_decay_schedule(1e-3, 5, 0.05))
    fed the same gradients (JAX's) for 5 updates: global norms 2..4
    (untriggered: bit for bit) or 20..40 (triggered: rtol 1e-6, atol 1e-6
    x max|p| of the leaf); the two global norms agree within rtol 1e-6."""
    target = 2.0 if clip == "untriggered" else 20.0
    got, want, p0 = _optax_params(flat, jax_grads[1], target)
    scaled = {k: g * np.float32(target) for k, g in jax_grads[1].items()}
    xla_norm = float(jax.jit(optax.global_norm)(jw.unflatten_tree(scaled)))
    flat_g = torch.cat([t(g).reshape(-1) for g in scaled.values()])
    port_norm = float(torch.sqrt(torch.sum(torch.square(flat_g.double()))
                                 .float()))
    np.testing.assert_allclose(port_norm, xla_norm, rtol=1e-6)
    moved = 0
    for k, w in want.items():
        if clip == "untriggered":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)
        moved += int((w != p0[k]).sum())
    assert moved > 0.9 * sum(w.size for w in want.values())


def test_adam_views_and_refusals():
    """The parameters become views of the optimiser's flat buffer (their
    values unchanged); float32 parameters only; a schedule needs positive
    steps."""
    net = tv5.init_params(seed=3, device="cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = ttrain.Adam(net.parameters(), 1e-3)
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    p = next(net.parameters())
    assert p.untyped_storage().data_ptr() == \
        opt.flat.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="float32"):
        ttrain.Adam([torch.zeros(3, dtype=torch.float64,
                                 requires_grad=True)], 1e-3)
    with pytest.raises(ValueError, match="positive"):
        ttrain.cosine_decay_schedule(1e-3, 0)


@pytest.mark.parametrize("steps", [5, 200, 1500])
def test_cosine_schedule_matches_optax(steps):
    """rtol 1e-6 over every count up to steps + 2; exact at 5 steps."""
    js = jax.jit(optax.cosine_decay_schedule(1e-3, steps, alpha=0.05))
    ps = ttrain.cosine_decay_schedule(1e-3, steps, alpha=0.05)
    want = np.array([np.asarray(js(jnp.int32(c)))
                     for c in range(steps + 3)], np.float32)
    got = np.array([ps(c) for c in range(steps + 3)], np.float32)
    if steps == 5:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- the train step --------------------------------------------------------

def test_loss_decreases_on_fixed_batch():
    """The port's mirror of ``tests/test_train.py``'s test: the bfloat16
    body from ``init_params(seed=0)``, Adam 3e-3, 8 steps on one batch."""
    model = tv5.init_params(nc=NC, input_hw=HW, seed=0, device="cpu")
    opt = ttrain.Adam(model.parameters(), 3e-3)
    step = ttrain.make_train_step(model, opt, NC)
    imgs, targets = ttrain.synth_batch(np.random.default_rng(0), 2, HW, NC)
    running_var = model.b4.cv1.bn.running_var.clone()
    losses = [float(step(imgs, targets)) for _ in range(8)]
    assert losses[-1] < losses[0] * 0.8, losses
    assert torch.equal(model.b4.cv1.bn.running_var, running_var)


def _sharded_batch():
    return jtrain.synth_batch(np.random.default_rng(6), 4, HW, NC)


def test_sharded_step_on_a_cpu_mesh(flat):
    """A (4, 2) mesh on the CPU: the step is the unsharded step (loss and
    parameters bit for bit after one update) and its loss is JAX's
    ``make_sharded_train_step``'s on the 8 virtual CPU devices (rtol
    2e-4); the sharding rules are JAX's."""
    imgs, targets = _sharded_batch()
    runs = []
    for mesh in (None, shared_grid((4, 2), "cpu")):
        net = _port_net(flat)
        opt = ttrain.Adam(net.parameters(), 1e-3, max_norm=5.0)
        step = (ttrain.make_train_step(net, opt, NC) if mesh is None else
                ttrain.make_sharded_train_step(net, opt, NC, mesh))
        runs.append((float(step(imgs, targets)), net.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k

    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                              ("dp", "mdl"))
    variables = jw.unflatten_tree(flat)
    tx = optax.sgd(1e-3)
    jstep, shard_vars, place = jtrain.make_sharded_train_step(
        jv5.YOLOv5(nc=NC, dtype=jnp.float32), tx, NC, jmesh)
    variables, shardings = shard_vars(variables)
    _, _, jloss = jstep(variables, tx.init(variables["params"]),
                        *place(jnp.asarray(imgs), targets))
    np.testing.assert_allclose(runs[1][0], float(jloss), rtol=2e-4)

    net = _port_net(flat)
    rules = ttrain.param_sharding_rules(net, shared_grid((4, 2), "cpu"))
    assert sorted(rules) == sorted(net.state_dict())
    for k, v in net.state_dict().items():
        node = shardings
        for part in next(iter(tw.params_to_flax({k: v}))).split("/"):
            node = node[part]
        assert ("mdl" in tuple(node.spec)) == ("mdl" in rules[k]), k
        assert rules[k] in ((), ("mdl", None, None, None)), k


def test_sharded_step_across_devices_keeps_the_loss_global(flat):
    """Two device groups (the CPU under two names, which compare unequal):
    the replica's sub-batch loss takes the whole batch's divisors, so the
    summed loss is the unsharded step's (rtol 1e-6) and so are the
    summed gradients (rtol 2e-4, atol 2e-4 x max|g|); a dp slice that
    spans devices raises."""
    imgs, targets = _sharded_batch()
    cpu0 = torch.device("cpu", 0)
    mesh = GridMesh(((CPU, CPU), (CPU, CPU), (cpu0, cpu0), (cpu0, cpu0)))
    assert mesh.along("dp").groups() == [(CPU, 0, 2), (cpu0, 2, 4)]
    runs = []
    for m in (None, mesh):
        net = _port_net(flat)
        opt = ttrain.Adam(net.parameters(), 1e-3, max_norm=5.0)
        step = (ttrain.make_train_step(net, opt, NC) if m is None else
                ttrain.make_sharded_train_step(net, opt, NC, m))
        loss = float(step(imgs, targets))
        runs.append((loss, {k: p.grad.clone()
                            for k, p in net.named_parameters()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for k, g in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k].numpy(), g.numpy(),
                                   rtol=2e-4,
                                   atol=2e-4 * float(g.abs().max()),
                                   err_msg=k)
    with pytest.raises(ValueError, match="lie on 2 devices"):
        GridMesh(((CPU, cpu0),)).along("dp")
    with pytest.raises(ValueError, match="does not divide"):
        step(imgs[:3], [(tg[:3], mk[:3]) for tg, mk in targets])


# -- init and weights ------------------------------------------------------

def test_init_params_matches_flax_init():
    """JAX's init tree's keys and shapes under ``params_to_flax``; every
    kernel of 20,000 values or more has the std of lecun-normal (sqrt(1 /
    fan_in)) within 5% and no value beyond its truncation; the detect
    biases, BN scale/bias and running mean/var are exact constants; a seed
    gives the same weights again."""
    _, variables = jv5.init_params(nc=NC, input_hw=(64, 64), seed=0)
    want = jw.flatten_tree(jax.device_get(variables))
    net = tv5.init_params(nc=NC, input_hw=(64, 64), seed=0, device="cpu")
    got = tw.params_to_flax(net.state_dict())
    assert sorted(got) == sorted(want) and len(got) == 291
    n_large = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        if k.endswith("kernel"):
            bound = np.sqrt(1.0 / np.prod(g.shape[:3]))
            # the truncation at 2 sigma, up to float32 rounding
            assert np.abs(g).max() <= 2 * bound / 0.87962566 * (1 + 1e-6), k
            if g.size >= 20000:
                n_large += 1
                assert abs(g.std() / bound - 1) < 0.05, (k, g.std(), bound)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert n_large == 36
    again = tv5.init_params(nc=NC, seed=0, device="cpu").state_dict()
    other = tv5.init_params(nc=NC, seed=1, device="cpu").state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, again[k]), k
    assert not torch.equal(net.b8.cv1.conv.weight, other["b8.cv1.conv.weight"])


def test_params_to_flax_round_trips_the_shipped_weights(flat):
    """``params_to_flax(params_from_flax(flat)) == flat`` bit for bit
    (keys, shapes, dtypes, values), also from bfloat16-cast kernels'
    float32 values; an unknown key raises."""
    back = tw.params_to_flax(tw.params_from_flax(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    net = _port_net(flat, torch.bfloat16).cast_body_weights_()
    cast = tw.params_to_flax(net.state_dict())
    k = "params/b0/conv/kernel"
    np.testing.assert_array_equal(
        cast[k], torch.from_numpy(flat[k]).bfloat16().float().numpy())
    with pytest.raises(KeyError, match="cannot map"):
        tw.params_to_flax({"b0.conv.extra": torch.zeros(2)})


def test_saved_npz_loads_in_the_flax_model(tmp_path):
    """A port-saved npz of ``init_params(seed=1)`` loads through JAX's
    ``load_params`` into the flax YOLOv5: float32 heads at rtol 2e-4, atol
    2e-4 x max|head| against the port's on the same input; the port loads
    it back bit for bit."""
    net = tv5.init_params(nc=NC, seed=1, device="cpu")
    path = str(tmp_path / "w.flax.npz")
    tw.save_params(net, path)
    variables = jw.load_params(path)
    x = np.random.default_rng(7).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(jv5.YOLOv5(nc=NC, dtype=jnp.float32).apply)(
        variables, jnp.asarray(x))
    f32 = tv5.YOLOv5(nc=NC, dtype=torch.float32)
    f32.load_state_dict(net.state_dict())
    with torch.inference_mode():
        got = f32(t(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=2e-4 * np.abs(w).max())
    back = tw.params_from_flax(tw.flatten_tree(tw.load_params(path)))
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k


def test_convert_torch_checkpoint_matches_jax(flat, tmp_path):
    """A ``torch.save``d ultralytics-named state dict, bare and under
    ``"model"``: the port's tree equals JAX's ``convert_torch_checkpoint``'s
    exactly (and the shipped arrays)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in _ultralytics_state_dict(flat).items()}
    for name, obj in (("bare.pt", sd), ("wrapped.pt", {"model": sd})):
        path = str(tmp_path / name)
        torch.save(obj, path)
        got = tw.flatten_tree(tw.convert_torch_checkpoint(path))
        want = jw.flatten_tree(jw.convert_torch_checkpoint(path))
        assert sorted(got) == sorted(want) == sorted(flat)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


# -- the entry point -------------------------------------------------------

def test_train_entry_point_writes_weights_both_packages_load(tmp_path,
                                                             capsys):
    """``python -m metdetpy_tpu_torch.train --steps 2 --hw 64 --device
    cpu`` (its ``main``): the npz loads in the flax model (finite heads)
    and in the port's ``YOLOModel`` (its body equal to the trained
    module's cast to bfloat16); the last line is the run's timings;
    without a card the default device raises; the module runs as a
    script."""
    from metdetpy_tpu_torch.models.yolo import YOLOModel
    from metdetpy_tpu_torch.train import main
    out = str(tmp_path / "trained.flax.npz")
    model = main(["--steps", "2", "--hw", "64", "--batch", "2", "--device",
                  "cpu", "--out", out])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == f"saved weights to {out}"
    stats = json.loads(lines[-1])
    assert stats["steps"] == 2 and stats["device"] == "cpu"
    assert stats["max_memory_allocated"] is None
    assert stats["synth_batch_s_per_step"] > 0 and stats["steps_per_s"] > 0
    heads = jv5.YOLOv5(nc=NC).apply(jw.load_params(out),
                                    jnp.zeros((1, 64, 64, 3)))
    assert all(np.isfinite(np.asarray(h)).all() for h in heads)
    loaded = YOLOModel(out, warmup=False, input_hw=(64, 64), device="cpu")
    for k, v in model.state_dict().items():
        want = v.bfloat16() if k.endswith("conv.weight") else v
        assert torch.equal(loaded.model.state_dict()[k], want), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1", "--out", str(tmp_path / "x.npz")])
    assert not os.path.exists(tmp_path / "x.npz")
    run = subprocess.run(
        [sys.executable, "-m", "metdetpy_tpu_torch.train", "--steps", "1",
         "--hw", "64", "--batch", "1", "--device", "cpu", "--out",
         str(tmp_path / "cli.flax.npz")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert json.loads(run.stdout.strip().splitlines()[-1])["steps"] == 1
    assert sorted(jw.flatten_tree(jw.load_params(
        str(tmp_path / "cli.flax.npz")))) == sorted(tw.params_to_flax(
            model.state_dict()))
