"""PyTorch port: the YOLOv5s model, its weights and the device functions of
``models/yolo.py`` and ``ops/nms.py`` against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the jitted JAX function
and its counterpart. Tolerances, as stated at each test:

- ``params_from_flax``: exact and complete (all 291 arrays, each once);
- float32 heads against ``YOLOv5(dtype=float32)`` with the shipped weights:
  rtol 2e-4 and atol 2e-4 x max|head|;
- bfloat16 heads: 99% of the values within 5% of the head's standard
  deviation and none beyond 50%;
- the cubic resize's weight matrices: exact; the resize itself: atol
  3e-7 (the two matrix products sum in their own orders);
  ``decode_predictions``: rtol 1e-6;
- ``_unit_f32``, ``_topk_compact``, the IoU matrix, ``nms_xyxy`` /
  ``_nms_batch``, ``_sel_nms_device``, ``_compact_kept_device``,
  ``_plan_tiles``, ``_unpack_compact``: exact;
- ``YOLOModel.forward``, ``forward_batch`` and dispatch/collect on the same
  images: equal box counts, matched boxes within 2 px, equal class, scores
  within 0.03.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.log import get_default_logger
from metdetpy_tpu.models import yolo as jyolo
from metdetpy_tpu.models import yolov5 as jv5
from metdetpy_tpu.models.weights import flatten_tree, load_params
from metdetpy_tpu.ops import nms as jnms
from metdetpy_tpu.structs import ModelCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch.models import init_model
from metdetpy_tpu_torch.models import yolo as tyolo
from metdetpy_tpu_torch.models import yolov5 as tv5
from metdetpy_tpu_torch.models.weights import params_from_flax
from metdetpy_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)

WEIGHTS = relative2abs_path("./weights/yolov5s_v5.flax.npz")
NC = 8


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def flat():
    with np.load(WEIGHTS) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def variables():
    return load_params(WEIGHTS)


def _port_net(flat, dtype):
    net = tv5.YOLOv5(nc=NC, dtype=dtype).eval()
    net.load_state_dict(params_from_flax(flat), strict=True)
    return net


# -- weights ---------------------------------------------------------------

def test_params_from_flax_exact_and_complete(flat):
    """Every one of the 291 arrays lands exactly once, bit for bit (conv
    kernels HWIO -> OIHW), and the state dict fills the model with no key
    missing or left over."""
    assert len(flat) == 291
    sd = params_from_flax(flat)
    assert len(sd) == 291
    assert sum(v.numel() for v in sd.values()) == 7_060_213
    net = tv5.YOLOv5(nc=NC)
    assert sorted(net.state_dict()) == sorted(sd)
    net.load_state_dict(sd, strict=True)
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var", "kernel": "weight"}
    for key, arr in flat.items():
        parts = key.split("/")
        dst = ".".join(parts[1:-1] + [names[parts[-1]]])
        want = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
        got = sd[dst].numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_params_from_flax_refuses_unknown_and_missing(flat):
    with pytest.raises(KeyError, match="cannot map"):
        params_from_flax({**flat, "params/b0/conv/extra": np.zeros(3)})
    with pytest.raises(KeyError, match="cannot map"):
        params_from_flax({"opt_state/b0/bn/mean": np.zeros(3)})
    short = dict(flat)
    del short["params/b4/m1/cv2/conv/kernel"]
    with pytest.raises(RuntimeError, match="b4.m1.cv2.conv.weight"):
        tv5.YOLOv5(nc=NC).load_state_dict(params_from_flax(short),
                                          strict=True)


def _ultralytics_state_dict(flat):
    """The shipped arrays under the ultralytics names (``model.N.*``, conv
    kernels OIHW) that the converters read."""
    from metdetpy_tpu.models.weights import _LAYER_MAP
    layer = {dst: idx for idx, dst in _LAYER_MAP.items()}
    leaf = {"conv/kernel": "conv.weight", "bn/scale": "bn.weight",
            "bn/bias": "bn.bias", "bn/mean": "bn.running_mean",
            "bn/var": "bn.running_var"}
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        mod = parts[1]
        if mod.startswith("detect"):
            name = {"kernel": "weight", "bias": "bias"}[parts[-1]]
            sd[f"model.24.m.{mod[-1]}.{name}"] = (
                arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr)
            continue
        inner = [f"m.{p[1:]}" if p[0] == "m" and p[1:].isdigit() else p
                 for p in parts[2:-2]]
        name = ".".join([f"model.{layer[mod]}", *inner,
                         leaf["/".join(parts[-2:])]])
        sd[name] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    return sd


def test_converters_match_jax_package(flat, tmp_path):
    """The port's own copies of ``convert_state_dict`` and ``convert_onnx``
    (with the protobuf wire parser) give the arrays the JAX package's give,
    exactly, and round-trip the shipped weights; a ``.onnx`` weight path
    loads through them into the model."""
    import os
    import sys

    from metdetpy_tpu.models import weights as jw
    from metdetpy_tpu_torch.models import weights as tw
    sd = _ultralytics_state_dict(flat)
    assert len(sd) == 291
    got = tw.flatten_tree(tw.convert_state_dict(sd))
    want = jw.flatten_tree(jw.convert_state_dict(sd))
    assert sorted(got) == sorted(want) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    with pytest.raises(KeyError, match="cannot map"):
        tw.convert_state_dict({k: v for k, v in sd.items()
                               if not k.startswith("model.9.")})
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools", "onnx_fixture"))
    try:
        import onnx_mini_pb2 as pb
    finally:
        sys.path.pop(0)
    m = pb.ModelProto()
    m.ir_version = 8
    m.graph.name = "yolov5s"
    for name, arr in sd.items():
        ten = m.graph.initializer.add()
        ten.name = name
        ten.data_type = 1
        ten.dims.extend(arr.shape)
        ten.raw_data = np.ascontiguousarray(arr, np.float32).tobytes()
    path = str(tmp_path / "yolov5s.onnx")
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    got = tw.flatten_tree(tw.convert_onnx(path))
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    model = tyolo.YOLOModel(path, nms=True, warmup=False, input_hw=(64, 64),
                            device="cpu", logger=get_default_logger())
    np.testing.assert_array_equal(
        model.model.b0.conv.weight.float().numpy(),
        torch.from_numpy(flat["params/b0/conv/kernel"].transpose(
            3, 2, 0, 1).copy()).bfloat16().float().numpy())
    with pytest.raises(ValueError, match="neither"):
        other = tmp_path / "weights.bin"
        other.write_bytes(b"x")
        tyolo.YOLOModel(str(other), device="cpu")


# -- the network -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 96, 96, 3), (1, 320, 320, 3)],
                         ids=["96x96_b2", "320x320_b1"])
def test_heads_float32_match_flax(flat, variables, shape):
    """rtol 2e-4, atol 2e-4 x max|head| (float32 on both sides; the
    convolutions sum in different orders)."""
    x = np.random.default_rng(11).uniform(0, 1, shape).astype(np.float32)
    want = jax.jit(jv5.YOLOv5(nc=NC, dtype=jnp.float32).apply)(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = _port_net(flat, torch.float32)(t(x))
    assert len(got) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=2e-4 * np.abs(w).max(),
                                   err_msg=f"head {i}")


def test_heads_bfloat16_match_flax(flat, variables):
    """The production dtype: 99% of the values within 5% of the head's
    standard deviation, none beyond 50%."""
    x = np.random.default_rng(12).uniform(0, 1, (2, 96, 96, 3)).astype(
        np.float32)
    want = jax.jit(jv5.YOLOv5(nc=NC).apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = _port_net(flat, torch.bfloat16)(t(x))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32   # the detect heads run in float32
        rel = np.abs(g.numpy() - w) / max(float(np.abs(w).std()), 1e-3)
        assert np.quantile(rel, 0.99) < 0.05, (i, np.quantile(rel, 0.99))
        assert rel.max() < 0.5, (i, rel.max())


def test_random_flax_weights_carry_across():
    """Random weights for a test come from the JAX package's initialiser,
    flattened to numpy and handed to the port (float32, rtol 2e-4 / atol
    2e-4 x max|head|)."""
    _, variables = jv5.init_params(nc=NC, input_hw=(64, 64), seed=3)
    flat = flatten_tree(jax.device_get(variables))
    x = np.random.default_rng(13).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(jv5.YOLOv5(nc=NC, dtype=jnp.float32).apply)(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = _port_net(flat, torch.float32)(t(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(w).max(), 1e-3))


def test_decode_predictions_matches_jax():
    """rtol 1e-6. (atol 1e-30: XLA's logistic flushes results below the
    smallest normal float32 to zero, torch keeps the denormal.)"""
    rng = np.random.default_rng(14)
    heads = [rng.normal(0, 6, (2, s, s, 3 * (5 + NC))).astype(np.float32)
             for s in (12, 6, 3)]
    heads[0][0, 0, 0, :4] = [-95.0, 95.0, -88.0, 30.0]
    want = np.asarray(jax.jit(lambda hs: jv5.decode_predictions(hs, NC))(
        [jnp.asarray(h) for h in heads]))
    got = tv5.decode_predictions([t(h) for h in heads], NC).numpy()
    assert got.shape == want.shape == (2, 3 * (144 + 36 + 9), 5 + NC)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


# -- preprocessing ---------------------------------------------------------

def test_unit_f32_matches_jax_exactly():
    """uint8 / 255 and uint16 / 65535 as XLA compiles them (a multiply by
    the float32 reciprocal), every value."""
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    u16 = np.arange(65536, dtype=np.uint16).reshape(1, 256, 256, 1)
    f32 = np.random.default_rng(1).uniform(0, 1, (1, 4, 4, 3)).astype(
        np.float32)
    for x in (u8, u16, f32):
        want = np.asarray(jax.jit(jyolo._unit_f32)(jnp.asarray(x)))
        np.testing.assert_array_equal(tyolo._unit_f32(t(x)).numpy(), want)


@pytest.mark.parametrize("shape,hw", [
    ((2, 136, 133, 3), (96, 96)),      # down, both axes (a dldet tile)
    ((1, 544, 533, 3), (320, 320)),    # down, full size
    ((2, 50, 40, 3), (96, 96)),        # up, both axes
    ((1, 96, 70, 3), (96, 96)),        # one axis only
    ((1, 72, 200, 3), (96, 96)),       # up and down
    ((1, 96, 96, 3), (96, 96)),        # identity
])
def test_cubic_resize_matches_jax(shape, hw):
    """atol 3e-7 (2.5 ulp at 1.0) against ``jax.image.resize(method=
    "cubic")`` (Keys kernel, a = -0.5, antialiased when scaling down): the
    weights are XLA's exactly, the products' sums run in torch's order."""
    x = np.random.default_rng(15).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax.jit(jyolo._resize_to, static_argnums=1)(
        jnp.asarray(x), hw))
    got = tyolo._resize_to(t(x), hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)


@pytest.mark.parametrize("m,n", [(136, 96), (133, 96), (544, 320),
                                 (533, 320), (50, 96), (40, 96), (70, 96),
                                 (200, 96), (33, 16)])
def test_cubic_weight_matrix_equals_jax(m, n):
    """The [m, n] weights equal those the jitted ``jax.image.resize`` applies
    (read back by resizing one-hot rows: each output is one weight times
    1.0 plus zeros, exact), including XLA's folded kernel constants and its
    windowed normalising sums."""
    eye = np.zeros((m, m, 1, 3), np.float32)
    eye[np.arange(m), np.arange(m)] = 1.0
    want = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (m, n, 1, 3), method="cubic"))(jnp.asarray(eye)))[:, :, 0, 0]
    np.testing.assert_array_equal(tyolo._cubic_weight_mat(m, n), want)


# -- top-k, NMS, compaction ------------------------------------------------

def test_topk_compact_with_ties_matches_jax():
    """Exact, with objectness rounded to two digits so that most ranks are
    ties (the lower row wins, as in ``lax.top_k``)."""
    rng = np.random.default_rng(16)
    p = rng.uniform(0, 1, (3, 500, 5 + NC)).astype(np.float32)
    p[..., 4] = np.round(p[..., 4], 2)
    p[1, :, 4] = 0.5                        # one image all equal
    want = jax.jit(jyolo._topk_compact, static_argnums=1)(
        jnp.asarray(p), 64, 0.25)
    got = tyolo._topk_compact(t(p), 64, 0.25)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32


def _boxes(rng, *lead):
    c = rng.uniform(0, 320, (*lead, 2))
    wh = rng.uniform(2, 100, (*lead, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def test_iou_matrix_matches_jax_bit_for_bit():
    """Exact against the jitted JAX function (the union's fused
    multiply-add included), duplicates and a degenerate box among them."""
    b = _boxes(np.random.default_rng(17), 200)
    b[5] = b[3]
    b[7, 2] = b[7, 0] - 1
    want = np.asarray(jax.jit(jnms.iou_matrix)(jnp.asarray(b),
                                               jnp.asarray(b)))
    np.testing.assert_array_equal(tnms.iou_matrix(t(b), t(b)).numpy(), want)


@pytest.mark.parametrize("case", ["single", "batch", "under_threshold",
                                  "fewer_than_top_k", "multiscale_padded"])
def test_nms_kept_indices_match_jax(case):
    """Exact order and keep mask: scores rounded to two digits (ties),
    rows under the threshold (all -1.0 after masking), duplicates."""
    rng = np.random.default_rng([18, len(case)])
    n = 40 if case == "fewer_than_top_k" else 300
    for _ in range(6):
        bx = _boxes(rng, 4, n)
        sc = np.round(rng.uniform(0, 1, (4, n)), 2).astype(np.float32)
        bx[:, 10] = bx[:, 3]
        nms_thre = 0.45
        if case == "under_threshold":
            sc = (sc * 0.2).astype(np.float32)
        if case == "multiscale_padded":   # _finalize_batch's candidates
            bx, sc = np.floor(bx[:, :128]), sc[:, :128].copy()
            bx[:, 60:], sc[:, 60:] = 0.0, -1.0
            nms_thre = 0.1
        if case == "single":
            want = jnms.nms_xyxy(jnp.asarray(bx[0]), jnp.asarray(sc[0]),
                                 0.25, nms_thre)
            got = tnms.nms_xyxy(t(bx[0]), t(sc[0]), 0.25, nms_thre)
        else:
            want = jyolo._nms_batch(jnp.asarray(bx), jnp.asarray(sc), 0.25,
                                    nms_thre)
            got = tyolo._nms_batch(t(bx), t(sc), 0.25, nms_thre)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        if case == "under_threshold":
            assert not got[1].any()


def _random_sel(rng, b=6, k=32):
    sel = np.zeros((b, k, 5 + NC), np.float32)
    sel[..., 0:2] = rng.uniform(0, 320, (b, k, 2))
    sel[..., 2:4] = rng.uniform(2, 80, (b, k, 2))
    sel[..., 4:] = rng.uniform(0, 1, (b, k, 1 + NC))
    return sel


@pytest.mark.parametrize("cap", [1024, 16], ids=["roomy", "past_cap"])
def test_sel_nms_and_compact_match_jax(cap):
    """Exact: order, keep, the packed rows, the counts and the total, also
    when more rows are kept than the buffer holds."""
    sel = _random_sel(np.random.default_rng(19))
    jo, jk = jyolo._sel_nms_device(jnp.asarray(sel), pos_thre=0.25,
                                   nms_thre=0.45)
    to, tk = tyolo._sel_nms_device(t(sel), pos_thre=0.25, nms_thre=0.45)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    want = jyolo._compact_kept_device(jnp.asarray(sel), jo, jk, cap)
    got = tyolo._compact_kept_device(t(sel), to, tk, cap)
    assert int(got[2]) > 16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- host halves -----------------------------------------------------------

def _shell(cls, hw=(320, 320), multiscale_pred=2):
    m = cls.__new__(cls)
    m.logger = get_default_logger()
    m.h, m.w = hw
    m.nc = NC
    m.hw_ratio = m.h / m.w
    m.hw_tolerance = 0.2
    m.multiscale_pred = multiscale_pred
    m.multiscale_partition = 2
    return m


@pytest.mark.parametrize("h,w,hw,levels", [
    (544, 960, (320, 320), 1), (540, 960, (320, 320), 2),
    (960, 540, (320, 320), 2), (144, 256, (96, 96), 2),
    (1080, 1920, (640, 640), 3), (600, 600, (320, 320), 2),
    (300, 1000, (320, 640), 2)])
def test_plan_tiles_matches_jax(h, w, hw, levels):
    want = _shell(jyolo.YOLOModel, hw, levels)._plan_tiles(h, w)
    got = _shell(tyolo.YOLOModel, hw, levels)._plan_tiles(h, w)
    assert got == want


def test_unpack_compact_matches_jax():
    """Exact boxes, scores and packed-row indices, also truncated. (The JAX
    package leaves the indices on the model; the port returns them.)"""
    sel = _random_sel(np.random.default_rng(20))
    order, keep = tyolo._sel_nms_device(t(sel), pos_thre=0.25, nms_thre=0.45)
    for cap in (1024, 16):
        packed, counts, total = (x.numpy() for x in
                                 tyolo._compact_kept_device(t(sel), order,
                                                            keep, cap))
        jm, tm = _shell(jyolo.YOLOModel), _shell(tyolo.YOLOModel)
        want = jm._unpack_compact(packed, counts, int(total), 6, (1.5, 0.75))
        got, rowidx = tm._unpack_compact(packed, counts, int(total), 6,
                                         (1.5, 0.75))
        for (gp, gc), (wp, wc) in zip(got, want):
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(gc, wc)
        assert len(rowidx) == len(jm._last_compact_rowidx) == 6
        for g, w_ in zip(rowidx, jm._last_compact_rowidx):
            np.testing.assert_array_equal(g, w_)


# -- the model end to end --------------------------------------------------

W, H = 256, 144


@pytest.fixture(scope="module")
def stacks():
    """Four colour max-stacks of a synthetic sky, each with a streak."""
    frames = generate_meteor_video(
        width=W, height=H, fps=25.0, duration_sec=1.6, n_stars=40,
        noise_sigma=3.0, color=True,
        meteors=[SynthMeteor(start_sec=0.0, end_sec=1.6,
                             pt1=(int(W * 0.7), int(H * 0.2)),
                             pt2=(int(W * 0.2), int(H * 0.8)))])
    return np.stack([frames[i:i + 10].max(axis=0) for i in (0, 10, 20, 30)])


def _models(monkeypatch, **kw):
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    log = get_default_logger()
    jm = jyolo.YOLOModel(WEIGHTS, nms=True, warmup=False, logger=log, **kw)
    tm = tyolo.YOLOModel(WEIGHTS, nms=True, warmup=False, logger=log,
                         device="cpu", **kw)
    assert (tm.h, tm.w) == (jm.h, jm.w) == (96, 96)
    return jm, tm


def _assert_detections_close(got, want):
    """Equal box counts, matched boxes within 2 px, equal class, scores
    within 0.03 (both sides run the body in bfloat16)."""
    (gp, gc), (wp, wc) = got, want
    assert len(gp) == len(wp), (gp, wp)
    left = list(range(len(wp)))
    for p, c in zip(gp, gc):
        j = min(left, key=lambda i: np.abs(wp[i] - p).max())
        left.remove(j)
        assert np.abs(wp[j] - p).max() <= 2, (p, wp[j])
        assert int(np.argmax(c)) == int(np.argmax(wc[j]))
        assert np.abs(c - wc[j]).max() <= 0.03


def test_yolomodel_forward_matches_jax(monkeypatch, stacks):
    """The recheck's call: one image, two pyramid levels. (The first stack
    holds a candidate at the objectness threshold, which bfloat16 rounding
    puts on either side of it; the others do not.)"""
    jm, tm = _models(monkeypatch, multiscale_pred=2)
    n = 0
    for img in stacks[1:3]:
        want, got = jm.forward(img), tm.forward(img)
        _assert_detections_close(got, want)
        n += len(got[0])
    assert n > 0
    gray = tm.forward(stacks[0][..., 1])     # grayscale expands to 3
    assert gray[0].shape[1] == 4 and gray[1].shape[1] == NC


@pytest.mark.parametrize("multiscale_pred", [1, 0],
                         ids=["multiscale", "single_scale_compact"])
def test_yolomodel_batch_paths_match_jax(monkeypatch, stacks,
                                         multiscale_pred):
    """forward_batch (host crops) and dispatch/collect (device crops) on
    the same images, against the JAX package's forward_batch."""
    jm, tm = _models(monkeypatch, multiscale_pred=multiscale_pred)
    want = jm.forward_batch(stacks)
    got_host = tm.forward_batch(stacks)
    handle = tm.dispatch_batch_device(t(stacks))
    assert handle[0] == ("compact" if multiscale_pred == 0 else False)
    got_dev = tm.collect_batch_device(handle)
    assert len(want) == len(got_host) == len(got_dev) == len(stacks)
    for w_, gh, gd in zip(want, got_host, got_dev):
        _assert_detections_close(gh, w_)
        np.testing.assert_array_equal(gd[0], gh[0])
        np.testing.assert_array_equal(gd[1], gh[1])
    assert sum(len(p) for p, _ in got_dev) > 0
    assert tm.forward_batch_device(t(stacks[:0])) == []


def test_forward_propagates_a_levels_exception(monkeypatch, stacks):
    """An exception in one pyramid level ends ``forward`` with it (no level
    is skipped), and a call that raises counts neither as a forward nor as
    a network forward."""
    _, tm = _models(monkeypatch, multiscale_pred=2)
    real = tm._forward_tiles
    seen = []

    def second_level_fails(x, tiles):
        seen.append(len(tiles))
        if len(seen) == 2:
            raise RuntimeError("level failed")
        return real(x, tiles)

    monkeypatch.setattr(tm, "_forward_tiles", second_level_fails)
    tyolo.CALLS.clear()
    with pytest.raises(RuntimeError, match="level failed"):
        tm.forward(stacks[1])
    assert len(seen) == 2
    assert tyolo.CALLS["forward"] == 0 and tyolo.CALLS["network"] == 1
    monkeypatch.setattr(tm, "_forward_tiles", real)
    tm.forward(stacks[1])
    assert tyolo.CALLS["forward"] == 1 and tyolo.CALLS["network"] == 3


def test_missing_weights_raise_and_variables_load(flat, tmp_path,
                                                  monkeypatch):
    """A weight file that does not exist (or is a Git-LFS pointer) raises:
    the port has no random initialisation to fall back on. Arrays handed
    over as ``variables`` load without a file."""
    log = get_default_logger()
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tyolo.YOLOModel(str(tmp_path / "absent.npz"), device="cpu",
                        logger=log)
    pointer = tmp_path / "pointer.npz"
    pointer.write_bytes(b"version https://git-lfs.github.com/spec/v1\noid x")
    with pytest.raises(ValueError, match="Git-LFS pointer"):
        tyolo.YOLOModel(str(pointer), device="cpu", logger=log)
    cfg = ModelCfg(name="YOLOModel", weight_path=str(tmp_path / "no.npz"),
                   dtype="bfloat16", nms=True, warmup=False, pos_thre=0.25,
                   nms_thre=0.45, multiscale_pred=1, multiscale_partition=2)
    with pytest.raises(FileNotFoundError):
        init_model(cfg, log, device="cpu")
    m = tyolo.YOLOModel(variables=flat, nms=True, warmup=True,
                        input_hw=(64, 64), device="cpu", logger=log)
    assert m.model.b0.conv.weight.shape == (32, 3, 6, 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tyolo.YOLOModel(variables=flat, logger=log)   # device="cuda"
