"""PyTorch port of ``ops/transforms.py`` on the CPU against the jitted JAX
functions (inputs from seeded numpy).

Exact for every function but ``resize_bilinear``: its weights are exact
when scaling up or by two, but when scaling down XLA fuses some of the
weight arithmetic's multiply-adds and not others, depending on the shape,
and in every case the weight products sum in XLA's own order, so an
output that lands on a rounding tie can differ by 1 (ROADMAP.md section
3). The tolerance, set from those measurements: |diff| <= 1 in at most
0.05% of the pixels. The ``*_exact`` functions also equal cv2.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from metdetpy_tpu.ops import transforms as J
from metdetpy_tpu_torch.ops import transforms as T

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _all_bgr():
    """Every 8-bit (b, g, r) triple, as one [256^3, 3] image."""
    v = np.arange(256, dtype=np.uint8)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    return np.stack([b.ravel(), g.ravel(), r.ravel()], -1)


@pytest.mark.parametrize("name", ["bgr2gray", "rgb2gray", "bgr2gray_exact"])
def test_gray_conversions_exact_on_every_triple(name):
    img = _all_bgr()
    want = np.asarray(jax.jit(getattr(J, name))(img))
    got = getattr(T, name)(_t(img)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_bgr2gray_exact_equals_cv2():
    img = np.random.default_rng(1).integers(0, 256, (2, 40, 56, 3),
                                            np.uint8)
    got = T.bgr2gray_exact(_t(img)).numpy()
    for t in range(2):
        np.testing.assert_array_equal(
            got[t], cv2.cvtColor(img[t], cv2.COLOR_BGR2GRAY))


def test_gray2bgr_and_u16_to_u8():
    rng = np.random.default_rng(2)
    g = rng.integers(0, 256, (3, 17, 9), np.uint8)
    np.testing.assert_array_equal(T.gray2bgr(_t(g)).numpy(),
                                  np.asarray(jax.jit(J.gray2bgr)(g)))
    u16 = rng.integers(0, 65536, (3, 17, 9), np.uint16)
    u16[0, 0, :4] = [0, 256, 257, 65535]
    np.testing.assert_array_equal(
        T.u16_to_u8(_t(u16.astype(np.int32))).numpy(),
        np.asarray(jax.jit(J.u16_to_u8)(u16)))


@pytest.mark.parametrize("shape", [(4, 108, 192), (2, 64, 96, 3),
                                   (3, 38, 54), (1, 2, 6, 3)])
def test_downscale2x_exact(shape):
    """Equal to jitted JAX and to cv2.resize INTER_LINEAR; an odd size is
    refused."""
    x = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    got = T.downscale2x_exact(_t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(J.downscale2x_exact)(x)))
    h, w = shape[1], shape[2]
    for t in range(shape[0]):
        np.testing.assert_array_equal(got[t], cv2.resize(
            x[t], (w // 2, h // 2), interpolation=cv2.INTER_LINEAR))
    with pytest.raises(ValueError, match="odd"):
        T.downscale2x_exact(_t(x)[:, 1:])


@pytest.mark.parametrize("down2,color", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_make_block_preprocess(down2, color):
    shape = (3, 36, 64, 3) if color else (3, 36, 64)
    x = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    want = np.asarray(J.make_block_preprocess(down2, color)(x))
    got = T.make_block_preprocess(down2, color)(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,wh", [
    ((3, 37, 53), (80, 70)),          # up
    ((2, 20, 30, 3), (61, 47)),       # up, colour
    ((4, 108, 192), (96, 54)),        # 2:1 down
    ((4, 108, 192), (100, 60)),       # down
    ((2, 64, 96, 3), (150, 101)),     # up
    ((2, 50, 70), (70, 33)),          # mixed
    ((6, 135, 240), (97, 41)),        # down
    ((2, 540, 960), (640, 360)),      # down, 960x540 -> 640x360
])
def test_resize_bilinear(shape, wh):
    x = np.random.default_rng(5).integers(0, 256, shape, np.uint8)
    want = np.asarray(jax.jit(J.resize_bilinear, static_argnums=1)(x, wh))
    got = T.resize_bilinear(_t(x), wh).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).sum() <= 5e-4 * diff.size, int((diff > 0).sum())


def test_resize_weights_exact_when_scaling_up_and_by_two():
    from jax._src.image import scale as S
    for m, n in [(53, 80), (37, 70), (20, 61), (108, 54), (1080, 540)]:
        want = np.asarray(jax.jit(lambda m=m, n=n: S.compute_weight_mat(
            m, n, n / m, 0., S._fill_triangle_kernel, True))())
        np.testing.assert_array_equal(T._triangle_weight_mat(m, n), want)


@pytest.mark.parametrize("pattern", ["BGGR", "RGGB"])
def test_debayer_bilinear(pattern):
    x = np.random.default_rng(6).integers(0, 256, (3, 20, 31), np.uint8)
    want = np.asarray(jax.jit(J.debayer_bilinear, static_argnums=1)(
        x, pattern))
    np.testing.assert_array_equal(
        T.debayer_bilinear(_t(x), pattern).numpy(), want)


def test_transform_pipeline():
    """The composable pipeline, op for op as the JAX Transform."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (2, 24, 40), np.uint8)
    mask = (rng.random((24, 40)) > 0.2).astype(np.uint8)
    outs = []
    for mod, conv in ((J, np.asarray), (T, lambda t: t.numpy())):
        tr = mod.Transform()
        tr.opencv_debayer("RGGB")
        tr.opencv_BGR2GRAY()
        tr.mask_with(mask)
        tr.opencv_binary(60, maxval=200)
        tr.expand_3rd_channel(3)
        tr.opencv_RGB2GRAY()
        tr.opencv_GRAY2BGR()
        tr.opencv_resize([20, 12])
        inp = x if mod is J else _t(x)
        outs.append(conv(jax.jit(tr)(inp) if mod is J else tr(inp)))
    np.testing.assert_array_equal(outs[1], outs[0])
    inv = []
    for mod in (J, T):
        tr = mod.Transform()
        tr.opencv_binary(100, inv=True)
        tr.u16_to_u8()
        inv.append(np.asarray(tr(x if mod is J else _t(x))))
    np.testing.assert_array_equal(inv[1], inv[0])
