"""PyTorch port: filters, window statistics and the four kernels' plain
versions against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through the JAX function
(its XLA path, or the Pallas kernel with ``interpret=True``) and through
the port. Integer outputs must be equal exactly; ``window_noise_std`` is
held to rtol 1e-6 because the JAX package sums its f32 terms in XLA's
order while the port sums the same integers exactly (they agree exactly
while a frame's sum stays below 2^24, as at these sizes).

The kernels themselves run only on a card; their tests are in
``tests/test_torch_port_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from metdetpy_tpu.ops import filters as jfilters
from metdetpy_tpu.ops import hough as jhough
from metdetpy_tpu.ops import pallas_kernels as jpk
from metdetpy_tpu.ops import windows as jwindows
from metdetpy_tpu_torch.ops import filters, kernels, windows
from metdetpy_tpu_torch.ops import hough as though

# the tensors here are small: two threads run them fastest and leave the
# host's other cores to the other test workers
torch.set_num_threads(2)

SEED = 20261016


@pytest.fixture()
def nrng():
    return np.random.default_rng(SEED)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


# -- filters ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["median3x3", "dilate3x3", "erode3x3",
                                  "close3x3"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_filters_match_jax(nrng, name, dtype):
    img = nrng.integers(0, 256, (3, 17, 29)).astype(dtype)
    want = getattr(jfilters, name)(jnp.asarray(img))
    got = getattr(filters, name)(_t(img))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_binary_threshold_matches_jax(nrng):
    img = nrng.integers(0, 40, (4, 9, 13), dtype=np.uint8)
    thr = nrng.integers(0, 40, 4, dtype=np.uint8)
    want = jfilters.binary_threshold(jnp.asarray(img),
                                     jnp.asarray(thr)[:, None, None])
    got = filters.binary_threshold(_t(img), _t(thr)[:, None, None])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _np(want))


# -- window statistics --------------------------------------------------------

WINDOW_CASES = [(5, 8, 0), (5, 8, 40), (7, 3, 2), (2, 6, 0), (1, 4, 9)]


def _window_inputs(nrng, n, t_block, timer0, h=13, w=24):
    history = nrng.integers(0, 256, (n - 1, h, w), dtype=np.uint8)
    if timer0 == 0:
        history[:] = 0  # stream start: zero-initialized ring
    frames = nrng.integers(0, 256, (t_block, h, w), dtype=np.uint8)
    return history, frames


@pytest.mark.parametrize("n,t_block,timer0", WINDOW_CASES)
def test_window_stats_match_jax(nrng, n, t_block, timer0):
    history, frames = _window_inputs(nrng, n, t_block, timer0)
    want, want_hist = jwindows.window_stats(
        jnp.asarray(history), jnp.asarray(frames), n, jnp.int32(timer0))
    got, got_hist = windows.window_stats(_t(history), _t(frames), n, timer0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_array_equal(got_hist.numpy(), _np(want_hist))


@pytest.mark.parametrize("n,t_block,timer0", WINDOW_CASES)
def test_window_noise_std_matches_jax(nrng, n, t_block, timer0):
    history, frames = _window_inputs(nrng, n, t_block, timer0)
    want, want_hist = jwindows.window_noise_std(
        jnp.asarray(history), jnp.asarray(frames), n, jnp.int32(timer0))
    got, got_hist = windows.window_noise_std(_t(history), _t(frames), n,
                                             timer0)
    assert got.dtype == torch.float32
    # rtol 1e-6: f32 sums in another order (see the module docstring)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got_hist.numpy(), _np(want_hist))


@pytest.mark.parametrize("n,t_block", [(5, 8), (3, 2), (1, 4)])
def test_rolling_sum_matches_jax(nrng, n, t_block):
    history, frames = _window_inputs(nrng, n, t_block, 7)
    want, want_hist = jwindows.rolling_sum_u32(
        jnp.asarray(history), jnp.asarray(frames), n)
    got, got_hist = windows.rolling_sum_u32(_t(history), _t(frames), n)
    np.testing.assert_array_equal(got.numpy(), _np(want).astype(np.int64))
    np.testing.assert_array_equal(got_hist.numpy(), _np(want_hist))


@pytest.mark.parametrize("exp_frame", [1, 3])
def test_merge_exposure_max_matches_jax(nrng, exp_frame):
    frames = nrng.integers(0, 256, (6, 5, 7), dtype=np.uint8)
    want = jwindows.merge_exposure_max(jnp.asarray(frames), exp_frame)
    got = windows.merge_exposure_max(_t(frames), exp_frame)
    np.testing.assert_array_equal(got.numpy(), _np(want))


# -- the four kernels' plain versions -----------------------------------------


@pytest.mark.parametrize("n,t_block,timer0", WINDOW_CASES[:4])
def test_window_diff_plain_matches_pallas_kernel(nrng, n, t_block, timer0):
    """Plain window diff == the Pallas streaming kernel (interpret mode)
    == the XLA fallback (window_stats.diff)."""
    h, w = 16, 128
    history, frames = _window_inputs(nrng, n, t_block, timer0, h, w)
    seq = jnp.concatenate([jnp.asarray(history), jnp.asarray(frames)], 0)
    lengths = jnp.minimum(timer0 + 1 + jnp.arange(t_block, dtype=jnp.int32),
                          n)
    s_rows = 8
    pallas = pl.pallas_call(
        functools.partial(jpk._wd_kernel_stream, n=n, t_block=t_block),
        out_shape=jax.ShapeDtypeStruct((t_block, h, w), jnp.uint8),
        grid=(h // s_rows,),
        in_specs=[pl.BlockSpec(),
                  pl.BlockSpec((n + t_block - 1, s_rows, w),
                               lambda b: (0, b, 0))],
        out_specs=pl.BlockSpec((t_block, s_rows, w), lambda b: (0, b, 0)),
        interpret=True,
    )(lengths.reshape(t_block, 1), seq)
    xla, xla_hist = jpk.window_diff(jnp.asarray(history),
                                    jnp.asarray(frames), n,
                                    jnp.int32(timer0))
    diff, new_hist = kernels.window_diff(_t(history), _t(frames), n, timer0)
    np.testing.assert_array_equal(diff.numpy(), _np(pallas))
    np.testing.assert_array_equal(diff.numpy(), _np(xla))
    np.testing.assert_array_equal(new_hist.numpy(), _np(xla_hist))


def test_median_binarize_close_plain_matches_pallas_kernel(nrng):
    """Plain median -> threshold -> close == the Pallas kernel (interpret
    mode) == the XLA fallback, across several row strips and borders."""
    t, h, w = 3, 70, 40
    diff = nrng.integers(0, 40, (t, h, w), dtype=np.uint8)
    thr = np.array([5, 9, 15], dtype=np.uint8)
    pallas = pl.pallas_call(
        jpk._kernel,
        out_shape=jax.ShapeDtypeStruct((t, h, w), jnp.uint8),
        grid=(t,),
        in_specs=[pl.BlockSpec(),
                  pl.BlockSpec((1, h, w), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, h, w), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(thr.reshape(t, 1), jnp.int32), jnp.asarray(diff))
    xla = jpk.fused_median_binarize_close(jnp.asarray(diff),
                                          jnp.asarray(thr))
    got = kernels.median_binarize_close(_t(diff), _t(thr))
    np.testing.assert_array_equal(got.numpy(), _np(pallas))
    np.testing.assert_array_equal(got.numpy(), _np(xla))


def test_hough_vote_plain_matches_pallas_kernel(nrng):
    """Plain vote == the Pallas vote kernel (interpret mode) == the XLA
    one-hot path, with full, partial and empty point lists."""
    h, w = 96, 160
    n_rho = though._round_up(2 * (w + h) + 1, 128)
    t, n = 3, 256
    xs = nrng.integers(0, w, (t, n)).astype(np.float32)
    ys = nrng.integers(0, h, (t, n)).astype(np.float32)
    valid = np.arange(n)[None, :] < np.array([n, n // 3, 0])[:, None]
    args = (jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(valid))
    pallas = jpk.hough_vote_pallas(*args, n_rho, w + h, interpret=True)
    xla = jax.vmap(lambda x_, y_, v_: jhough._vote(
        x_, y_, v_, 180, n_rho, w + h, 30))(*args)
    got = kernels.hough_vote(_t(xs), _t(ys), _t(valid), n_rho, w + h)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(pallas))
    np.testing.assert_array_equal(got.numpy(), _np(xla))


def test_walk_pick_plain_matches_onehot_and_pallas(nrng):
    """Plain pick == hough._picks_onehot on EVERY column (rows outside the
    plane give 0), and == the banded Pallas kernel (interpret mode) on the
    columns the walk keeps."""
    t, k, s = 2, 8, 384
    planes = nrng.integers(0, 16, (t, 2, s, s), dtype=np.uint8)
    cols = np.arange(s, dtype=np.float32)
    r = np.zeros((t, k, s), np.int32)
    inp = np.zeros((t, k, s), bool)
    for ti in range(t):
        for ki in range(k):
            rr = np.floor(nrng.integers(-40, s + 40)
                          + nrng.uniform(-1, 1) * cols).astype(np.int32)
            r[ti, ki] = rr
            lo, hi = sorted(nrng.choice(s, 2, replace=False))
            inp[ti, ki, lo:hi + 1] = (rr[lo:hi + 1] >= 0) & (rr[lo:hi + 1]
                                                             < s)
    xmaj = nrng.integers(0, 2, (t, k)).astype(bool)
    onehot = jax.vmap(jhough._picks_onehot)(
        jnp.asarray(planes), jnp.asarray(r), jnp.asarray(xmaj))
    r0 = jax.vmap(lambda r_, ip: jpk._pick_row_bands(r_, ip, s))(
        jnp.asarray(r), jnp.asarray(inp))
    pallas = jpk.walk_pick_pallas(jnp.asarray(planes), jnp.asarray(r),
                                  jnp.asarray(xmaj), r0, interpret=True)
    got = kernels.walk_pick(_t(planes), _t(r), _t(xmaj))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(onehot))
    np.testing.assert_array_equal(got.numpy() * inp, _np(pallas) * inp)


def test_wrappers_take_plain_version_only_on_cpu(nrng):
    """On CPU tensors the wrappers run the plain version and count no
    launch; on any device other than CPU or CUDA they raise."""
    kernels.reset_launch_counts()
    diff = _t(nrng.integers(0, 40, (2, 9, 11), dtype=np.uint8))
    thr = _t(np.array([3, 7], np.uint8))
    kernels.median_binarize_close(diff, thr)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.median_binarize_close(diff.to("meta"), thr.to("meta"))
