"""PyTorch port: the Hough extraction against the JAX package on the CPU.

The cos/sin tables are pinned bit-exactly against ``jnp``; the vote's rho
must reproduce the fused multiply-add XLA's CPU backend forms (a plain
unfused f32 evaluation differs, and the test shows it). Every stage and
``hough_lines_batch`` as a whole are exact: on ``valid``, ``lines[valid]``,
``npix`` and ``overflow`` (invalid line slots carry no meaning; the JAX
package's speed branches fill them differently, the port zeroes them).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.ops import hough as jhough
from metdetpy_tpu_torch.ops import hough as though
from metdetpy_tpu_torch.ops import filters, kernels
from metdetpy_tpu_torch.ops.f32 import fma_f32, trig_tables

# the tensors here are small: two threads run them fastest and leave the
# host's other cores to the other test workers
torch.set_num_threads(2)

SEED = 20261016


@pytest.fixture()
def nrng():
    return np.random.default_rng(SEED)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jnp_trig():
    th = jnp.arange(180, dtype=jnp.float32) * jnp.float32(np.pi / 180)
    return np.asarray(jnp.cos(th)), np.asarray(jnp.sin(th))


def test_trig_tables_bit_exact_with_jnp():
    cos_t, sin_t = trig_tables(torch.device("cpu"))
    jc, js = _jnp_trig()
    np.testing.assert_array_equal(cos_t.numpy().view(np.uint32),
                                  jc.view(np.uint32))
    np.testing.assert_array_equal(sin_t.numpy().view(np.uint32),
                                  js.view(np.uint32))


def test_vote_rho_needs_the_fused_multiply_add(nrng):
    """At 960x540 with 8192 points, rho = fma(cos, x, sin*y) + off equals
    what jnp computes for cos*x + sin*y + off, and the votes are equal;
    the unfused f32 evaluation differs in rho and in the votes."""
    h, w, n = 540, 960, 8192
    off = w + h
    n_rho = though._round_up(2 * (w + h) + 1, 128)
    xs = nrng.integers(0, w, (1, n)).astype(np.float32)
    ys = nrng.integers(0, h, (1, n)).astype(np.float32)
    jc, js = _jnp_trig()
    want_rho = np.asarray(jax.jit(
        lambda x, y: jnp.asarray(jc)[:, None] * x[None, :]
        + jnp.asarray(js)[:, None] * y[None, :] + jnp.float32(off))(
        jnp.asarray(xs[0]), jnp.asarray(ys[0])))
    cos_t, sin_t = trig_tables(torch.device("cpu"))
    x, y = _t(xs[0])[None, :], _t(ys[0])[None, :]
    fused = fma_f32(cos_t[:, None], x, sin_t[:, None] * y) + float(off)
    unfused = cos_t[:, None] * x + sin_t[:, None] * y + float(off)
    np.testing.assert_array_equal(fused.numpy(), want_rho)
    assert (unfused.numpy() != want_rho).sum() > 1000

    valid = np.ones((1, n), bool)
    want = jax.vmap(lambda a, b, v: jhough._vote(
        a, b, v, 180, n_rho, off, 30))(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(valid))
    got = kernels.hough_vote(_t(xs), _t(ys), _t(valid), n_rho, off)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want)[0])
    q_unfused = torch.clamp(torch.round(unfused).long(), 0, n_rho - 1)
    plain_votes = torch.zeros(180 * n_rho, dtype=torch.int64)
    plain_votes.index_add_(0, (torch.arange(180)[:, None] * n_rho
                               + q_unfused).reshape(-1),
                           torch.ones(180 * n, dtype=torch.int64))
    assert (plain_votes.view(180, n_rho).numpy()
            != np.asarray(want)[0]).any()


@pytest.mark.parametrize("k", [1, 7, 64])
def test_compact_indices_matches_jax(nrng, k):
    flat = (nrng.random((3, 2000)) < np.array([[0.0], [0.002], [0.2]])
            ).astype(np.uint8)
    want = [jhough._compact_indices(jnp.asarray(f), k) for f in flat]
    idx, valid = though.compact_indices(_t(flat), k)
    for i, (wi, wv) in enumerate(want):
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(wi))


def _votes_with_peaks(nrng, n_peaks, n_rho=384, base=3):
    votes = nrng.integers(0, base, (180, n_rho)).astype(np.int32)
    th = nrng.choice(180, n_peaks, replace=False)
    rh = nrng.integers(0, n_rho, n_peaks)
    votes[th, rh] = nrng.integers(11, 400, n_peaks)
    return votes


def test_find_peaks_matches_jax_including_crowd_guard(nrng):
    """A quiet frame, a frame with a few peaks, and a crowded frame with
    far more than max_peaks peaks (the crowd-guard ladder raises the
    cutoff)."""
    votes = np.stack([np.zeros((180, 384), np.int32),
                      _votes_with_peaks(nrng, 5),
                      _votes_with_peaks(nrng, 150)])
    got = though.find_peaks(_t(votes), 10, 64)
    for i in range(3):
        want = jhough._find_peaks(jnp.asarray(votes[i]), 10, 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    ok = got[2][2].numpy()
    assert 0 < ok.sum() <= 64


def test_pack_corners_matches_jax(nrng):
    img = (nrng.random((2, 11, 17)) < 0.4).astype(np.uint8)
    np.testing.assert_array_equal(
        though.pack_corners(_t(img)).numpy(),
        np.asarray(jhough.pack_corners(jnp.asarray(img))))


def _peaks(nrng, b, k, h, w):
    n_rho = though._round_up(2 * (w + h) + 1, 128)
    th = nrng.integers(0, 180, (b, k)).astype(np.int32)
    rh = nrng.integers(0, n_rho, (b, k)).astype(np.int32)
    return th, rh


def test_walk_geom_and_finish_match_jax(nrng):
    """Walk geometry (bit-exact f32, incl. the contractions XLA forms when
    the JAX package compiles it, as inside hough_lines_batch) and the
    bilinear acceptance + run analysis + endpoints."""
    h, w, b, k = 144, 256, 2, 64
    s = though._round_up(max(h, w) + 1, 128)
    n_steps = though._round_up(max(h, w) + 4, 128)
    th, rh = _peaks(nrng, b, k, h, w)
    v = nrng.integers(0, 16, (b, k, s)).astype(np.int32)
    v[nrng.random((b, k, s)) < 0.6] = 0
    ok = nrng.random((b, k)) < 0.8
    gaps = np.array([0.0, 7.5], np.float32)

    @jax.jit
    def reference(th_, rh_, v_, ok_, gaps_):
        geom = jax.vmap(lambda t_, r_: jhough._walk_geom(
            t_, r_, w + h, n_steps, h, w, s))(th_, rh_)
        return geom, jax.vmap(lambda v1, g1, o1, gap: jhough._finish_segments(
            v1, g1, o1, 10, gap, h, w))(v_, geom, ok_, gaps_)

    want_geom, (want_lines, want_ok) = reference(th, rh, v, ok, gaps)
    got = though.walk_geom(_t(th), _t(rh), w + h, n_steps, h, w, s)
    for name, g in got._asdict().items():
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(getattr(want_geom, name)), err_msg=name)
    lines, line_ok = though.finish_segments(_t(v), got, _t(ok), 10,
                                            _t(gaps), h, w)
    np.testing.assert_array_equal(line_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(lines.numpy(), np.asarray(want_lines))


def _scene(nrng, t, h, w):
    out = np.zeros((t, h, w), np.uint8)
    for i in range(t):
        for _ in range(nrng.integers(1, 4)):
            p1 = tuple(int(c) for c in nrng.integers(0, [w, h]))
            p2 = tuple(int(c) for c in nrng.integers(0, [w, h]))
            cv2.line(out[i], p1, p2, 255, int(nrng.integers(1, 4)))
        out[i][nrng.random((h, w)) < 0.003] = 255
    return out


def _assert_hough_equal(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.lines.numpy()[valid],
                                  np.asarray(want.lines)[valid])
    np.testing.assert_array_equal(got.lines.numpy()[~valid], 0)
    np.testing.assert_array_equal(got.npix.numpy(), np.asarray(want.npix))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_hough_lines_batch_matches_jax(nrng):
    """Random line scenes plus a crowd-guard frame (a thick blob with more
    than max_peaks peaks), an overflow frame (more active pixels than
    max_points) and an empty frame."""
    h, w, t = 144, 256, 8
    dst = _scene(nrng, t, h, w)
    dst[5] = 0
    cv2.line(dst[5], (20, 20), (230, 120), 255, 9)        # crowd guard
    dst[6][nrng.random((h, w)) < 0.1] = 255                # overflow
    dst[7] = 0                                             # empty
    gaps = nrng.uniform(0, 10, t).astype(np.float32)
    kw = dict(threshold=10, min_len=10, max_points=2048, max_peaks=64)
    want = jhough.hough_lines_batch(jnp.asarray(dst), jnp.asarray(gaps),
                                    **kw)
    got = though.hough_lines_batch(_t(dst), _t(gaps), **kw)
    _assert_hough_equal(got, want)
    assert bool(np.asarray(want.overflow)[6])
    assert np.asarray(want.valid)[:5].sum() > 0


def test_hough_lines_batch_crowd_frame_uses_cutoff(nrng):
    """The crowd-guard frame alone: more than max_peaks raw peaks, and the
    port keeps the same (strongest) ones as the JAX package."""
    h, w = 144, 256
    dst = np.zeros((1, h, w), np.uint8)
    cv2.line(dst[0], (10, 30), (240, 110), 255, 11)
    gaps = np.array([5.0], np.float32)
    kw = dict(threshold=10, min_len=10, max_points=8192, max_peaks=16)
    want = jhough.hough_lines_batch(jnp.asarray(dst), jnp.asarray(gaps),
                                    **kw)
    got = though.hough_lines_batch(_t(dst), _t(gaps), **kw)
    _assert_hough_equal(got, want)
    votes = kernels.hough_vote_plain(
        *[x for x in _points(dst[0])],
        though._round_up(2 * (w + h) + 1, 128), w + h)
    raw = (votes >= filters.dilate3x3(votes)) & (votes > 10)
    assert int(raw.sum()) > 16


def _points(img):
    ys, xs = np.nonzero(img)
    return (_t(xs.astype(np.float32))[None], _t(ys.astype(np.float32))[None],
            torch.ones((1, len(xs)), dtype=torch.bool))
