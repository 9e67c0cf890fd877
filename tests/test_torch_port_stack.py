"""PyTorch port's stackers (``metdetpy_tpu_torch/ops/stack.py``,
``ops/stack_device.py``) against the JAX package's on the CPU.

- Host stackers: exact, port against JAX, for ``FastGaussianContainer``,
  ``single_sigma_clipping``, ``_host_median``, ``median_of_medians``,
  ``simple_denoise`` and the host ``mfnr_mix_stacker`` for every
  background algorithm.
- The device median (``median_frames``, ``stack_median`` forced to the
  device with ``device="cpu"``) against the jitted ``jnp.median``: exact on
  even and odd stacks (the values are integers or halves).
- ``mfnr_mix_device(..., device="cpu")`` against the JAX package's
  ``mfnr_mix_device`` under ``JAX_PLATFORMS=cpu``, in the cases of
  ``tests/test_stack.py``: the u8 output exact (the port writes out XLA's
  CPU multiply-add contractions and folded constants), ``est_bg_mu``
  exact, the stage statistics keys and ``h2d_bytes`` equal.
- Failures propagate: a device median or device MFNR that raises, a
  placement probe that raises and a loader that raises mid-stack end the
  call (the JAX package falls back or logs).
"""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metdetpy_tpu.io.videoloader import ThreadVideoLoader as JThreadLoader
from metdetpy_tpu.io.videowrapper import NumpyVideoWrapper as JNumpy
from metdetpy_tpu.log import BaseMetLog as JLog
from metdetpy_tpu.ops import stack as jstk
from metdetpy_tpu.ops import stack_device as jsd
from metdetpy_tpu.structs import ClipCfg as JClipCfg
from metdetpy_tpu_torch.io.videoloader import ThreadVideoLoader
from metdetpy_tpu_torch.io.videowrapper import NumpyVideoWrapper
from metdetpy_tpu_torch.log import BaseMetLog
from metdetpy_tpu_torch.ops import stack as stk
from metdetpy_tpu_torch.ops import stack_device as sd
from metdetpy_tpu_torch.structs import ClipCfg
from metdetpy_tpu_torch.utils import relative2abs_path

torch.set_num_threads(2)
BG_ALGOS = ("mean", "median", "sigma-clipping", "med-of-med")


def _frames(rng, n=16, h=96, w=128):
    """tests/test_stack.py's clip: noise and a moving streak."""
    frames = rng.integers(0, 60, (n, h, w, 3), np.uint8)
    for t in range(4, min(12, n)):
        p = (10 + 8 * (t - 4), 20 + 5 * (t - 4))
        cv2.line(frames[t], p, (p[0] + 12, p[1] + 8), (250, 250, 250), 2)
    return frames


def _window_frames(rng):
    """Quiet background and one small bright blob (a small fg window)."""
    frames = rng.integers(0, 12, (16, 192, 256, 3), np.uint8)
    frames[5:9, 40:48, 60:70] = 250
    return frames


def _denoise_cfgs(bg="mean", connect=True):
    path = relative2abs_path("./global/clip_cfg.json")
    out = []
    for cls in (JClipCfg, ClipCfg):
        dn = cls.from_json_file(path).image_denoise
        dn.algorithm = "mfnr-mix"
        dn.mfnr_param.bg_algorithm = bg
        dn.connect_lines.switch = connect
        out.append(dn)
    return out   # (jax, port)


def _jloader(frames):
    return JThreadLoader(JNumpy, frames.copy(), exp_option="real-time",
                         merge_func="max", grayscale=False)


def _ploader(frames):
    return ThreadVideoLoader(NumpyVideoWrapper, frames.copy(),
                             exp_option="real-time", merge_func="max",
                             grayscale=False)


# -- host stackers -------------------------------------------------------------

def test_fast_gaussian_container_equals_jax(rng):
    frames = _frames(rng, n=9)
    got, want = stk.FastGaussianContainer(), jstk.FastGaussianContainer()
    for f in frames:
        got.append(f)
        want.append(f)
    g, w = got.export(), want.export()
    for attr in ("sum_mu", "square_sum", "n", "mu", "var"):
        a, b = getattr(g, attr), getattr(w, attr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(stk._var_f32(g), jstk._var_f32(w))


def test_fast_gaussian_container_u16_sum_wraps_as_jax():
    """The uint16 sum wraps after 257 frames of 255, in both packages (the
    device accumulators are int64 and do not)."""
    frame = np.full((2, 3, 3), 255, np.uint8)
    got, want = stk.FastGaussianContainer(), jstk.FastGaussianContainer()
    for _ in range(258):
        got.append(frame)
        want.append(frame)
    np.testing.assert_array_equal(got.export().sum_mu, want.export().sum_mu)
    assert int(got.export().sum_mu[0, 0, 0]) == (258 * 255) % 65536


@pytest.mark.parametrize("sigma", [(3.0, 3.0), (2.0, 1.5)])
def test_single_sigma_clipping_equals_jax(rng, sigma):
    frames = _frames(rng, n=10)
    full_p, full_j = stk.FastGaussianContainer(), jstk.FastGaussianContainer()
    for f in frames:
        full_p.append(f)
        full_j.append(f)
    got = stk.single_sigma_clipping(list(frames), full_p.export(), *sigma)
    want = jstk.single_sigma_clipping(list(frames), full_j.export(), *sigma)
    for attr in ("sum_mu", "square_sum", "n", "mu"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


@pytest.mark.parametrize("n", [1, 2, 7, 8])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_host_median_equals_jax_and_np_median(rng, n, dtype):
    stack = rng.integers(0, 256, (n, 9, 11, 3)).astype(dtype)
    if dtype == np.float32:
        stack = stack / 2   # halves, as the med-of-med second pass takes
    got = stk._host_median(list(stack))
    np.testing.assert_array_equal(got, jstk._host_median(list(stack)))
    np.testing.assert_array_equal(got, np.median(stack, axis=0))


@pytest.mark.parametrize("n", [9, 16, 18])
def test_median_of_medians_equals_jax(rng, n):
    frames = list(_frames(rng, n=n, h=24, w=32))
    np.testing.assert_array_equal(
        stk.median_of_medians(frames, device="cpu"),
        jstk.median_of_medians(frames))


@pytest.mark.parametrize("connect", [True, False])
def test_simple_denoise_equals_jax(rng, connect):
    frames = _frames(rng)
    jdn, pdn = _denoise_cfgs(connect=connect)
    max_img = frames.max(axis=0)
    np.testing.assert_array_equal(
        stk.simple_denoise(max_img, pdn, BaseMetLog()),
        jstk.simple_denoise(max_img, jdn, JLog()))
    np.testing.assert_array_equal(
        stk.simple_denoise_stacker(_ploader(frames), pdn),
        jstk.simple_denoise_stacker(_jloader(frames), jdn))


@pytest.mark.parametrize("bg", BG_ALGOS)
@pytest.mark.parametrize("connect", [True, False])
def test_host_mfnr_mix_stacker_equals_jax(rng, monkeypatch, bg, connect):
    """The host path (the JAX package with its device path off, the port
    on the CPU, where the placement keeps the host) is exact."""
    frames = _frames(rng, n=18)
    jdn, pdn = _denoise_cfgs(bg, connect)
    monkeypatch.setenv("METDETPY_TPU_DEVICE_DENOISE", "0")
    want = jstk.mfnr_mix_stacker(_jloader(frames), jdn)
    monkeypatch.delenv("METDETPY_TPU_DEVICE_DENOISE")
    sd.last_run_stats.clear()
    got = stk.mfnr_mix_stacker(_ploader(frames), pdn, device="cpu")
    assert sd.last_run_stats == {}   # the device path did not run
    np.testing.assert_array_equal(got, want)


def test_max_and_all_stackers_equal_jax(rng):
    frames = _frames(rng, n=6)
    np.testing.assert_array_equal(stk.max_stacker(_ploader(frames)),
                                  jstk.max_stacker(_jloader(frames)))
    got = stk.all_stacker(_ploader(frames), start_frame=1, end_frame=4)
    want = jstk.all_stacker(_jloader(frames), start_frame=1, end_frame=4)
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_snr_and_gumbel_equal_jax(rng):
    img = _frames(rng, n=3).max(axis=0)
    assert stk.estimate_snr_smooth_residual(img) == \
        jstk.estimate_snr_smooth_residual(img)
    for n in (2, 12, 64):
        assert stk.get_gumbel_mean(n) == jstk.get_gumbel_mean(n)


# -- the device median -----------------------------------------------------------

_JNP_MEDIAN = jax.jit(lambda x: jnp.median(x.astype(jnp.float32), axis=0))


@pytest.mark.parametrize("n", [1, 2, 5, 16, 17])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_median_frames_equals_jitted_jnp_median(rng, n, dtype):
    stack = rng.integers(0, 256, (n, 12, 10, 3)).astype(dtype)
    if dtype == np.float32:
        stack = stack / 2
    got = stk.median_frames(torch.from_numpy(stack))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(_JNP_MEDIAN(stack)))


@pytest.mark.parametrize("n", [6, 7])
def test_stack_median_forced_to_the_device_equals_jax(rng, monkeypatch, n):
    """With the size gate lowered, ``stack_median`` forced to the device
    (here the CPU) equals the jitted ``jnp.median`` and the host median."""
    frames = list(rng.integers(0, 256, (n, 20, 24, 3), np.uint8))
    monkeypatch.setattr(stk, "DEVICE_MEDIAN_MIN_ELEMS", 1)
    monkeypatch.setenv("METDETPY_TPU_DEVICE_MEDIAN", "force")
    calls = []
    orig = stk.median_frames
    monkeypatch.setattr(stk, "median_frames",
                        lambda x: calls.append(x.shape) or orig(x))
    got = stk.stack_median(frames, device="cpu")
    assert calls == [(n, 20, 24, 3)] and got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(_JNP_MEDIAN(
        np.stack(frames))))
    np.testing.assert_array_equal(got, jstk._host_median(frames))
    monkeypatch.setenv("METDETPY_TPU_DEVICE_MEDIAN", "auto")
    calls.clear()
    np.testing.assert_array_equal(stk.stack_median(frames, device="cpu"),
                                  got)
    assert calls == []   # auto on the CPU: the host median


# -- device MFNR on the CPU against the JAX package's ---------------------------

def _both_device(frames, bg, connect, monkeypatch, host_reduce=None):
    jdn, pdn = _denoise_cfgs(bg, connect)
    if host_reduce is None:
        monkeypatch.delenv("METDETPY_TPU_MFNR_HOST_REDUCE", raising=False)
    else:
        monkeypatch.setenv("METDETPY_TPU_MFNR_HOST_REDUCE", host_reduce)
    want = jsd.mfnr_mix_device(_jloader(frames), jdn)
    want_stats = dict(jsd.last_run_stats)
    got = sd.mfnr_mix_device(_ploader(frames), pdn, device="cpu")
    return got, want, dict(sd.last_run_stats), want_stats


def _assert_same_run(got, want, stats, want_stats):
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert sorted(stats) == sorted(want_stats)
    assert stats["placement"] == want_stats["placement"]
    assert stats.get("h2d_bytes") == want_stats.get("h2d_bytes")


@pytest.mark.parametrize("bg", BG_ALGOS)
@pytest.mark.parametrize("connect", [True, False])
@pytest.mark.parametrize("n", [12, 18])
def test_mfnr_device_full_upload_equals_jax(rng, monkeypatch, bg, connect, n):
    frames = _frames(rng, n=n)
    got, want, stats, want_stats = _both_device(
        frames, bg, connect, monkeypatch, "0" if bg == "mean" else None)
    assert stats["placement"] == "full-upload"
    assert stats["h2d_bytes"] == frames.nbytes
    _assert_same_run(got, want, stats, want_stats)


@pytest.mark.parametrize("connect", [True, False])
@pytest.mark.parametrize("case", ["streak", "window", "empty"])
def test_mfnr_device_host_reduced_equals_jax(rng, monkeypatch, connect,
                                             case):
    """Host-reduced placement: the whole frame (a streak clip), the fg
    window of a small blob, and no foreground (no upload at all)."""
    frames = {"streak": lambda: _frames(rng, n=18),
              "window": lambda: _window_frames(rng),
              "empty": lambda: np.full((12, 64, 96, 3), 40, np.uint8)}[case]()
    got, want, stats, want_stats = _both_device(frames, "mean", connect,
                                                monkeypatch, "1")
    assert stats["placement"] == "host-reduced-upload"
    if case == "empty":
        assert stats["h2d_bytes"] == 0
    elif case == "window":
        assert 0.0 < stats["window_px_frac"] < 0.5
        assert stats["window_px_frac"] == want_stats["window_px_frac"]
    _assert_same_run(got, want, stats, want_stats)


@pytest.mark.parametrize("case", ["window", "empty"])
@pytest.mark.parametrize("bg", BG_ALGOS)
def test_mfnr_device_full_upload_other_clips_equal_jax(rng, monkeypatch,
                                                       case, bg):
    frames = (_window_frames(rng) if case == "window"
              else np.full((12, 64, 96, 3), 40, np.uint8))
    got, want, stats, want_stats = _both_device(
        frames, bg, True, monkeypatch, "0" if bg == "mean" else None)
    _assert_same_run(got, want, stats, want_stats)


@pytest.mark.parametrize("use_ext", [False, True])
@pytest.mark.parametrize("n", [12, 18])
def test_mfnr_stage_one_equals_jax(rng, use_ext, n):
    """The first stage on the same accumulators: ``est_bg_mu`` exact; the
    background std (an f32 sum over the frame, in XLA's order there and
    summed in float64 here) within 1e-6 relative, and with it the bias
    within 1e-5 (a few ulps); the foreground mask and its feather exact."""
    frames = _frames(rng, n=n)
    mx = frames.max(axis=0)
    s = frames.astype(np.uint32).sum(axis=0)
    sq = (frames.astype(np.uint32) ** 2).sum(axis=0)
    n = len(frames)
    taps = sd._gaussian_kernel_f32(31, 3.0)
    bg_mu = (stk._host_median(list(frames)).astype(np.float32) if use_ext
             else None)
    bg_var = np.float32(2.5) if use_ext else None
    kw = dict(hp=0.9, gumbel=stk.get_gumbel_mean(n), bg_fix_factor=1.5)
    want = jax.jit(functools.partial(
        jsd._jit_stage1, use_ext_bg=use_ext, use_ext_var=use_ext, **kw))(
        mx, s, sq, np.int32(n),
        bg_mu if use_ext else jnp.zeros((), jnp.float32),
        bg_var if use_ext else jnp.zeros((), jnp.float32), jnp.asarray(taps))
    t = torch.from_numpy
    got = sd._stage1(t(mx), t(s.astype(np.int64)), t(sq.astype(np.int64)), n,
                     None if bg_mu is None else t(bg_mu),
                     None if bg_var is None else torch.tensor(bg_var),
                     t(taps), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("hw", [(64, 96), (9, 13), (1, 40)])
def test_feather_blur_equals_jax_any_size(rng, hw):
    """The reflect-101 blur against the jitted JAX one on 0/1 masks and on
    f32 noise, down to frames smaller than the blur's radius."""
    taps = sd._gaussian_kernel_f32(31, 3.0)
    blur = jax.jit(jsd._blur_reflect101)
    for img in ((rng.random(hw) < 0.2).astype(np.float32),
                rng.random(hw, dtype=np.float32)):
        np.testing.assert_array_equal(
            sd._blur_reflect101(torch.from_numpy(img),
                                torch.from_numpy(taps)).numpy(),
            np.asarray(blur(img, jnp.asarray(taps))))


def test_mfnr_placement_on_the_cpu_keeps_the_host(rng, monkeypatch):
    frames = _frames(rng, n=4)
    loader = _ploader(frames)
    _, pdn = _denoise_cfgs()
    assert not stk._device_denoise_wins(loader, pdn, "cpu")
    monkeypatch.setenv("METDETPY_TPU_DEVICE_DENOISE", "force")
    assert stk._device_denoise_wins(loader, pdn, "cpu")
    monkeypatch.setenv("METDETPY_TPU_DEVICE_DENOISE", "0")
    assert not stk._device_denoise_wins(loader, pdn, "cpu")


def test_link_probe_on_the_cpu(monkeypatch):
    monkeypatch.setattr(stk, "_LINK_BPS_CACHE", {})
    up, down = stk._probe_link_bps("cpu")
    assert up > 0 and down > 0
    assert stk._probe_link_bps(torch.device("cpu")) == (up, down)


# -- failures propagate ----------------------------------------------------------

def test_device_median_failure_propagates(rng, monkeypatch):
    frames = list(rng.integers(0, 256, (4, 8, 8, 3), np.uint8))
    monkeypatch.setattr(stk, "DEVICE_MEDIAN_MIN_ELEMS", 1)
    monkeypatch.setenv("METDETPY_TPU_DEVICE_MEDIAN", "force")

    def boom(x):
        raise RuntimeError("device median failed")

    monkeypatch.setattr(stk, "median_frames", boom)
    with pytest.raises(RuntimeError, match="device median failed"):
        stk.stack_median(frames, device="cpu")


def test_device_mfnr_failure_propagates(rng, monkeypatch):
    """A device MFNR that raises ends mfnr_mix_stacker (the JAX package
    falls back to the host path)."""
    frames = _frames(rng, n=4)
    _, pdn = _denoise_cfgs()

    def boom(*a, **k):
        raise RuntimeError("device MFNR failed")

    monkeypatch.setattr(sd, "mfnr_mix_device", boom)
    monkeypatch.setenv("METDETPY_TPU_DEVICE_DENOISE", "force")
    with pytest.raises(RuntimeError, match="device MFNR failed"):
        stk.mfnr_mix_stacker(_ploader(frames), pdn, device="cpu")


def test_placement_probe_failure_propagates(rng, monkeypatch):
    """A link probe that raises is not read as "place on the host": not
    by the MFNR upload placement, not by the median placement."""
    def boom(device):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(stk, "_probe_link_bps", boom)
    monkeypatch.delenv("METDETPY_TPU_MFNR_HOST_REDUCE", raising=False)
    _, pdn = _denoise_cfgs()
    with pytest.raises(RuntimeError, match="probe failed"):
        sd.mfnr_mix_device(_ploader(_frames(rng, n=4)), pdn, device="cpu")
    with pytest.raises(RuntimeError, match="probe failed"):
        stk._device_median_wins([np.zeros((16, 4), np.uint8)] * 2, 128,
                                "cuda")
    monkeypatch.delenv("METDETPY_TPU_DEVICE_DENOISE", raising=False)
    with pytest.raises(RuntimeError, match="probe failed"):
        stk._device_denoise_wins(_ploader(_frames(rng, n=4)), pdn, "cuda")


def test_loader_failure_ends_the_stack(rng, monkeypatch):
    frames = _frames(rng, n=6)
    loader = _ploader(frames)
    orig = loader.pop
    count = [0]

    def pop():
        count[0] += 1
        if count[0] == 3:
            raise RuntimeError("decode failed")
        return orig()

    monkeypatch.setattr(loader, "pop", pop)
    with pytest.raises(RuntimeError, match="decode failed"):
        stk.max_stacker(loader)
    assert loader.read_stopped   # the stacker stopped the loader


def test_cuda_without_a_card_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    _, pdn = _denoise_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stk.mfnr_mix_stacker(_ploader(_frames(rng, n=3)), pdn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sd.mfnr_mix_device(_ploader(_frames(rng, n=3)), pdn)
