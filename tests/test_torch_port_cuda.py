"""PyTorch port on the card: each CUDA kernel against its plain version,
and the MDRF on the card against the MDRF on the CPU.

Every test here carries the ``cuda`` marker and skips without a GPU (a
CUDA kernel has no CPU mode). The file imports nothing of JAX, so it runs
on a machine without it; ``tests/conftest.py`` imports JAX, so there run
it without the conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.ops import hough, kernels
from metdetpy_tpu_torch.ops.kernel_cases import (PICK_CASES, VOTE_CASES,
                                                 pick_case, vote_case)
from metdetpy_tpu_torch.structs import MainDetectCfg
from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu_torch.utils import relative2abs_path

SEED = 20261016


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_cases(dev):
    """Small inputs with ragged edges (37x150 frames, partial and empty
    point lists, walks that leave the plane) for each kernel."""
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    h, w = 37, 150
    n_rho = hough._round_up(2 * (w + h) + 1, 128)
    s = hough._round_up(max(h, w) + 1, 128)
    planes = hough.corner_planes(
        t((rng.random((3, h, w)) < 0.1).astype(np.uint8)), s)
    geom = hough.walk_geom(t(rng.integers(0, 180, (3, 16))),
                           t(rng.integers(0, n_rho, (3, 16))), w + h,
                           hough._round_up(max(h, w) + 4, 128), h, w, s)
    return {
        "window_diff": (
            (t(rng.integers(0, 256, (4, h, w), dtype=np.uint8)),
             t(rng.integers(0, 256, (9, h, w), dtype=np.uint8)), 5, 2),
            kernels.window_diff_plain),
        "median_binarize_close": (
            (t(rng.integers(0, 30, (5, h, w), dtype=np.uint8)),
             t(rng.integers(2, 12, 5, dtype=np.uint8))),
            kernels.median_binarize_close_plain),
        "hough_vote": (
            (t(rng.integers(0, w, (3, 512)).astype(np.float32)),
             t(rng.integers(0, h, (3, 512)).astype(np.float32)),
             t(np.arange(512)[None] < np.array([512, 100, 0])[:, None]),
             n_rho, w + h),
            kernels.hough_vote_plain),
        "walk_pick": ((planes, geom.r.contiguous(), geom.xmaj),
                      kernels.walk_pick_plain),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(kernels.SOURCES))
def test_kernel_on_card_matches_plain(cuda_device, name):
    args, plain = _card_cases(cuda_device)[name]
    kernels.reset_launch_counts()
    got = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ragged shapes of the two streaming kernels: (h, w, n, T, timer0, offset);
# offset 1 hands the kernel a contiguous input whose data pointer is not
# 16-byte aligned
WINDOW_DIFF_CASES = [
    (540, 960, 25, 64, 10, 0), (540, 960, 25, 64, 0, 0),
    (37, 150, 1, 64, 0, 0), (37, 150, 2, 1, 0, 0), (2, 961, 25, 64, 5, 0),
    (1, 3, 60, 64, 0, 0), (1, 1, 100, 1, 0, 0), (37, 150, 100, 64, 10**6, 0),
    (2, 960, 60, 1, 10**6, 0), (540, 960, 100, 1, 0, 0),
    (37, 960, 25, 64, 3, 1), (2, 150, 2, 64, 10**6, 1),
]
# (T, h, w, offset)
MEDIAN_CASES = [
    (64, 540, 960, 0), (5, 37, 150, 0), (3, 1, 1, 0), (3, 2, 3, 0),
    (2, 540, 961, 0), (4, 37, 960, 0), (3, 2, 150, 0), (2, 1, 960, 0),
    (2, 540, 1, 0), (2, 37, 960, 1), (3, 37, 150, 1),
]


def _on_card(a, dev, offset):
    """A contiguous card tensor holding ``a``, starting ``offset`` bytes
    into its storage."""
    flat = torch.empty(a.size + offset, dtype=torch.uint8, device=dev)
    view = flat[offset:].view(a.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n,t_block,timer0,offset", WINDOW_DIFF_CASES)
def test_window_diff_on_card_ragged(cuda_device, h, w, n, t_block, timer0,
                                    offset):
    rng = np.random.default_rng([SEED, h, w, n, t_block])
    history = _on_card(rng.integers(0, 256, (n - 1, h, w), dtype=np.uint8),
                       cuda_device, offset)
    frames = _on_card(rng.integers(0, 256, (t_block, h, w), dtype=np.uint8),
                      cuda_device, offset)
    kernels.reset_launch_counts()
    diff, new_hist = kernels.window_diff(history, frames, n, timer0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_diff"] == 1
    want, want_hist = kernels.window_diff_plain(history, frames, n, timer0)
    assert torch.equal(diff, want) and torch.equal(new_hist, want_hist)


@pytest.mark.cuda
@pytest.mark.parametrize("t_block,h,w,offset", MEDIAN_CASES)
def test_median_binarize_close_on_card_ragged(cuda_device, t_block, h, w,
                                              offset):
    rng = np.random.default_rng([SEED, t_block, h, w])
    diff = rng.integers(0, 30, (t_block, h, w), dtype=np.uint8)
    diff[rng.random(diff.shape) < 0.01] = 255
    thr = rng.integers(2, 12, t_block, dtype=np.uint8)
    thr[0], thr[-1] = 0, 255
    diff = _on_card(diff, cuda_device, offset)
    thr = torch.from_numpy(thr).to(cuda_device)
    kernels.reset_launch_counts()
    got = kernels.median_binarize_close(diff, thr)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["median_binarize_close"] == 1
    assert torch.equal(got, kernels.median_binarize_close_plain(diff, thr))


# VOTE_CASES and PICK_CASES (ops/kernel_cases.py): odd and long point lists,
# none or one bin's worth of valid points, n_rho from 128 to the largest,
# T = 1 and 64, K = 1..64, S = 128..1024, rows all outside the plane, inputs
# 4 bytes into their storage


@pytest.mark.cuda
@pytest.mark.parametrize("case", VOTE_CASES, ids=[c[0] for c in VOTE_CASES])
def test_hough_vote_on_card_ragged(cuda_device, case):
    args = vote_case(case, cuda_device, SEED)
    kernels.reset_launch_counts()
    got = kernels.hough_vote(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hough_vote"] == 1
    want = kernels.hough_vote_plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PICK_CASES, ids=[c[0] for c in PICK_CASES])
def test_walk_pick_on_card_ragged(cuda_device, case):
    args = pick_case(case, cuda_device, SEED)
    kernels.reset_launch_counts()
    got = kernels.walk_pick(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["walk_pick"] == 1
    want = kernels.walk_pick_plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_hough_vote_refuses_too_many_rho_bins(cuda_device):
    args = vote_case(("n100", 1, 100, kernels.MAX_VOTE_RHO + 1, "prefix", 0),
                     cuda_device, SEED)
    with pytest.raises(ValueError):
        kernels.hough_vote(*args)


@pytest.mark.cuda
def test_mdrf_on_card_equals_cpu(cuda_device):
    w, h = 256, 144
    frames = generate_meteor_video(
        width=w, height=h, fps=25.0, duration_sec=6.5,
        meteors=[SynthMeteor(start_sec=2.4, end_sec=4.4,
                             pt1=(int(w * 0.45), int(h * 0.25)),
                             pt2=(int(w * 0.30), int(h * 0.55)))],
        n_stars=40, noise_sigma=3.0)
    got = {}
    for dev in ("cuda", "cpu"):
        cfg = MainDetectCfg.from_json_file(
            relative2abs_path("./config/m3det_normal.json"))
        cfg.loader.wrapper = "NumpyVideoWrapper"
        cfg.loader.resize = None
        cfg.loader.exp_time = "real-time"
        cfg.collector.recheck_cfg.switch = False
        got[dev] = [r.to_dict() for r in detect_video(
            frames, None, cfg, work_mode="backend", device=dev).results]
    assert any(t["category"] == "METEOR"
               for rec in got["cuda"] for t in rec["target"])
    assert got["cuda"] == got["cpu"]
