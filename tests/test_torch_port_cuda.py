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
