"""The reckonings of a kernel's and a model's work."""

import pytest

import _cpu  # noqa: F401  (puts the checkout on the path)
from benchmark.work import kernels, m3_step, peaks, yolov5s


@pytest.mark.parametrize("name, mb, extra", [
    ("window_diff", 78.8, {}), ("median_binarize_close", 66.36, {}),
    ("hough_vote", 18.28, {}), ("walk_pick", 4.34, {"plane_bytes": 145_000}),
])
def test_kernel_bytes_at_the_main_path_shapes(name, mb, extra):
    nbytes, _ = kernels.KERNELS[name][0](540, 960, **extra)
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.01)


def test_kernel_bounds_are_bytes():
    for name in kernels.KERNELS:
        nbytes, ops = kernels.KERNELS[name][0](540, 960)
        assert peaks.least_seconds(nbytes, ops) == nbytes / \
            peaks.HBM_BYTES_PER_S
    assert kernels.launch_least_seconds("window_diff", 540, 960) * 1e3 == \
        pytest.approx(0.0235, abs=1e-4)


def test_yolov5s_flops():
    # YOLOv5's own summary of v5s at 640 with 80 classes: 16.5 GFLOPs
    assert yolov5s.forward_flops(640, 640, 80) / 1e9 == pytest.approx(
        16.5, rel=0.01)
    assert yolov5s.forward_flops(320, 320, 8) / 1e9 == pytest.approx(
        3.9536, rel=1e-4)


@pytest.mark.parametrize("hw, pred, tiles", [
    ((544, 960), 1, 2), ((544, 960), 2, 10), ((544, 960), 0, 1),
    ((320, 320), 1, 1)])
def test_tiles_per_image(hw, pred, tiles):
    assert yolov5s.tiles_per_image(*hw, (320, 320), pred, 2) == tiles


def test_m3_step_least_time():
    t = m3_step.least_seconds_clip(540, 960, 1500, 25, vote_points=0)
    blocks = 24
    assert t == pytest.approx(blocks * m3_step.block_bytes(540, 960, 64, 25)
                              / peaks.HBM_BYTES_PER_S)
    # 33 MB of frames and 50 MB of carries a block
    assert m3_step.block_bytes(540, 960, 64, 25) / 1e6 == pytest.approx(
        83.04, abs=0.05)
