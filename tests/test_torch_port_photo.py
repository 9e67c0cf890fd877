"""PyTorch port's photo entry point and its image loader on the CPU.

``python -m metdetpy_tpu_torch.photo`` in its three modes (one image, a
folder, a timelapse video) against the JAX package's ``MetDetPhoto.main``
on the same files, at ``METDETPY_TPU_YOLO_HW=96x96`` as
``tests/test_metdetphoto.py`` runs it: the same records, boxes within 2 px
and scores within 0.03 (the two bfloat16 bodies round differently). The
port's ``io/imgloader.py`` mirrors ``tests/test_imgloader.py``; the batch
pipeline settles its path once and the folder loop lets a failure through.
"""

import json
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from metdetpy_tpu.synth import (SynthMeteor, _draw_gaussian_dot,
                                generate_meteor_video, write_video)
from metdetpy_tpu_torch import photo
from metdetpy_tpu_torch.io import imgloader as il
from metdetpy_tpu_torch.io.imgloader import (MultiThreadImgLoader,
                                             ThreadImgLoader,
                                             VanillaImgLoader)
from metdetpy_tpu_torch.models.pipeline import BatchPipeline

torch.set_num_threads(2)


# -- the image loader (as tests/test_imgloader.py) ---------------------------

@pytest.fixture()
def img_files(tmp_path):
    names = []
    for i in range(12):
        p = tmp_path / f"img_{i:02d}.png"
        cv2.imwrite(str(p), np.full((8, 8, 3), i, dtype=np.uint8))
        names.append(str(p))
    return names


def _drain(loader):
    loader.start()
    out = []
    while True:
        fname, img = loader.pop()
        if fname is None and img is None:
            break
        out.append((fname, img))
    loader.stop()
    return out


@pytest.mark.parametrize("cls", [VanillaImgLoader, ThreadImgLoader,
                                 MultiThreadImgLoader])
def test_imgloader_ordered_and_complete(cls, img_files):
    out = _drain(cls(img_files))
    assert [f for f, _ in out] == img_files
    for i, (_, img) in enumerate(out):
        assert img is not None and int(img[0, 0, 0]) == i


def test_imgloader_order_under_skewed_latency(img_files, monkeypatch):
    orig = MultiThreadImgLoader._load_at

    def slow_evens(self, idx):
        if idx % 2 == 0:
            time.sleep(0.05)
        return orig(self, idx)

    monkeypatch.setattr(MultiThreadImgLoader, "_load_at", slow_evens)
    out = _drain(MultiThreadImgLoader(img_files, num_workers=4))
    assert [f for f, _ in out] == img_files


def test_imgloader_window_bounds_prefetch(img_files, monkeypatch):
    peak, active = [0], [0]
    lock = threading.Lock()
    orig = MultiThreadImgLoader._load_at

    def counting(self, idx):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.01)
        try:
            return orig(self, idx)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(MultiThreadImgLoader, "_load_at", counting)
    loader = MultiThreadImgLoader(img_files, num_workers=8, max_prefetch=3)
    assert loader.window == 3
    _drain(loader)
    assert peak[0] <= 3


def test_imgloader_failures_pass_through(img_files, tmp_path):
    bad = str(tmp_path / "missing.png")
    files = img_files[:2] + [bad] + img_files[2:4]
    loader = MultiThreadImgLoader(files, num_workers=2)
    loader.start()
    out = [loader.pop() for _ in files]
    assert loader.pop() == (None, None)
    loader.stop()
    assert loader.pop() == (None, None)
    assert [f for f, _ in out] == files
    assert out[2][1] is None
    weird = tmp_path / "notes.txt"
    weird.write_text("hi")
    assert VanillaImgLoader([str(weird)]).pop() == (str(weird), None)
    src = open(il.__file__).read()
    for legacy in ("_next_assign_idx", "_space_sem", "results_cond"):
        assert legacy not in src


def test_imgloader_restart_replays(img_files):
    loader = MultiThreadImgLoader(img_files[:4], num_workers=2)
    first = [f for f, _ in _drain(loader)]
    second = [f for f, _ in _drain(loader)]
    assert first == second == img_files[:4]


# -- the entry point against MetDetPhoto.main ---------------------------------

def _streak_image(seed, with_streak=True, hw=(160, 224)):
    """A synthetic star field (colour), a gaussian streak in it."""
    rng = np.random.default_rng(seed)
    h, w = hw
    img = np.full((h, w), 12.0, np.float32)
    for _ in range(20):
        _draw_gaussian_dot(img, rng.uniform(0, w), rng.uniform(0, h),
                           rng.uniform(25, 200), rng.uniform(0.8, 1.5))
    if with_streak:
        x1, y1 = rng.uniform(20, w / 2), rng.uniform(20, h / 2)
        x2, y2 = x1 + rng.uniform(40, 90), y1 + rng.uniform(30, 60)
        for k in range(200):
            a = k / 199
            _draw_gaussian_dot(img, x1 + (x2 - x1) * a, y1 + (y2 - y1) * a,
                               200.0 * (1 - 0.3 * a), 1.6)
    img = img + rng.normal(0, 3, img.shape)
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)


@pytest.fixture(scope="module")
def photo_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("photos")
    for i in range(5):
        cv2.imwrite(str(d / f"img_{i}.png"), _streak_image(i, i % 2 == 0))
    return d


def _run_jax(argv, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    import MetDetPhoto
    old = sys.argv
    sys.argv = ["MetDetPhoto.py", *argv]
    try:
        MetDetPhoto.main()
    finally:
        sys.argv = old


def _run_port(argv, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    photo.main([*argv, "--device", "cpu"])


def _both(target, tmp_path, monkeypatch, extra=()):
    out = {}
    for name, run in (("jax", _run_jax), ("port", _run_port)):
        path = tmp_path / f"{name}.json"
        run([str(target), *extra, "--save-path", str(path)], monkeypatch)
        out[name] = json.loads(path.read_text())
    return out["port"], out["jax"]


def _assert_records_close(got, want):
    assert got["type"] == want["type"]
    assert got["basic_info"] == want["basic_info"]
    assert len(got["results"]) == len(want["results"])
    for a, b in zip(got["results"], want["results"]):
        assert {k: v for k, v in a.items() if k not in ("boxes", "prob")} \
            == {k: v for k, v in b.items() if k not in ("boxes", "prob")}
        assert len(a["boxes"]) == len(b["boxes"])
        for ba, bb in zip(a["boxes"], b["boxes"]):
            assert max(abs(p - q) for p, q in zip(ba, bb)) <= 2, (a, b)
        for pa, pb in zip(a["prob"], b["prob"]):
            assert abs(float(pa) - float(pb)) <= 0.03 + 1e-9, (a, b)


def test_single_image_matches_jax(photo_dir, tmp_path, monkeypatch):
    got, want = _both(photo_dir / "img_0.png", tmp_path, monkeypatch,
                      ("--scale", "1"))
    assert got["type"] == "image-prediction"
    assert want["results"][0]["boxes"], want
    _assert_records_close(got, want)


def test_folder_matches_jax(photo_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_PHOTO_BATCH", "2")
    monkeypatch.setattr(photo, "PHOTO_BATCH_SIZE", 2)
    got, want = _both(photo_dir, tmp_path, monkeypatch, ("--scale", "1"))
    assert got["basic_info"]["image_folder"] == str(photo_dir)
    assert len(want["results"]) >= 2
    _assert_records_close(got, want)


def test_timelapse_matches_jax(tmp_path, monkeypatch):
    frames = generate_meteor_video(
        width=224, height=160, fps=25.0, duration_sec=0.6,
        meteors=[SynthMeteor(0.0, 0.6, (40, 30), (170, 120))], n_stars=20,
        color=True, seed=4)
    vid = tmp_path / "tl.avi"
    write_video(frames, str(vid), fps=25.0)
    got, want = _both(vid, tmp_path, monkeypatch,
                      ("--scale", "1", "--exclude-noise"))
    assert got["type"] == "timelapse-prediction"
    _assert_records_close(got, want)
    for rec in got["results"]:
        assert "num_frame" in rec


def _long_streak_image(seed, hw=(360, 640), length=300.0):
    """A colour star field with a streak about ``length`` px long, which
    crosses several tiles of the two-level pyramid: the tiles' detections
    come out as a chain of boxes with near-equal scores."""
    rng = np.random.default_rng(seed)
    h, w = hw
    img = np.full((h, w), 12.0, np.float32)
    for _ in range(60):
        _draw_gaussian_dot(img, rng.uniform(0, w), rng.uniform(0, h),
                           rng.uniform(25, 200), rng.uniform(0.8, 1.5))
    x1, y1 = rng.uniform(0.1 * w, 0.3 * w), rng.uniform(0.1 * h, 0.3 * h)
    ang = rng.uniform(0.25, 0.6)
    x2, y2 = x1 + length * np.cos(ang), y1 + length * np.sin(ang)
    for k in range(600):
        a = k / 599
        _draw_gaussian_dot(img, x1 + (x2 - x1) * a, y1 + (y2 - y1) * a,
                           210.0 * (1 - 0.3 * a), 1.8)
    img = img + rng.normal(0, 3, img.shape)
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_long_streak_records_match_jax(seed, tmp_path, monkeypatch):
    """A ~300 px streak on a 640x360 photo at the multiscale default
    (``--scale`` 2): the port's records equal MetDetPhoto's on the CPU,
    box for box within 2 px and 0.03 (the chained boxes included)."""
    img = tmp_path / f"long_{seed}.png"
    cv2.imwrite(str(img), _long_streak_image(seed))
    got, want = _both(img, tmp_path, monkeypatch)
    assert len(want["results"][0]["boxes"]) >= 2, want
    _assert_records_close(got, want)


def test_folder_failure_propagates(photo_dir, tmp_path, monkeypatch):
    """An exception in the folder loop ends the run and writes no MDRF
    (MetDetPhoto.py logs it and writes what it had)."""
    def boom(self, imgs):
        raise RuntimeError("injected model failure")

    monkeypatch.setattr(BatchPipeline, "_dispatch", boom)
    out = tmp_path / "res.json"
    with pytest.raises(RuntimeError, match="injected model failure"):
        _run_port([str(photo_dir), "--scale", "0", "--save-path", str(out)],
                  monkeypatch)
    assert not out.exists()


def test_batch_pipeline_settles_its_path_once(monkeypatch):
    """A model with NMS runs on the device path and a failure there
    propagates (no switch to forward_batch); a model without NMS runs
    forward_batch. Sharding comes with the multi-device slice."""
    class Model:
        device = torch.device("cpu")

        def __init__(self, nms):
            self.nms = nms
            self.calls = []

        def dispatch_batch_device(self, x):
            self.calls.append("device")
            raise NotImplementedError("device path failed")

        def forward_batch(self, imgs):
            self.calls.append("host")
            return [([], [])] * len(imgs)

    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    m = Model(nms=True)
    with pytest.raises(NotImplementedError, match="device path failed"):
        BatchPipeline(m, inflight=0).submit(["a", "b"], imgs)
    assert m.calls == ["device"]
    m = Model(nms=False)
    assert BatchPipeline(m, inflight=0).submit(["a", "b"], imgs) == [
        ("a", ([], [])), ("b", ([], []))]
    assert m.calls == ["host"]
    with pytest.raises(NotImplementedError, match="multi-device"):
        BatchPipeline(m, sharding=object())


def test_data_parallel_and_cuda_without_a_card_raise(photo_dir):
    with pytest.raises(SystemExit, match="multi-device"):
        photo.main([str(photo_dir), "--data-parallel", "2", "--device",
                    "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        photo.main([str(photo_dir)])
