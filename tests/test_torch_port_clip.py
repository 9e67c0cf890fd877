"""PyTorch port's clip export entry point (``python -m
metdetpy_tpu_torch.clip``) against the JAX package's ``ClipToolkit.main``.

The flows of ``tests/test_cli_tools.py`` (image stack, video clip, JSON
requests with bbox and annotation, denoise stack, MDRF input) and an
image-folder MDRF, run in-process, the port with ``--device cpu``, on the
same synthetic MJPG AVI: images equal byte for byte once decoded, labelme
JSON equal (paths aside), AVI frames equal once decoded. ``--device cuda``
without a card raises, and a failure in the image-folder flow ends the run
(ClipToolkit.py logs it and carries on).
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from metdetpy_tpu_torch import clip
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.structs import MainDetectCfg
from metdetpy_tpu_torch.synth import (SynthMeteor, generate_meteor_video,
                                      write_video)
from metdetpy_tpu_torch.utils import relative2abs_path

torch.set_num_threads(2)
W, H, FPS = 192, 108, 25.0


@pytest.fixture(scope="module")
def synth_avi(tmp_path_factory):
    path = tmp_path_factory.mktemp("vid") / "synth.avi"
    m = SynthMeteor(start_sec=1.0, end_sec=2.0,
                    pt1=(int(W * .7), int(H * .2)),
                    pt2=(int(W * .3), int(H * .7)))
    frames = generate_meteor_video(width=W, height=H, fps=FPS,
                                   duration_sec=3.0, meteors=[m],
                                   n_stars=25, color=True, seed=11)
    write_video(frames, str(path), fps=FPS)
    return str(path)


def _run_jax(argv):
    from ClipToolkit import main
    old = sys.argv
    sys.argv = ["ClipToolkit.py", *argv]
    try:
        main()
    finally:
        sys.argv = old


def _run_port(argv):
    clip.main([*argv, "--device", "cpu"])


def _both(tmp_path, argv_for, single=None):
    """Run both tools; ``argv_for(out)`` gives the arguments for an output
    directory (or, with ``single``, a file name in it). Returns the two
    output directories."""
    outs = {}
    for name, run in (("jax", _run_jax), ("port", _run_port)):
        d = tmp_path / name
        d.mkdir()
        run(argv_for(str(d / single) if single else str(d)))
        outs[name] = d
    return outs["port"], outs["jax"]


def _decode_avi(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def _assert_same_outputs(port_dir, jax_dir):
    names = sorted(os.listdir(jax_dir))
    assert names and sorted(os.listdir(port_dir)) == names
    for name in names:
        a, b = port_dir / name, jax_dir / name
        ext = name.rsplit(".", 1)[-1].lower()
        if ext in ("jpg", "png"):
            ia, ib = cv2.imread(str(a)), cv2.imread(str(b))
            assert ia is not None and ia.shape == ib.shape
            np.testing.assert_array_equal(ia, ib)
            assert a.read_bytes() == b.read_bytes()
        elif ext == "json":
            ja = json.loads(a.read_text().replace(str(port_dir), "<out>"))
            jb = json.loads(b.read_text().replace(str(jax_dir), "<out>"))
            assert ja == jb
        elif ext == "avi":
            fa, fb = _decode_avi(a), _decode_avi(b)
            assert fa.shape == fb.shape
            np.testing.assert_array_equal(fa, fb)
        else:
            raise AssertionError(f"unexpected output {name}")
    return names


def test_image_stack_matches_cliptoolkit(synth_avi, tmp_path):
    port, jax_dir = _both(tmp_path, lambda out: [
        synth_avi, "--start-time", "00:00:01.00", "--end-time",
        "00:00:02.00", "--mode", "image", "--save-path", out], "stack.jpg")
    _assert_same_outputs(port, jax_dir)
    img = cv2.imread(str(port / "stack.jpg"))
    assert img.shape[:2] == (H, W)
    my, mx = int(H * .45), int(W * .5)
    assert img[my - 8:my + 8, mx - 12:mx + 12].max() > 120


def test_video_clip_matches_cliptoolkit(synth_avi, tmp_path):
    port, jax_dir = _both(tmp_path, lambda out: [
        synth_avi, "--start-time", "00:00:00.50", "--end-time",
        "00:00:02.00", "--mode", "video", "--save-path", out], "clip.avi")
    _assert_same_outputs(port, jax_dir)
    assert 30 <= _decode_avi(port / "clip.avi").shape[0] <= 45


def _requests(tmp_path, filename):
    req = [{"time": ["00:00:01.00", "00:00:02.00"], "filename": filename,
            "target": [{"pt1": [int(W * .3), int(H * .2)],
                        "pt2": [int(W * .7), int(H * .7)],
                        "preds": "METEOR", "prob": "0.95"}]},
           {"time": ["00:00:00.20", "00:00:00.80"],
            "target": [{"pt1": [10, 10], "pt2": [60, 40],
                        "preds": "PLANE/SATELLITE", "prob": "0.7"}]}]
    path = tmp_path / f"req_{filename}.json"
    path.write_text(json.dumps(req))
    return str(path)


def test_json_requests_with_bbox_match_cliptoolkit(synth_avi, tmp_path):
    req = _requests(tmp_path, "annotated.jpg")
    port, jax_dir = _both(tmp_path, lambda out: [
        synth_avi, req, "--save-path", out, "--with-bbox",
        "--with-annotation"])
    names = _assert_same_outputs(port, jax_dir)
    assert "annotated.jpg" in names and "annotated.json" in names
    anno = json.loads((port / "annotated.json").read_text())
    assert anno["shapes"][0]["label"] == "METEOR"


def test_video_with_bbox_matches_cliptoolkit(synth_avi, tmp_path):
    req = _requests(tmp_path, "boxed.avi")
    port, jax_dir = _both(tmp_path, lambda out: [
        synth_avi, req, "--mode", "video", "--with-bbox", "--save-path",
        out])
    names = _assert_same_outputs(port, jax_dir)
    assert "boxed.avi" in names
    assert _decode_avi(port / "boxed.avi").shape[0] == 25


@pytest.mark.parametrize("denoise,placement", [("mfnr-mix", "auto"),
                                               ("mfnr-mix", "force"),
                                               ("simple", "auto")])
def test_denoise_stack_matches_cliptoolkit(synth_avi, tmp_path, monkeypatch,
                                           denoise, placement):
    """``auto`` keeps the MFNR pixel math on the host in both packages on
    the CPU; ``force`` runs both device forms (XLA's and the port's PyTorch
    one on the CPU)."""
    monkeypatch.setenv("METDETPY_TPU_DEVICE_DENOISE",
                       "force" if placement == "force" else "auto")
    port, jax_dir = _both(tmp_path, lambda out: [
        synth_avi, "--start-time", "00:00:01.00", "--end-time",
        "00:00:02.00", "--mode", "image", "--denoise", denoise,
        "--save-path", out], "denoised.png")
    _assert_same_outputs(port, jax_dir)


def test_mdrf_input_matches_cliptoolkit(synth_avi, tmp_path):
    """A detection MDRF (written by the port's detect_video) as the only
    input (input style 3: reference ClipToolkit.py:181-219)."""
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    mdrf = detect_video(synth_avi, None, cfg, work_mode="backend",
                        device="cpu")
    assert len(mdrf.results) >= 1
    result_path = tmp_path / "run.json"
    result_path.write_text(json.dumps(mdrf.to_dict()))
    port, jax_dir = _both(tmp_path, lambda out: [
        str(result_path), "--mode", "image", "--save-path", out,
        "--with-annotation"])
    names = _assert_same_outputs(port, jax_dir)
    assert any(n.endswith(".jpg") for n in names)


@pytest.fixture()
def image_mdrf(tmp_path):
    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(7)
    results = []
    for i in range(3):
        img = rng.integers(0, 40, (90, 120, 3), np.uint8)
        cv2.line(img, (10, 20 + 10 * i), (90, 60), (240, 240, 240), 2)
        path = folder / f"sky_{i}.png"
        cv2.imwrite(str(path), img)
        results.append({"boxes": [[8, 15 + 10 * i, 95, 65]],
                        "preds": ["METEOR" if i != 1 else "BUGS"],
                        "prob": ["0.91"], "img_filename": str(path),
                        "img_size": None if i else [120, 90]})
    mdrf = {"version": "test", "type": "image-prediction",
            "basic_info": {"image_folder": str(folder)}, "config": None,
            "anno_size": None, "results": results}
    path = tmp_path / "photos.json"
    path.write_text(json.dumps(mdrf))
    return str(path)


@pytest.mark.parametrize("extra", [("--with-bbox", "--with-annotation"),
                                   ("--enable-filter-rules",)])
def test_image_folder_mdrf_matches_cliptoolkit(image_mdrf, tmp_path,
                                               extra):
    port, jax_dir = _both(tmp_path, lambda out: [
        image_mdrf, "--save-path", out, *extra])
    names = _assert_same_outputs(port, jax_dir)
    assert "sky_0.png" in names


def test_image_folder_failure_propagates(image_mdrf, tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(clip, "save_img", boom)
    with pytest.raises(OSError, match="disk full"):
        _run_port([image_mdrf, "--save-path", str(tmp_path / "o"),
                   "--with-bbox"])


def test_cuda_without_a_card_raises(synth_avi, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip.main([synth_avi, "--save-path", str(tmp_path / "x.jpg")])
