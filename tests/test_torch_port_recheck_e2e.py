"""PyTorch port end to end with the deep-learning path on the CPU: the
shipped presets, recheck on, against the JAX package, and the command line.

Both packages get the same synthetic colour clip (each its own copy: the JAX
package's loader writes its colour stacks into an in-memory source) and run
the model at 96x96 (``METDETPY_TPU_YOLO_HW``, one setting for both). The
records must agree: category and frames equal; ``pt1``/``pt2`` within 2 px
for ``dldet.json`` and exact for ``m3det_normal.json``; ``score`` and
``recheck_score`` within 0.03 (the two bfloat16 bodies round differently).
"""

import json

import pytest
import torch

from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video, write_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch.__main__ import main as cli_main
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.models import yolo as tyolo
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg

torch.set_num_threads(2)

W, H, FPS = 256, 144, 25.0


@pytest.fixture(scope="module")
def clip():
    meteor = SynthMeteor(start_sec=2.4, end_sec=4.4,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    return generate_meteor_video(width=W, height=H, fps=FPS,
                                 duration_sec=6.5, meteors=[meteor],
                                 n_stars=40, noise_sigma=3.0, color=True)


def _cfg(cls, preset):
    """The preset as shipped; only the frame source is in memory (and the
    M3 preset's "auto" exposure, which is estimated from a video file,
    becomes real-time)."""
    cfg = cls.from_json_file(relative2abs_path(f"./config/{preset}.json"))
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    if cfg.loader.grayscale:
        cfg.loader.exp_time = "real-time"
    assert cfg.collector.recheck_cfg.switch
    return cfg


def _targets(mdrf):
    return [t for rec in mdrf.results for t in rec.target]


@pytest.mark.parametrize("preset,pt_tol", [("dldet", 2), ("m3det_normal", 0)])
def test_preset_with_recheck_matches_jax(clip, monkeypatch, preset, pt_tol):
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    want = jax_detect_video(clip.copy(), None, _cfg(MainDetectCfg, preset),
                            work_mode="backend")
    tyolo.CALLS.clear()
    got = detect_video(clip.copy(), None, _cfg(TMainDetectCfg, preset),
                       work_mode="backend", device="cpu")
    assert tyolo.CALLS["forward"] >= 1       # the recheck ran
    assert [(r.start_frame, r.end_frame) for r in got.results] == \
        [(r.start_frame, r.end_frame) for r in want.results]
    gt, wt = _targets(got), _targets(want)
    assert len(gt) == len(wt) and any(t.category == "METEOR" for t in wt)
    for g, w in zip(gt, wt):
        assert g.category == w.category
        assert (g.start_frame, g.last_activate_frame) == \
            (w.start_frame, w.last_activate_frame)
        assert max(abs(a - b) for a, b in zip([*g.pt1, *g.pt2],
                                              [*w.pt1, *w.pt2])) <= pt_tol
        assert g.recheck_score is not None and w.recheck_score is not None
        assert abs(g.score - w.score) <= 0.03
        assert abs(g.recheck_score - w.recheck_score) <= 0.03
    assert got.performance["recovered_blocks"] == 0
    if preset == "dldet":
        assert "collect_fetch_s" in got.performance


def test_recheck_model_failure_ends_detect_video(clip, tmp_path):
    """A recheck model that cannot be built (its weight file is missing)
    ends ``detect_video`` with that exception: the recheck is not switched
    off behind the caller's back."""
    cfg = _cfg(TMainDetectCfg, "m3det_normal")
    cfg.collector.recheck_cfg.model.weight_path = str(tmp_path / "no.npz")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        detect_video(clip[:30].copy(), None, cfg, work_mode="backend",
                     device="cpu")
    cfg = _cfg(TMainDetectCfg, "dldet")
    cfg.detector.cfg.model.weight_path = str(tmp_path / "no.npz")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        detect_video(clip[:30].copy(), None, cfg, work_mode="backend",
                     device="cpu")


def test_recheck_forward_failure_ends_detect_video(clip, monkeypatch):
    """An exception of the recheck's forward, raised in the exporter's
    thread, ends ``detect_video`` with that exception: no truncated result
    comes back."""
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")

    def fails(self, x, tiles):
        raise RuntimeError("recheck level failed")

    monkeypatch.setattr(tyolo.YOLOModel, "_forward_tiles", fails)
    with pytest.raises(RuntimeError, match="recheck level failed"):
        detect_video(clip.copy(), None, _cfg(TMainDetectCfg, "m3det_normal"),
                     work_mode="backend", device="cpu")


@pytest.mark.parametrize("nms", [True, False])
def test_device_step_failure_moves_to_no_second_path(clip, monkeypatch, nms):
    """Which path drives MLDetector is settled by the model's ``nms`` before
    the loop. A ``NotImplementedError`` out of the device step (torch raises
    it for an operator without a kernel for the device) is a failure like
    any other: it ends the call from the dispatch, or is counted by the
    loop's recovery from the collect, and the other path is never driven."""
    from metdetpy_tpu_torch.detectors.mldet import MLDetector
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    cfg = _cfg(TMainDetectCfg, "dldet")
    cfg.detector.cfg.model.nms = nms
    cfg.collector.recheck_cfg.switch = False
    failed = []

    def fails(self, imgs_dev):
        failed.append(self.nms)
        raise NotImplementedError("no kernel for this device")

    def other_path(self, block):
        raise AssertionError("the other path was driven")

    monkeypatch.setattr(
        tyolo.YOLOModel,
        "dispatch_batch_device" if nms else "forward_batch_device", fails)
    if nms:
        monkeypatch.setattr(MLDetector, "process_block", other_path)
        with pytest.raises(NotImplementedError, match="no kernel"):
            detect_video(clip[:40].copy(), None, cfg, work_mode="backend",
                         device="cpu")
    else:
        monkeypatch.setattr(MLDetector, "process_block_async", other_path)
        got = detect_video(clip[:40].copy(), None, cfg, work_mode="backend",
                           device="cpu")
        assert got.performance["recovered_blocks"] == 1
        assert got.results == []
    assert failed == [nms]


def test_detector_kind_must_match_loader_colour(clip):
    cfg = _cfg(TMainDetectCfg, "dldet")
    cfg.loader.grayscale = True
    with pytest.raises(AssertionError, match="grayscale OFF"):
        detect_video(clip[:30].copy(), None, cfg, device="cpu")
    cfg = _cfg(TMainDetectCfg, "m3det_normal")
    cfg.loader.grayscale = False
    with pytest.raises(AssertionError, match="grayscale ON"):
        detect_video(clip[:30].copy(), None, cfg, device="cpu")


@pytest.fixture(scope="module")
def video_file(clip, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "synth.avi")
    write_video(clip, path, fps=FPS)
    return path


@pytest.mark.parametrize("preset", ["m3det_normal", "dldet"])
def test_cli_runs_preset_as_shipped(video_file, tmp_path, monkeypatch,
                                    preset):
    """``python -m metdetpy_tpu_torch <video> --cfg <preset> --device cpu``
    with no ``--recheck off``: the preset file is used unchanged and the
    MDRF's records carry a recheck score. (dldet resizes the clip to its
    960x544 and runs the model at its 320x320; the M3 preset's recheck runs
    at 96x96 here to save time.)"""
    if preset != "dldet":
        monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    out = str(tmp_path / "out.json")
    cli_main([video_file, "--cfg",
              relative2abs_path(f"./config/{preset}.json"), "--device",
              "cpu", "--mode", "backend", "--save-path", out])
    with open(out, encoding="utf-8") as f:
        mdrf = json.load(f)
    assert mdrf["config"]["collector"]["recheck_cfg"]["switch"] is True
    targets = [t for rec in mdrf["results"] for t in rec["target"]]
    assert targets
    assert any(t["recheck_score"] is not None for t in targets)


def test_cli_on_cuda_raises_without_a_card(video_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main([video_file, "--mode", "backend"])
