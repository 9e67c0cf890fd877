"""PyTorch port: ``python -m metdetpy_tpu_torch.evaluate`` against the
top-level ``evaluate.py`` of the JAX package on the CPU.

- ``compare`` prints what ``evaluate.compare`` prints and returns the same
  mismatches, on the same MDRF pair, in ground-truth and in prediction
  mode (exact);
- on an annotated synthetic MJPG clip (the fixture of
  ``tests/test_evaluate_f1.py``, ``synth.write_annotated_clip``) the
  port's ``main --metric --device cpu`` finds the meteor (recall 1.0) with
  the precision, records and mismatches of ``evaluate.main`` on the same
  clip and config (exact): the F1 check of the port needs no reference
  checkout;
- ``main --load --metric`` writes ``evaluate.main``'s ``mismatch.json``
  (exact); the process sampler reads what psutil reads.
"""

import json
import os
import re
import sys

import pytest

import evaluate as jeval
from metdetpy_tpu.io.videowrapper import OpenCVVideoWrapper as JVideo
from metdetpy_tpu.structs import MDRF as JMDRF
from metdetpy_tpu.structs import from_dict as jfrom_dict
from metdetpy_tpu_torch import evaluate as teval
from metdetpy_tpu_torch.io.videowrapper import OpenCVVideoWrapper as TVideo
from metdetpy_tpu_torch.structs import MDRF as TMDRF
from metdetpy_tpu_torch.structs import MainDetectCfg, from_dict
from metdetpy_tpu_torch.synth import write_annotated_clip
from metdetpy_tpu_torch.utils import frame2ts, relative2abs_path

W, H, FPS = 256, 144, 25.0


def _target(sf: int, ef: int, pt1, pt2, category: str = "METEOR",
            score: float = 1.0) -> dict:
    return {
        "start_frame": sf, "start_time": frame2ts(sf, FPS),
        "end_time": frame2ts(ef, FPS), "last_activate_frame": ef,
        "last_activate_time": frame2ts(ef, FPS), "duration": ef - sf + 1,
        "speed": 1.0, "dist": 50.0, "fix_dist": 20.0, "fix_speed": 10.0,
        "fix_motion_duration": (ef - sf) / FPS,
        "fix_duration": (ef - sf) / FPS, "num_pts": 2,
        "category": category, "pt1": list(pt1), "pt2": list(pt2),
        "drct_loss": 0.0, "score": score, "real_dist": 50.0,
    }


def _mdrf(video_path: str, kind: str, targets: list[dict],
          anno_size=(W, H)) -> dict:
    """An MDRF of ``kind`` (annotation or prediction), one record a
    target, in the format evaluate consumes."""
    return {
        "version": "anno", "basic_info": {
            "loader": "none", "video": video_path, "mask": None,
            "start_time": 0, "end_time": int(6500 / FPS * 1000),
            "resolution": [W, H], "runtime_resolution": [W, H],
            "exp_time": 1 / FPS, "total_frames": int(6.5 * FPS), "fps": FPS,
        },
        "config": None, "type": kind, "anno_size": list(anno_size),
        "results": [{
            "start_time": tg["start_time"], "end_time": tg["end_time"],
            "video_size": list(anno_size), "target": [tg],
            "start_frame": tg["start_frame"],
            "end_frame": tg["last_activate_frame"],
        } for tg in targets],
    }


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The annotated 256x144 MJPG clip and its annotation JSON
    (``synth.write_annotated_clip``), and the config of
    tests/test_evaluate_f1.py (m3det_normal, the Block loader at the raw
    size, real-time exposure, recheck off)."""
    d = tmp_path_factory.mktemp("evalclip")
    write_annotated_clip(str(d), W, H, FPS)
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    with open(d / "cfg.json", "w", encoding="utf-8") as f:
        json.dump(cfg.to_dict(), f)
    return d


def _pair(video: str, gt_mode: bool) -> tuple[dict, dict]:
    """A base and a new MDRF whose targets exercise every branch of the
    matching: a match, a match of another category, a base scored at the
    threshold (DROPPED), UNKNOWN_AREA read as OTHERS, a new target scored
    below the threshold, one that matches nothing and one after the last
    base; coordinates at half size (anno_size), as annotations are."""
    s = 0.5
    base = [
        _target(10, 40, (20, 10), (60, 30)),
        _target(50, 80, (100, 50), (120, 70), "PLANE/SATELLITE"),
        _target(90, 120, (30, 30), (70, 60), "METEOR", 0.5),
        _target(125, 140, (10, 60), (40, 70), "UNKNOWN_AREA"),
    ]
    new = [
        _target(12, 41, (21, 11), (61, 31)),
        _target(45, 60, (5, 5), (9, 9), "METEOR", 0.2),
        _target(52, 79, (101, 50), (119, 69), "METEOR"),
        _target(85, 88, (0, 0), (5, 5), "PLANE/SATELLITE"),
        _target(92, 121, (31, 30), (69, 61), "METEOR", 0.9),
        _target(126, 139, (11, 60), (39, 71), "METEOR", 0.8),
        _target(150, 160, (10, 10), (20, 20), "METEOR"),
    ]
    for tg in base + new:
        tg["pt1"] = [int(v * s) for v in tg["pt1"]]
        tg["pt2"] = [int(v * s) for v in tg["pt2"]]
    size = (int(W * s), int(H * s))
    return (_mdrf(video, "annotation" if gt_mode else "prediction", base,
                  size),
            _mdrf(video, "prediction", new, size))


@pytest.mark.parametrize("gt_mode", [True, False], ids=["gt", "prediction"])
def test_compare_prints_what_evaluate_prints(clip, capsys, gt_mode):
    """The summary and confusion matrix printed and the mismatch MDRF
    returned equal ``evaluate.compare``'s."""
    video = str(clip / "synth.avi")
    base, new = _pair(video, gt_mode)
    jv = JVideo(video)
    want = jeval.compare(jv, jfrom_dict(JMDRF, base),
                         jfrom_dict(JMDRF, new))
    jv.release()
    want_out = capsys.readouterr().out
    tv = TVideo(video)
    got = teval.compare(tv, from_dict(TMDRF, base), from_dict(TMDRF, new))
    tv.release()
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert ("'recall'" in got_out) == gt_mode
    assert got.to_dict() == want.to_dict()
    assert len(got.results) >= 1


def _run_main(package: str, argv: list[str], cwd, monkeypatch, capsys):
    """``evaluate.main`` (reads ``sys.argv``) or the port's ``main(argv +
    ["--device", "cpu"])`` in ``cwd``; returns what it printed and the
    ``mismatch.json`` it wrote."""
    monkeypatch.chdir(cwd)
    if package == "jax":
        monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
        jeval.main()
    else:
        teval.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    with open(os.path.join(cwd, "mismatch.json"), encoding="utf-8") as f:
        return out, json.load(f)


def _summary(out: str) -> dict:
    return {k: float(v) for k, v in re.findall(
        r"'(precision|recall|f1|matched_num|considered_num)': ([0-9.]+)",
        out)}


def test_annotated_clip_recall_and_precision_match_jax(clip, tmp_path,
                                                       monkeypatch, capsys):
    """``main --metric --save-path`` on the annotated clip: the port on
    the CPU matches the meteor (recall 1.0) and gives evaluate.main's
    precision, records and mismatches; the saved MDRF carries the
    sampled performance."""
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    runs = {}
    for name in ("jax", "port"):
        cwd = tmp_path / name
        cwd.mkdir()
        argv = [str(clip / "anno.json"), "--cfg", str(clip / "cfg.json"),
                "--metric", "--save-path", str(cwd / "out.json")]
        out, mismatch = _run_main(name, argv, cwd, monkeypatch, capsys)
        with open(cwd / "out.json", encoding="utf-8") as f:
            runs[name] = (_summary(out), mismatch, json.load(f))
    got, want = runs["port"], runs["jax"]
    assert got[0]["recall"] == 1.0
    assert got[0] == want[0]
    assert got[1]["results"] == want[1]["results"]
    assert got[2]["results"] == want[2]["results"]
    perf = got[2]["performance"]
    assert sorted(perf) == sorted(want[2]["performance"])
    assert perf["cpu_core"] == os.cpu_count()
    assert perf["avg_mem_usage"] > 10 and perf["tot_time"] > 0


def test_main_load_metric_writes_evaluates_mismatch(clip, tmp_path,
                                                    monkeypatch, capsys):
    """``main --load MDRF --metric``: the same ``mismatch.json`` and the
    same printed summary as ``evaluate.main``; without a card the default
    device raises."""
    video = str(clip / "synth.avi")
    _, new = _pair(video, True)
    new_path = tmp_path / "new.json"
    with open(new_path, "w", encoding="utf-8") as f:
        json.dump(new, f)
    anno = _pair(video, True)[0]
    anno_path = tmp_path / "anno.json"
    with open(anno_path, "w", encoding="utf-8") as f:
        json.dump(anno, f)
    argv = [str(anno_path), "--load", str(new_path), "--metric"]
    outs = {}
    for name in ("jax", "port"):
        cwd = tmp_path / name
        cwd.mkdir()
        outs[name] = _run_main(name, argv, cwd, monkeypatch, capsys)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]["results"]
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teval.main(argv)


def test_process_sampler_reads_what_psutil_reads():
    """RSS equal to psutil's within 8 MiB (the two reads are moments
    apart); the CPU share of a busy loop between two calls near 100%
    (50-400), the first call 0.0, as psutil's."""
    psutil = pytest.importorskip("psutil")
    s = teval.ProcessSampler()
    assert s.cpu_percent() == 0.0
    assert abs(s.rss() - psutil.Process().memory_info().rss) < 8 << 20
    x = 0
    for i in range(3_000_000):
        x += i
    assert 50 <= s.cpu_percent() <= 400
