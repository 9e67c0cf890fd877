"""The profiler trace of a detection run in the PyTorch port
(``METDETPY_TPU_TRACE_DIR``, ``profiling.maybe_torch_trace``) on the CPU.

With the variable set, ``detect_video`` writes one Chrome-trace file per
run into that directory, beside what is there, and gives the records of
the untraced run (which ``tests/test_torch_port_e2e.py`` holds against the
JAX package); without it no profiler is created.
"""

import json
import os

import pytest
import torch

from metdetpy_tpu_torch import profiling
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.structs import MainDetectCfg
from metdetpy_tpu_torch.synth import (SynthMeteor, generate_meteor_video,
                                      write_video)
from metdetpy_tpu_torch.utils import relative2abs_path

torch.set_num_threads(2)

W, H, FPS = 256, 144, 25.0
TRACE_SUFFIX = ".pt.trace.json"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    meteor = SynthMeteor(start_sec=0.8, end_sec=2.2,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    frames = generate_meteor_video(width=W, height=H, fps=FPS,
                                   duration_sec=3.0, meteors=[meteor],
                                   n_stars=40, noise_sigma=3.0)
    path = str(tmp_path_factory.mktemp("trace_clip") / "clip.avi")
    write_video(frames, path, fps=FPS)
    return path


def _cfg(loader="BlockVideoLoader"):
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = loader
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    return cfg


def _results(clip, loader="BlockVideoLoader"):
    mdrf = detect_video(clip, None, _cfg(loader), work_mode="backend",
                        device="cpu")
    return mdrf.to_dict()["results"]


@pytest.fixture(scope="module")
def untraced(clip):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("METDETPY_TPU_TRACE_DIR", raising=False)
        results = _results(clip)
    assert results, "the clip's meteor gives no record"
    return results


def _traces(trace_dir):
    return sorted(f for f in os.listdir(trace_dir)
                  if f.endswith(TRACE_SUFFIX))


def test_traced_run_writes_one_parseable_trace(clip, untraced, tmp_path,
                                               monkeypatch):
    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("METDETPY_TPU_TRACE_DIR", str(trace_dir))
    assert _results(clip) == untraced
    files = _traces(trace_dir)
    assert len(files) == 1 and os.listdir(trace_dir) == files
    with open(trace_dir / files[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    # the plain versions of the block step's kernels ran under the trace:
    # the vote's scatter-add, the pick's running maximum
    assert {"aten::scatter_add_", "aten::cummax"} <= ops
    stats = profiling.last_trace_stats
    assert stats["path"] == str(trace_dir / files[0])
    assert stats["bytes"] == os.path.getsize(stats["path"])
    assert min(stats["start_s"], stats["stop_s"], stats["export_s"]) >= 0


def test_second_traced_run_keeps_the_first(clip, untraced, tmp_path,
                                           monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_TRACE_DIR", str(tmp_path))
    earlier = tmp_path / "host_1.1.pt.trace.json"
    earlier.write_text('{"traceEvents": []}')
    assert _results(clip) == untraced
    files = _traces(tmp_path)
    assert len(files) == 2 and earlier.name in files
    assert earlier.read_text() == '{"traceEvents": []}'


def test_trace_path_never_reuses_a_name(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling.time, "time_ns", lambda: 1000)
    first = profiling._new_trace_path(str(tmp_path))
    second = profiling._new_trace_path(str(tmp_path))
    assert first != second
    assert first.endswith(".1000" + TRACE_SUFFIX)
    assert second.endswith(".1001" + TRACE_SUFFIX)


def test_frame_loop_is_traced(clip, untraced, tmp_path, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_TRACE_DIR", str(tmp_path))
    plain = _results(clip, "VanillaVideoLoader")
    assert len(_traces(tmp_path)) == 1
    monkeypatch.delenv("METDETPY_TPU_TRACE_DIR")
    assert _results(clip, "VanillaVideoLoader") == plain


def _no_profiler(*args, **kwargs):
    raise AssertionError("torch.profiler.profile entered")


def test_unset_variable_creates_no_profiler(clip, untraced, tmp_path,
                                            monkeypatch):
    monkeypatch.delenv("METDETPY_TPU_TRACE_DIR", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", _no_profiler)
    monkeypatch.chdir(tmp_path)
    assert _results(clip) == untraced
    assert os.listdir(tmp_path) == []


def test_profiler_error_propagates(clip, tmp_path, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.profiler, "profile", _no_profiler)
    with pytest.raises(AssertionError, match="torch.profiler.profile"):
        _results(clip)
    assert _traces(tmp_path) == []
