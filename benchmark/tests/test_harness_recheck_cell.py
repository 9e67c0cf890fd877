"""The ``m3_1080p_recheck`` cell: its files found by name, a small CPU run
of it against the plain reference, and the readers of the recheck's spans
and counters."""

import functools
import time
import types

import pytest
import torch

from _cpu import DRAFT_LIMITS, DRAFT_MIX, DRAFT_SMALL, MODEL_HW, SEED, bench

from benchmark.cell import Call, metric_module

CELL = "m3_1080p_recheck"
READERS = ("recheck.forward_ms_per_clip", "recheck.mfu_pct",
           "exporter.join_ms_per_call", "loader.color_stack_ms_per_block")


def test_the_cell_s_files_are_found_by_name():
    from benchmark import cell
    files = cell.cell_files(bench(), CELL)
    assert files["workload"]["config"] == "m3det_normal_recheck"
    assert files["workload"]["traffic"] == DRAFT_MIX
    recheck = files["config"]["collector"]["recheck_cfg"]
    assert recheck["switch"] is True
    assert recheck["model"]["multiscale_pred"] == 2
    assert recheck["model"]["input_hw"] == "320x320"
    assert files["spec"] == {"entry": "detect_video", "control": "int8",
                             "limits": DRAFT_LIMITS}
    with pytest.raises(KeyError):
        cell.cell_files(bench(), CELL + "_absent")


def test_a_small_run_of_the_cell_is_correct_in_float32(monkeypatch):
    """The cell's own files at a small size, the port's YOLOv5s with a
    float32 body as the reference's: every comparison reads 0, and the
    traced run reports the recheck's per-layer metrics."""
    from benchmark import cell
    from metdetpy_tpu_torch.models import yolo, yolov5
    monkeypatch.setattr(yolov5, "YOLOv5", functools.partial(
        yolov5.YOLOv5, dtype=torch.float32))
    monkeypatch.setattr(yolo, "_WEIGHT_CACHE", {})
    run = cell.Run(CELL, SEED, 0, True, "cpu", time.time(),
                   traffic=DRAFT_SMALL, model_hw=MODEL_HW)
    out = run.execute()
    assert out["correct"] is True
    assert out["checks"]["line_gap"]["value"] == 0.0
    assert out["checks"]["recheck_gap"]["value"] == 0.0
    assert set(READERS) | {"recheck_cell.frames_per_s"} == set(
        out["metrics"])
    perf = run.calls[0].perf
    assert perf["recheck_clips"] >= 1
    assert perf["recheck_tiles"] == perf["recheck_clips"] * 10


def _run(perfs, traced=()):
    calls = [Call(0.0, 1.0, perf=dict(p), traced=i in traced)
             for i, p in enumerate(perfs)]
    config = {"collector": {"recheck_cfg": {"model": {
        "input_hw": "320x320"}}}}
    return types.SimpleNamespace(calls=calls, trace=None, config=config)


PERF = {"recheck_forward_s": 0.06, "recheck_clips": 2, "recheck_tiles": 20,
        "exporter_join_s": 0.05, "loader_color_stack_s": 0.12,
        "dispatch_calls": 12}


def test_the_readers_read_the_untraced_calls():
    from benchmark.work import peaks, yolov5s
    traced = dict(PERF, recheck_forward_s=9.0, exporter_join_s=9.0,
                  loader_color_stack_s=9.0)
    run = _run([PERF, traced, dict(PERF, exporter_join_s=0.15)],
               traced={1})
    read = {m: metric_module(m).read(run) for m in READERS}
    assert read["recheck.forward_ms_per_clip"] == pytest.approx(30.0)
    assert read["exporter.join_ms_per_call"] == pytest.approx(100.0)
    assert read["loader.color_stack_ms_per_block"] == pytest.approx(10.0)
    flops = 40 * yolov5s.forward_flops(320, 320, 8)
    assert read["recheck.mfu_pct"] == pytest.approx(
        100.0 * flops / (0.12 * peaks.BF16_FLOP_PER_S))


def test_the_cell_s_rate_reads_the_untraced_calls():
    read = metric_module("recheck_cell.frames_per_s").read
    run = _run([{}, {}, {}], traced={1})
    for c, seconds in zip(run.calls, (2.0, 9.0, 3.0)):
        c.frames, c.t1 = 750, seconds
    assert read(run) == pytest.approx(1500 / 5.0)
    assert read(_run([])) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_without_its_keys(name):
    """As a program without the recheck's spans gives (or a call with the
    recheck off, which forwards no clip)."""
    read = metric_module(name).read
    assert read(_run([{"dispatch_calls": 12, "init_s": 0.01}])) is None
    assert read(_run([])) is None
    assert read(_run([PERF], traced={0})) is None
