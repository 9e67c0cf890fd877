"""The readers of the program's spans: each gives its number on a made-up
run and None where the run has no trace, no span or no such key (as a
program without the spans gives)."""

import collections
import types

import pytest

from _cpu import DL, M3, small_run  # noqa: F401  (puts the root on the path)

from benchmark.cell import Call, metric_module
from benchmark.trace import Trace


def _run(perfs, trace=None, traced=()):
    calls = [Call(0.0, 1.0, perf=dict(p), traced=i in traced)
             for i, p in enumerate(perfs)]
    return types.SimpleNamespace(calls=calls, trace=trace)


def test_init_ms_per_call_is_the_mean_of_the_untraced_calls():
    read = metric_module("api.init_ms_per_call").read
    run = _run([{"init_s": 0.1}, {"init_s": 9.0}, {"init_s": 0.3}],
               traced={1})
    assert read(run) == pytest.approx(200.0)
    assert read(_run([{"dispatch_s": 1.0}])) is None
    assert read(_run([])) is None


def test_dldet_frames_per_s_reads_the_untraced_calls():
    read = metric_module("dldet.frames_per_s").read
    run = _run([{}, {}, {}], traced={1})
    for c, frames, seconds in zip(run.calls, (500, 500, 500),
                                  (0.5, 9.0, 0.75)):
        c.frames, c.t1 = frames, seconds
    assert read(run) == pytest.approx(1000 / 1.25)
    assert read(_run([])) is None


def test_merge_ms_per_block_adds_the_preprocess():
    read = metric_module("loader.merge_ms_per_block").read
    run = _run([{"loader_merge_s": 0.4, "loader_preproc_s": 0.1,
                 "dispatch_calls": 2},
                {"loader_merge_s": 0.2, "dispatch_calls": 1}])
    assert read(run) == pytest.approx(1000.0 * 0.7 / 3)
    # the loader's older keys (no span) are not the span's
    assert read(_run([{"loader_merge": 0.4, "dispatch_calls": 2}])) is None


def test_step_graph_call_ms_per_block_adds_its_parts():
    read = metric_module("step_graph.call_ms_per_block").read
    run = _run([{"step_graph_frames_copy_s": 0.003,
                 "step_graph_replay_s": 0.002,
                 "step_graph_out_clone_s": 0.001, "dispatch_calls": 3},
                {"step_graph_replay_s": 5.0, "dispatch_calls": 1}],
               traced={1})
    assert read(run) == pytest.approx(2.0)
    # where the wait lands on the copy or on the replay, the same number
    moved = _run([{"step_graph_frames_copy_s": 0.0005,
                   "step_graph_replay_s": 0.0045,
                   "step_graph_out_clone_s": 0.001, "dispatch_calls": 3}])
    assert read(moved) == pytest.approx(2.0)
    assert read(_run([{"dispatch_calls": 3}])) is None


MS = 1_000_000


def _trace():
    # a 100 ms window; the card busy in [0, 20) and [50, 60) ms
    return Trace(window_ns=(0, 100 * MS),
                 device=[(0, 20 * MS, "k"), (50 * MS, 60 * MS, "k")])


def _log(monkeypatch, rows):
    from metdetpy_tpu_torch import profiling
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque(rows))


def test_idle_unattributed_takes_off_the_spans_of_work(monkeypatch):
    read = metric_module("device.idle_unattributed_pct").read
    _log(monkeypatch, [
        # the main thread works in [20, 40) ms
        ("api.dispatch", "MainThread", 20 * MS, 40 * MS, False),
        # a waiting thread explains nothing
        ("api.decode_wait", "MainThread", 60 * MS, 90 * MS, True),
        # a span that holds others counts only through them: its moments
        # outside the wait inside it, [95, 100), explain nothing
        ("loader.loop", "loader.decode", 60 * MS, 100 * MS, False),
        ("loader.qput", "loader.decode", 60 * MS, 95 * MS, True),
    ])
    # idle: [20, 50) and [60, 100) = 70 ms; worked: [20, 40)
    assert read(types.SimpleNamespace(trace=_trace())) == pytest.approx(50.0)


def test_idle_unattributed_counts_the_work_inside_an_envelope(monkeypatch):
    read = metric_module("device.idle_unattributed_pct").read
    _log(monkeypatch, [
        # api.init holds a span of work in [25, 30) and one that starts
        # with it, [20, 22)
        ("api.init", "MainThread", 20 * MS, 45 * MS, False),
        ("api.init.loader", "MainThread", 20 * MS, 22 * MS, False),
        ("api.init.detector", "MainThread", 25 * MS, 30 * MS, False),
        # api.release is a wait; the span after it works in [70, 80)
        ("api.release", "MainThread", 60 * MS, 70 * MS, True),
        ("collect.post", "MainThread", 70 * MS, 80 * MS, False),
        # spans outside the window count only inside it
        ("loader.read", "loader.decode", 95 * MS, 130 * MS, False),
    ])
    # idle 70 ms; worked: 2 + 5 + 10 + 5 ms
    assert read(types.SimpleNamespace(trace=_trace())) == pytest.approx(48.0)


def test_idle_unattributed_is_none_without_a_trace_or_spans(monkeypatch):
    read = metric_module("device.idle_unattributed_pct").read
    _log(monkeypatch, [("api.dispatch", "MainThread", 0, MS, False)])
    assert read(types.SimpleNamespace(trace=None)) is None
    # spans, but none in the traced call
    late = [("api.dispatch", "MainThread", 200 * MS, 300 * MS, False)]
    _log(monkeypatch, late)
    assert read(types.SimpleNamespace(trace=_trace())) is None
    _log(monkeypatch, [])
    assert read(types.SimpleNamespace(trace=_trace())) is None
    # a program that keeps no span log
    from metdetpy_tpu_torch import profiling
    monkeypatch.delattr(profiling, "SPAN_LOG")
    assert read(types.SimpleNamespace(trace=_trace())) is None


def test_idle_unattributed_in_a_traced_cpu_run():
    """On the CPU the trace has no device record, so the reader gives
    None; the spans of the traced call are in the log."""
    from metdetpy_tpu_torch import profiling
    run, out = small_run(M3, trace=True)
    names = {r[0] for r in profiling.SPAN_LOG}
    assert {"api.init", "api.dispatch", "api.decode_wait",
            "loader.upload"} <= names
    assert "device.idle_unattributed_pct" not in out["metrics"]
    assert out["metrics"]["api.init_ms_per_call"]["value"] > 0
