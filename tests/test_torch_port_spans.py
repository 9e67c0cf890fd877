"""The port's span recorder (``profiling.StageTimer``) on the CPU: the
totals it keeps for MDRF ``performance``, the log of every thread's spans
on the profiler's clock while a profiler runs (``profiling.SPAN_LOG``),
the ranges it opens on the profiler's own thread, and the spans of a
``detect_video`` call in its ``performance`` and in the trace file of
``METDETPY_TPU_TRACE_DIR``."""

import json
import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

from metdetpy_tpu_torch import profiling
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.io.videoloader import (DEFAULT_BLOCK_FRAMES,
                                               BlockVideoLoader)
from metdetpy_tpu_torch.io.videowrapper import NumpyVideoWrapper
from metdetpy_tpu_torch.profiling import SPAN_LOG, StageTimer, summary_key
from metdetpy_tpu_torch.structs import MainDetectCfg
from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu_torch.utils import relative2abs_path

torch.set_num_threads(2)

W, H, FPS = 256, 144, 25.0
# the MDRF performance keys a detect_video call of the clip below gives
# (the block loader in device-put mode on the CPU, whose in-memory gray
# source is neither read nor merged) that a reader reads: the api loop's
# stages, and the loader's spans and placement
KEYS_READ = {
    "collect_calls", "collect_s", "collector_update_calls",
    "collector_update_s", "decode_wait_calls", "decode_wait_s",
    "dispatch_calls", "dispatch_s", "frames", "frames_per_sec",
    "loader_h2d_bytes", "loader_h2d_s", "loader_loop_s",
    "loader_placement", "loader_qput_s", "recovered_blocks",
    "wall_time_s"}
# the loader's figures that are its spans' now (``loader_<name>_s``), and
# its pool lease, which nothing read
KEYS_GONE = {"loader_loop_wall", "loader_merge", "loader_preproc",
             "loader_qput", "loader_read", "loader_pool_s",
             "loader_pool_bytes"}


@pytest.fixture(autouse=True)
def _empty_log():
    SPAN_LOG.clear()
    yield
    SPAN_LOG.clear()


@pytest.fixture(scope="module")
def frames():
    meteor = SynthMeteor(start_sec=0.8, end_sec=2.2,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    return generate_meteor_video(width=W, height=H, fps=FPS,
                                 duration_sec=3.0, meteors=[meteor],
                                 n_stars=40, noise_sigma=3.0)


def _detect(frames):
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    return detect_video(frames.copy(), None, cfg, work_mode="backend",
                        device="cpu")


def test_span_without_a_profiler_adds_to_the_totals_only():
    rec = StageTimer()
    for _ in range(3):
        with rec.span("loader.merge"):
            pass
    with rec.stage("collect"):  # the older name of span
        pass
    rec.count("loader.h2d_bytes", 5)
    rec.count("loader.h2d_bytes", 7)
    assert rec.counts == {"loader.merge": 3, "collect": 1}
    assert rec.totals["loader.merge"] >= 0.0
    assert len(SPAN_LOG) == 0
    out = rec.summary()
    assert out["loader_merge_calls"] == 3 and out["collect_calls"] == 1
    assert out["loader_h2d_bytes"] == 12
    assert {"loader_merge_s", "collect_s", "wall_time_s", "frames",
            "frames_per_sec"} <= set(out)


def test_summary_keys_keep_the_loop_stage_names():
    assert summary_key("api.dispatch") == "dispatch"
    assert summary_key("api.init.loader") == "init_loader"
    assert summary_key("step_graph.replay") == "step_graph_replay"
    assert summary_key("collect.fetch_bytes") == "collect_fetch_bytes"
    assert summary_key("synth_batch") == "synth_batch"


def test_a_span_ends_once():
    rec = StageTimer()
    sp = rec.span("api.init")
    sp.__enter__()
    sp.__exit__(None, None, None)
    sp.__exit__(None, None, None)
    assert rec.counts == {"api.init": 1}


def test_spans_of_many_threads_lose_no_count():
    """The loader's threads and the main thread add to one recorder: no
    update is lost when they switch often."""
    rec = StageTimer()
    start = threading.Barrier(6)

    def spans():
        start.wait(timeout=60)
        for i in range(10000):
            with rec.span("loader.merge"):
                pass
            if i % 2:
                rec.count("loader.h2d_bytes", 2)
    threads = [threading.Thread(target=spans) for _ in range(6)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert rec.counts["loader.merge"] == 60000
    assert rec.values["loader.h2d_bytes"] == 60000


def _worker(rec, started):
    with rec.span("loader.merge"):
        with rec.span("loader.qput", wait=True):
            started.set()


def test_profiled_spans_of_every_thread_are_logged_with_their_nesting():
    rec = StageTimer()
    started = threading.Event()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("api.dispatch"):
            with rec.span("step_graph.replay"):
                torch.ones(4).add_(1)
        th = threading.Thread(target=_worker, args=(rec, started),
                              name="loader.decode")
        th.start()
        th.join()
    with rec.span("api.collect"):  # after the profiler: not logged
        pass
    assert started.is_set()
    rows = {r[0]: r for r in SPAN_LOG}
    assert set(rows) == {"api.dispatch", "step_graph.replay",
                         "loader.merge", "loader.qput"}
    me = threading.current_thread().name
    assert rows["api.dispatch"][1] == rows["step_graph.replay"][1] == me
    assert rows["loader.merge"][1] == rows["loader.qput"][1] == (
        "loader.decode")
    assert [rows[n][4] for n in ("api.dispatch", "loader.merge",
                                 "loader.qput")] == [False, False, True]
    for outer, inner in (("api.dispatch", "step_graph.replay"),
                         ("loader.merge", "loader.qput")):
        assert rows[outer][2] <= rows[inner][2] <= rows[inner][3] \
            <= rows[outer][3]
    assert rec.counts["api.collect"] == 1


def test_main_thread_spans_are_profiler_ranges_on_its_clock():
    rec = StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with rec.span(f"api.span{i}"):
                torch.ones(8).mul_(2)
        th = threading.Thread(
            target=lambda: rec.span("loader.read").__enter__().__exit__(),
            name="loader.decode")
        th.start()
        th.join()
    starts = {}
    for e in prof.profiler.kineto_results.events():
        starts.setdefault(e.name(), e.start_ns())
    logged = {r[0]: r for r in SPAN_LOG}
    assert "loader.read" in logged and "loader.read" not in starts
    for i in range(5):
        t0 = logged[f"api.span{i}"][2]
        assert abs(starts[f"api.span{i}"] - t0) <= 1_000_000


@pytest.mark.parametrize("exp_frames", [1, 2])
def test_host_merge_span_pauses_while_a_block_is_queued(exp_frames):
    """The host loop's merge span closes while a full block is queued
    (``loader.qput``) and opens again after it: on the decode thread the
    two never overlap, and each queued block ends a merge span."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (21 * exp_frames, 32, 48), np.uint8)
    rec = StageTimer()
    ld = BlockVideoLoader(NumpyVideoWrapper, frames, spans=rec,
                          exp_option=exp_frames / FPS, merge_func="max",
                          grayscale=True, block_frames=8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ld.start()
        n = 0
        while ld.pop_block() is not None:
            n += 1
        ld.release()
    assert n == 3 and ld.stage_stats["placement"] == "host"
    rows = [r for r in SPAN_LOG if r[1] == "loader.decode"]
    merges = [r for r in rows if r[0] == "loader.merge"]
    puts = [r for r in rows if r[0] == "loader.qput"]
    assert len(puts) == rec.counts["loader.qput"] == 3
    assert len(merges) == rec.counts["loader.merge"] >= 3
    for m in merges:
        for q in puts:
            assert m[3] <= q[2] or q[3] <= m[2]
    for q in puts[:2]:  # the full blocks; the tail is queued after the loop
        assert any(m[3] <= q[2] and q[2] - m[3] < 1_000_000
                   for m in merges)
    loop = [r for r in rows if r[0] == "loader.loop"]
    assert len(loop) == 1
    assert all(loop[0][2] <= r[2] and r[3] <= loop[0][3] for r in rows)


def test_detect_video_keeps_its_performance_keys_and_adds_init(frames):
    perf = _detect(frames).performance
    assert KEYS_READ <= set(perf)
    assert not KEYS_GONE & set(perf)
    # every span with its call count
    for key in perf:
        if key.endswith("_s") and key != "wall_time_s":
            assert isinstance(perf[key[:-2] + "_calls"], int), key
    blocks = math.ceil(perf["frames"] / DEFAULT_BLOCK_FRAMES)
    assert perf["frames"] == len(frames)
    assert perf["dispatch_calls"] == blocks
    assert perf["decode_wait_calls"] == blocks + 1
    assert perf["collect_calls"] == 1
    assert perf["collector_update_calls"] >= 1
    assert perf["init_calls"] == perf["release_calls"] == 1
    assert perf["init_s"] >= (perf["init_loader_s"] + perf["init_detector_s"]
                              - 2e-4)
    # the upload's span holds the copy's (the CPU waits for no event)
    assert perf["loader_h2d_calls"] == perf["loader_upload_calls"] == blocks
    assert perf["loader_h2d_s"] >= perf["loader_upload_s"]
    assert perf["loader_h2d_bytes"] == frames.nbytes
    # the in-memory source staged block by block into the pinned ring
    assert perf["loader_stage_bytes"] == frames.nbytes
    assert perf["loader_stage_calls"] == blocks
    assert "loader_read_s" not in perf and "loader_merge_s" not in perf
    assert perf["loader_loop_s"] >= perf["loader_qput_s"] - 2e-4
    assert perf["loader_qput_calls"] == blocks
    assert perf["collect_fetch_calls"] == 1
    assert len(SPAN_LOG) == 0


def test_trace_file_holds_the_loader_threads_spans(frames, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_TRACE_DIR", str(tmp_path))
    _detect(frames)
    path = profiling.last_trace_stats["path"]
    assert os.path.dirname(path) == str(tmp_path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "metdetpy_span"]
    assert len(spans) == profiling.last_trace_stats["spans"] > 0
    threads = {e["args"]["thread"] for e in spans}
    assert {"loader.decode", "loader.upload"} <= threads
    names = {e["name"] for e in spans}
    assert {"api.dispatch", "api.decode_wait", "loader.qput",
            "loader.upload"} <= names
    rows = {e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"spans: loader.decode", "spans: loader.upload"} <= rows
    for e in spans:
        assert e["dur"] >= 0 and isinstance(e["args"]["wait"], bool)
