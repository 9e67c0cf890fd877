"""The port's one span recorder and the profiler trace of a run.

``StageTimer`` is the recorder of one ``detect_video`` call, handed to the
loader's threads, the detector and its step graph: each ``span`` adds its
seconds and a count to the call's totals (MDRF ``performance``), and while
a ``torch.profiler`` runs it also goes into ``SPAN_LOG`` on the clock of
the profiler's own records, from whatever thread it ran on, and on the
thread that started the profiler it is a range of the profiler's host
timeline.
``maybe_torch_trace``, the counterpart of the JAX package's
``maybe_jax_trace``, writes a ``torch.profiler`` trace of the detection loop
with those spans when ``METDETPY_TPU_TRACE_DIR`` is set.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# spans recorded while a profiler ran, oldest first, from every thread:
# (name, thread name, start ns, end ns, wait) on ``time.time_ns()``'s
# clock, which the profiler's host records use too
SPAN_LOG_MAX = 200_000
SPAN_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG_MAX)


def summary_key(name: str) -> str:
    """The MDRF ``performance`` key of a span or counter: dots become
    underscores, and the api loop's spans (``api.*``) keep the loop's
    stage names (``api.dispatch`` -> ``dispatch``)."""
    if name.startswith("api."):
        name = name[4:]
    return name.replace(".", "_")


class _Span:
    """One timed region of a ``StageTimer`` (see ``StageTimer.span``)."""

    __slots__ = ("_timer", "_name", "_wait", "_t0", "_logged", "_range")

    def __init__(self, timer: "StageTimer", name: str, wait: bool) -> None:
        self._timer, self._name, self._wait = timer, name, wait
        self._t0 = None

    def __enter__(self) -> "_Span":
        self._range = None
        self._logged = _autograd_profiler._is_profiler_enabled
        if self._logged and torch._C._autograd._profiler_enabled():
            # the profiler's own thread: a range on its host timeline. Not
            # record_function's user annotation: kineto spreads that over
            # the kernels launched inside it, on the device's timeline,
            # where a reader of the trace counts it as device work
            self._range = torch._C._profiler._RecordFunctionFast(self._name)
        self._t0 = time.time_ns()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        t0 = self._t0
        if t0 is None:  # closed already
            return
        self._t0 = None
        if self._range is not None:
            self._range.__exit__(None, None, None)
        t1 = time.time_ns()
        self._timer._add(self._name, (t1 - t0) / 1e9)
        if self._logged:
            SPAN_LOG.append((self._name, threading.current_thread().name,
                             t0, t1, self._wait))


class StageTimer:
    """The span recorder of one pipeline run: named spans' seconds and
    counts, counters, and the frames done. Safe to share between the
    run's threads."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.values: dict[str, int] = {}
        self.frames = 0
        self.t_start = time.time()
        self._lock = threading.Lock()

    def span(self, name: str, wait: bool = False) -> _Span:
        """A context manager that adds its seconds to ``totals[name]`` and
        one to ``counts[name]``. ``wait=True`` marks time blocked on
        another thread or on the card. While a profiler runs the span is
        also logged (``SPAN_LOG``), and on the profiler's thread it is a
        host range named ``name`` in the profiler's records. ``__exit__``
        may be called more than once; the first call ends the span."""
        return _Span(self, name, wait)

    stage = span

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name`` (bytes moved, say)."""
        with self._lock:
            self.values[name] = self.values.get(name, 0) + n

    def snapshot(self) -> tuple:
        """Copies of (totals, counts, values), taken together."""
        with self._lock:
            return dict(self.totals), dict(self.counts), dict(self.values)

    def add_frames(self, n: int) -> None:
        self.frames += n

    def summary(self) -> dict[str, float]:
        wall = time.time() - self.t_start
        out: dict[str, float] = {
            "wall_time_s": round(wall, 4),
            "frames": self.frames,
            "frames_per_sec": round(self.frames / wall, 2) if wall else 0.0,
        }
        totals, counts, values = self.snapshot()
        for name, total in sorted(totals.items()):
            key = summary_key(name)
            out[f"{key}_s"] = round(total, 4)
            out[f"{key}_calls"] = counts[name]
        for name, value in sorted(values.items()):
            out[summary_key(name)] = value
        return out

    def log_summary(self, logger) -> None:
        s = self.summary()
        logger.debug("Pipeline stages: " + ", ".join(
            f"{k}={v}" for k, v in s.items()))


def _new_trace_path(trace_dir: str) -> str:
    """A file of TensorBoard's profile layout
    (``<host>_<pid>.<stamp>.pt.trace.json``) that no earlier run wrote,
    reserved by creating it empty."""
    worker = f"{socket.gethostname()}_{os.getpid()}"
    stamp = time.time_ns()
    while True:
        path = os.path.join(trace_dir, f"{worker}.{stamp}.pt.trace.json")
        try:
            os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return path
        except FileExistsError:
            stamp += 1


_PAD_KERNELS = 64
_HEAD_WAIT_S = 0.02


def _pad_kernels(device: torch.device) -> None:
    """A few small kernels on ``device``, waited for (none on the CPU)."""
    if device.type != "cuda":
        return
    x = torch.zeros(1, device=device)
    for _ in range(_PAD_KERNELS):
        x.add_(1)
    torch.cuda.synchronize(device)

# the last trace's file, size and host seconds of the profiler's start,
# stop and export: what tracing costs a run
last_trace_stats: dict = {}


@contextlib.contextmanager
def maybe_torch_trace(device: torch.device):
    """``torch.profiler`` trace of the block when METDETPY_TPU_TRACE_DIR is
    set: CPU activity, and CUDA activity where ``device`` is a card. On exit
    (also on an exception) it writes one Chrome-trace JSON file into that
    directory under a new name. Without the variable no profiler is
    created. Errors of the profiler propagate."""
    trace_dir: Optional[str] = os.environ.get("METDETPY_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    last_trace_stats.clear()
    t0 = time.perf_counter()
    # CUPTI may lose the first kernel records after it is enabled (2 to 9
    # of them, seen on an H100 with torch 2.11), once also the first of
    # the recorded step: a warm-up step with small kernels, whose records
    # are discarded, and as many again at the head of the recorded step
    # take that loss. In profile_step's windows the loss once reached past
    # 64 head kernels launched at once after the step began; a host wait
    # first kept every record (tools/torch_profile_pad_check.py)
    prof = torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
    prof.start()
    _pad_kernels(device)
    w0 = time.time_ns()
    prof.step()
    if device.type == "cuda":
        time.sleep(_HEAD_WAIT_S)
    _pad_kernels(device)
    t1 = time.perf_counter()
    try:
        yield
    finally:
        t2 = time.perf_counter()
        prof.stop()
        w1 = time.time_ns()
        t3 = time.perf_counter()
        path = _new_trace_path(trace_dir)
        prof.export_chrome_trace(path)
        spans = add_spans_to_trace(path, w0, w1)
        last_trace_stats.update(
            path=path, bytes=os.path.getsize(path), start_s=t1 - t0,
            stop_s=t3 - t2, export_s=time.perf_counter() - t3, spans=spans)


# the spans' rows in a trace file: a thread id of their own a thread name,
# apart from the profiler's rows of the same threads
_SPAN_TID0 = 1 << 30


def add_spans_to_trace(path: str, w0_ns: int, w1_ns: int) -> int:
    """Write the ``SPAN_LOG`` entries that start in [w0_ns, w1_ns) into the
    Chrome-trace file ``path`` as complete events (category
    ``metdetpy_span``), a row for each thread name (``spans: <name>``), on
    the file's own time base; returns how many went in."""
    rows = [r for r in list(SPAN_LOG) if w0_ns <= r[2] < w1_ns]
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    tids = {th: _SPAN_TID0 + i
            for i, th in enumerate(sorted({r[1] for r in rows}))}
    events = trace.setdefault("traceEvents", [])
    for th, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"spans: {th}"}})
    for name, th, t0, t1, wait in rows:
        events.append({"ph": "X", "cat": "metdetpy_span", "name": name,
                       "pid": pid, "tid": tids[th],
                       "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
                       "args": {"thread": th, "wait": wait}})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return len(rows)
