"""Pipeline stage timers (host clock) and the profiler trace of a run.

Named stage accumulators for the block loop (decode wait, dispatch,
collect, collector) and a frames/sec summary, a copy of the JAX package's
``StageTimer``; and ``maybe_torch_trace``, the counterpart of its
``maybe_jax_trace``: a ``torch.profiler`` trace of the detection loop when
``METDETPY_TPU_TRACE_DIR`` is set.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional

import torch


class StageTimer:
    """Accumulating named stage timers + counters for one pipeline run."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.frames = 0
        self.t_start = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_frames(self, n: int) -> None:
        self.frames += n

    def summary(self) -> dict[str, float]:
        wall = time.time() - self.t_start
        out: dict[str, float] = {
            "wall_time_s": round(wall, 4),
            "frames": self.frames,
            "frames_per_sec": round(self.frames / wall, 2) if wall else 0.0,
        }
        for name, total in sorted(self.totals.items()):
            out[f"{name}_s"] = round(total, 4)
            out[f"{name}_calls"] = self.counts[name]
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
        t3 = time.perf_counter()
        path = _new_trace_path(trace_dir)
        prof.export_chrome_trace(path)
        last_trace_stats.update(
            path=path, bytes=os.path.getsize(path), start_s=t1 - t0,
            stop_s=t3 - t2, export_s=time.perf_counter() - t3)
