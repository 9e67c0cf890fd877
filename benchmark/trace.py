"""The traced run's profiler window: ``torch.profiler`` over one call of
the cell's entry, read in memory (no trace file is written).

The window opens with a warm-up step of small kernels, a 20 ms host wait
and as many small kernels again, whose records are dropped: CUPTI loses
the first records after it is enabled (64 pad kernels and the wait, as
``metdetpy_tpu_torch/profiling.py`` pads its traces). The traced call runs
inside a ``bench.window`` range; every device record (kernel, copy, fill)
that starts inside it counts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

PAD_KERNELS = 64
HEAD_WAIT_S = 0.02
WINDOW = "bench.window"
TOP = 10


def _pad(device: torch.device) -> None:
    if device.type != "cuda":
        return
    x = torch.zeros(1, device=device)
    for _ in range(PAD_KERNELS):
        x.add_(1)
    torch.cuda.synchronize(device)


@dataclass
class Trace:
    """What one traced call left: device intervals [start_ns, end_ns) with
    their names, the host ops, and the window's bounds."""
    window_ns: tuple = (0, 0)
    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name, thread)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self) -> float:
        """The union of the device intervals inside the window."""
        w0, w1 = self.window_ns
        total, end = 0, w0
        for s, e, _ in sorted(self.device):
            s, e = max(s, end), min(e, w1)
            if e > s:
                total += e - s
                end = e
        return total / 1e9

    def gaps(self) -> list:
        """Idle intervals of the device inside the window, longest first."""
        w0, w1 = self.window_ns
        out, end = [], w0
        for s, e, _ in sorted(self.device):
            if s > end:
                out.append((end, min(s, w1)))
            end = max(end, e)
        if end < w1:
            out.append((end, w1))
        return sorted(out, key=lambda g: g[0] - g[1])

    def device_seconds(self, name_part: str) -> tuple:
        """(seconds, records) of the device records whose name holds
        ``name_part``."""
        recs = [e - s for s, e, n in self.device if name_part in n]
        return sum(recs) / 1e9, len(recs)

    def host_at(self, t_ns: int) -> str:
        """The innermost host op of each thread running at ``t_ns``."""
        inner: dict = {}
        for s, e, n, th in self.host:
            if s <= t_ns < e and (th not in inner or s >= inner[th][0]):
                inner[th] = (s, n)
        names = sorted({n for _, n in inner.values()})
        return (" | ".join(names[:3]) if names
                else "python (no torch op or runtime call)")

    def breakdown(self) -> dict:
        by_name: dict = {}
        for s, e, n in self.device:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = [[self.host_at((a + b) // 2), (b - a) / 1e9]
                for a, b in self.gaps()[:TOP]]
        return {"device_ops": [[n[:160], v / 1e9] for n, v in ops],
                "idle_gaps": gaps}


def _annotation(e) -> bool:
    """A host range's copy on the device's timeline (``bench.window``, a
    profiler step), which is no device work."""
    kind = getattr(e, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return True
    name = e.name()
    return name == WINDOW or name.startswith("ProfilerStep")


def _events(prof):
    """(name, is_device, start_ns, end_ns, thread) of every record."""
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        if dev and _annotation(e):
            continue  # a range's copy on the device's timeline
        s = e.start_ns()
        yield e.name(), dev, s, s + e.duration_ns(), e.start_thread_id()


class Tracer:
    """``with Tracer(device) as tr: call()`` leaves ``tr.trace``."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.trace: Trace | None = None
        self.read_s = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
        self.prof.start()
        _pad(self.device)
        self.prof.step()
        if self.device.type == "cuda":
            time.sleep(HEAD_WAIT_S)
        _pad(self.device)
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.range.__exit__(None, None, None)
        self.prof.stop()
        t0 = time.perf_counter()
        tr = Trace()
        window = None
        rows = list(_events(self.prof))
        for name, dev, s, e, th in rows:
            if not dev and name == WINDOW:
                window = (s, e)
        if window is not None:
            tr.window_ns = window
            for name, dev, s, e, th in rows:
                if not window[0] <= s < window[1]:
                    continue
                if dev:
                    tr.device.append((s, e, name))
                elif name != WINDOW:
                    tr.host.append((s, e, name, th))
        self.trace = tr
        self.read_s = time.perf_counter() - t0
