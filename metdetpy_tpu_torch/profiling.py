"""Pipeline stage timers (host clock).

Named stage accumulators for the block loop (decode wait, dispatch,
collect, collector) and a frames/sec summary; a copy of the JAX package's
``StageTimer``.
"""

from __future__ import annotations

import contextlib
import time


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
