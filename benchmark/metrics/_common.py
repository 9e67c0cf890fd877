"""What several readers share."""

from __future__ import annotations


def untraced(run) -> list:
    """The window's calls that ran without the profiler."""
    return [c for c in run.calls if not c.traced and not c.error]


def per_block_ms(run, key: str):
    """Milliseconds a block of an MDRF ``performance`` span (``<key>``),
    over the untraced calls: its seconds over their blocks (the
    ``dispatch`` span's count: one a block)."""
    calls = untraced(run)
    blocks = sum(int(c.perf.get("dispatch_calls", 0)) for c in calls)
    if not blocks or not any(key in c.perf for c in calls):
        return None
    return 1000.0 * sum(float(c.perf.get(key, 0.0)) for c in calls) / blocks


def kernel_roofline(run, name: str):
    """The kernel's share of its roofline in the traced call: the least
    time of its launches at the main path's shapes over their device time,
    in percent. None where the trace has no record of it."""
    from benchmark.work import kernels
    if run.trace is None:
        return None
    seconds, launches = run.trace.device_seconds(name + "_kernel")
    if not launches or seconds <= 0:
        return None
    h, w = run.entry.hw
    return 100.0 * launches * kernels.launch_least_seconds(name, h, w) \
        / seconds
