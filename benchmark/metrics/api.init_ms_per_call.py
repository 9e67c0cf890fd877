"""Milliseconds a call from detect_video's entry until its loader has
started (the program's api.init span, MDRF performance ``init_s``: the
loader, the detector and the collector built, the placement probes), over
the window's untraced calls. None where the program records no such span."""

from benchmark.metrics._common import untraced


def read(run):
    calls = [c for c in untraced(run) if "init_s" in c.perf]
    if not calls:
        return None
    return 1000.0 * sum(float(c.perf["init_s"]) for c in calls) / len(calls)
