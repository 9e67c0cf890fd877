"""Milliseconds a rechecked clip of the recheck's forward (the program's
recheck.forward span on the exporter thread, MDRF performance
``recheck_forward_s``: the clip's stack uploaded, its tiles through
YOLOv5s, the suppressions and the fetch) over its clips (counter
``recheck_clips``), over the window's untraced calls. None where the
program records no such span or forwarded no clip."""

from benchmark.metrics._common import untraced


def read(run):
    calls = [c for c in untraced(run) if "recheck_forward_s" in c.perf]
    clips = sum(int(c.perf.get("recheck_clips", 0)) for c in calls)
    if not clips:
        return None
    return 1000.0 * sum(float(c.perf["recheck_forward_s"])
                        for c in calls) / clips
