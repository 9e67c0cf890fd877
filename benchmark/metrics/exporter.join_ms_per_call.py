"""Milliseconds a call that detect_video waits at its end for the
exporter's thread (the program's api.exporter_join span, MDRF performance
``exporter_join_s``: the recheck work left when the loop ends), over the
window's untraced calls. None where the program records no such span."""

from benchmark.metrics._common import untraced


def read(run):
    calls = [c for c in untraced(run) if "exporter_join_s" in c.perf]
    if not calls:
        return None
    return 1000.0 * sum(float(c.perf["exporter_join_s"])
                        for c in calls) / len(calls)
