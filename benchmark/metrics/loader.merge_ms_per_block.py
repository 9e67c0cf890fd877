"""Milliseconds a block of the loader's decode thread preparing blocks on
the host (the program's loader.merge and loader.preproc spans, MDRF
performance ``loader_merge_s`` plus ``loader_preproc_s``: the host
preprocess and the exposure's max-merge into the block), over the window's
untraced calls. None where the program records no such span."""

from benchmark.metrics._common import untraced

KEYS = ("loader_merge_s", "loader_preproc_s")


def read(run):
    calls = untraced(run)
    blocks = sum(int(c.perf.get("dispatch_calls", 0)) for c in calls)
    if not blocks or not any(KEYS[0] in c.perf for c in calls):
        return None
    return 1000.0 * sum(float(c.perf.get(k, 0.0)) for c in calls
                        for k in KEYS) / blocks
