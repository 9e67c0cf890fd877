"""Milliseconds a block of the host's call of the M3 step's CUDA graph
(the program's step_graph.frames_copy, step_graph.replay and
step_graph.out_clone spans, MDRF performance ``step_graph_<part>_s``: the
block's copy into the graph's buffer, the replay's launch and the outputs'
clones, not the graph's device time), over the window's untraced calls.
A wait of the dispatch behind the loader's upload lands on the copy or on
the replay, whichever meets it; the three together hold it either way.
None where the program records no such span."""

from benchmark.metrics._common import untraced

KEYS = ("step_graph_frames_copy_s", "step_graph_replay_s",
        "step_graph_out_clone_s")


def read(run):
    calls = untraced(run)
    blocks = sum(int(c.perf.get("dispatch_calls", 0)) for c in calls)
    if not blocks or not any(KEYS[1] in c.perf for c in calls):
        return None
    return 1000.0 * sum(float(c.perf.get(k, 0.0)) for c in calls
                        for k in KEYS) / blocks
