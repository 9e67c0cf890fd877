"""The share of the traced call in which the card is idle (no kernel, copy
or fill: the complement of the union ``Trace.busy_s`` reads) and no thread
of the program is in a span of work, in percent. The program's spans come
from ``metdetpy_tpu_torch.profiling.SPAN_LOG`` (name, thread, start ns, end
ns, wait), on the clock of the trace's records. A span of work is one that
is no wait (``wait`` False) and holds no other span of its thread: a span
that holds others (``api.init``, ``loader.loop``, ``api.dispatch`` around
the step graph's parts) counts only through them, so its untimed moments
explain nothing. None where the program logs no span in the traced call."""

import importlib


def span_rows():
    """The program's span log, or None where it keeps none."""
    try:
        mod = importlib.import_module("metdetpy_tpu_torch.profiling")
    except ImportError:
        return None
    log = getattr(mod, "SPAN_LOG", None)
    return None if log is None else list(log)


def working(rows, w0: int, w1: int) -> list:
    """Sorted disjoint [start, end) intervals inside [w0, w1) in which some
    thread is in a span of work: a span with ``wait`` False that holds no
    other span of its thread (a thread's spans nest or follow each
    other)."""
    threads: dict = {}
    for _, th, t0, t1, wait in rows:
        threads.setdefault(th, []).append((t0, t1, bool(wait)))
    out = []
    for spans in threads.values():
        # outer before inner where two start together
        spans.sort(key=lambda s: (s[0], -s[1]))
        for i, (t0, t1, wait) in enumerate(spans):
            holds = i + 1 < len(spans) and spans[i + 1][0] < t1
            if wait or holds or t1 <= w0 or t0 >= w1:
                continue
            out.append((max(t0, w0), min(t1, w1)))
    merged: list = []
    for a, b in sorted(out):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def unattributed_ns(gaps, work) -> int:
    """The length of the gaps that no working interval covers."""
    total = 0
    for g0, g1 in gaps:
        covered = sum(max(0, min(g1, b) - max(g0, a)) for a, b in work)
        total += (g1 - g0) - covered
    return total


def read(run):
    tr = run.trace
    rows = span_rows()
    if tr is None or tr.window_s <= 0 or not tr.device or not rows:
        return None
    w0, w1 = tr.window_ns
    if not any(t1 > w0 and t0 < w1 for _, _, t0, t1, _ in rows):
        return None
    idle = unattributed_ns(tr.gaps(), working(rows, w0, w1))
    return 100.0 * idle / 1e9 / tr.window_s
