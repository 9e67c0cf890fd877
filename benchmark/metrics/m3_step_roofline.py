"""The M3 step's share of the chip's peak over the window's untraced calls,
in percent: the least time of their work (``work/m3_step.py``: frames and
carries read once, outputs written once, the Hough vote of the points the
reference binarized) over their seconds. It reckons the work from shapes
and counts, never from the program's kernels."""

from benchmark.metrics._common import untraced
from benchmark.work import m3_step


def read(run):
    calls = untraced(run)
    points = run.ref_stats.get("vote_points")
    seconds = sum(c.seconds for c in calls)
    if not calls or not points or seconds <= 0:
        return None
    h, w = run.entry.hw
    least = m3_step.least_seconds_clip(h, w, run.entry.merged_frames,
                                       run.entry.window, points)
    return 100.0 * len(calls) * least / seconds
