"""Raw input frames of the window's untraced calls over their seconds: the
rate of a cell whose host-bound calls spread too widely from run to run to
hold ``frames_per_s`` end to end (the dldet cell: its pace is the host's
max-merge, and the host's speed wanders). None without such calls."""

from benchmark.metrics._common import untraced


def read(run):
    calls = untraced(run)
    seconds = sum(c.seconds for c in calls)
    if not calls or seconds <= 0:
        return None
    return sum(c.frames for c in calls) / seconds
