"""Raw input frames of the recheck cell's untraced calls over their
seconds, as ``dldet.frames_per_s`` reads them: the cell's pace is the host's
colour path and the exporter's recheck, whose speed wanders from run to
run too widely to hold ``frames_per_s`` end to end. None without such
calls."""

from benchmark.cell import metric_module


def read(run):
    return metric_module("dldet.frames_per_s").read(run)
