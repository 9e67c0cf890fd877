"""walk_pick's share of its roofline in the traced call, in percent: its
launches' least time (bytes and operations at the main path's launch
shapes, work/kernels.py) over their device time in the trace."""

from benchmark.metrics._common import kernel_roofline


def read(run):
    return kernel_roofline(run, "walk_pick")
