"""Milliseconds a block of the loader's decode thread staging an in-memory
feed's frames from the caller's array into its pinned ring (the program's
loader.stage span, MDRF performance ``loader_stage_s``), over the window's
untraced calls. None where the program records no such span."""

from benchmark.metrics._common import per_block_ms


def read(run):
    return per_block_ms(run, "loader_stage_s")
