"""Milliseconds a block of the loader's decode thread max-merging colour
frames into the recheck's stacks (the program's loader.color_stack span,
inside loader.merge; MDRF performance ``loader_color_stack_s``), over the
window's untraced calls. None where the program records no such span."""

from benchmark.metrics._common import per_block_ms


def read(run):
    return per_block_ms(run, "loader_color_stack_s")
