"""Milliseconds a block of the loader's uploader thread from the pageable copy through the device preprocess to its event (BlockVideoLoader's h2d_s), over the window's untraced calls."""

from benchmark.metrics._common import per_block_ms


def read(run):
    return per_block_ms(run, "loader_h2d_s")
