"""Milliseconds a block of the main thread's dispatch of a block (detect_video's dispatch span), over the window's untraced calls."""

from benchmark.metrics._common import per_block_ms


def read(run):
    return per_block_ms(run, "dispatch_s")
