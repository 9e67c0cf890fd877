"""Milliseconds a block of the collector's updates (detect_video's collector_update span), over the window's untraced calls."""

from benchmark.metrics._common import per_block_ms


def read(run):
    return per_block_ms(run, "collector_update_s")
