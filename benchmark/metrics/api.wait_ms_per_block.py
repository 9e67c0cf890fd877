"""Milliseconds a block of the main thread waiting for the loader's next block (detect_video's decode_wait span), over the window's untraced calls."""

from benchmark.metrics._common import per_block_ms


def read(run):
    return per_block_ms(run, "decode_wait_s")
