"""Seconds from the process's start to the window's start: imports, the
CUDA context, the inputs made from the seed, the first build of the
kernels where the checkout has none, and the warm-up call."""


def read(run):
    return run.setup_s
