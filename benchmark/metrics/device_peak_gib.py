"""The peak of device memory in live tensors on the run's card over the
warm-up and the window (``torch.cuda.max_memory_allocated``: the step
graph's capture included), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
