"""GiB of the CUDA graph pools the run's M3 step captures took
(``metdetpy_tpu_torch.detectors.step_graph.CAPTURES``' ``pool_bytes``)."""


def read(run):
    from metdetpy_tpu_torch.detectors import step_graph
    caps = list(step_graph.CAPTURES)
    if not caps:
        return None
    return sum(int(c.get("pool_bytes", 0)) for c in caps) / 2**30
