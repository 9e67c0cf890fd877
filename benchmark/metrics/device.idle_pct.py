"""The share of the traced call in which the card runs no kernel, copy or
fill (the union of their intervals in the trace), in percent."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
