"""Raw input frames of every call of the window, over the window's seconds
(from its start to the end of its last call)."""


def read(run):
    return run.frames_total / run.window_s if run.window_s > 0 else None
