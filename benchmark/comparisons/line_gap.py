"""``line_gap``: the per-frame half of ``output_gap``, the widest gap of the
detector's outputs as the collector receives them (``judge.frames_gap``),
with the records left to another number. For a cell whose records a
later stage changes (the recheck), so that M3's lines stay judged as
exactly as ``output_gap`` judges them."""

from benchmark import judge


def compare(call, reference, entry) -> float:
    return judge.frames_gap(judge.frame_outputs(call.outputs),
                            judge.frame_outputs(reference[2]))
