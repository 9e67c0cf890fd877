"""The recheck's plain reference against the port's ``detect_video`` with
the recheck on, over a small colour clip with the shipped weights and the
model input cut to ``MODEL_HW``, both sides in float32."""

import functools
import time

import torch

from _cpu import DRAFT_SMALL, MODEL_HW, SEED, draft


def _plain(targets):
    return sorted(({k: v for k, v in t.items() if k != "margins"}
                   for t in targets), key=lambda t: (t["start"], t["pts"]))


def test_recheck_reference_equals_the_port_in_float32(tmp_path,
                                                       monkeypatch):
    from benchmark import cell
    from benchmark.comparisons import recheck_gap
    from metdetpy_tpu_torch.models import yolo, yolov5
    # the port's YOLOv5s with a float32 body, built afresh
    monkeypatch.setattr(yolov5, "YOLOv5", functools.partial(
        yolov5.YOLOv5, dtype=torch.float32))
    monkeypatch.setattr(yolo, "_WEIGHT_CACHE", {})
    name, b = draft(str(tmp_path))
    run = cell.Run(name, SEED, 0, False, "cpu", time.time(), bench=b,
                   traffic=DRAFT_SMALL, model_hw=MODEL_HW)
    run._make_inputs()
    c = run._call()
    assert not c.error
    run.reference()
    got = recheck_gap.targets(c.records, run.entry.px_scale)
    want = recheck_gap.targets(run.ref[0], run.entry.px_scale)
    assert sum(t["recheck_score"] is not None for t in want) >= 2
    assert _plain(got) == _plain(want)
    assert run.gaps(c) == {"line_gap": 0.0, "recheck_gap": 0.0}
