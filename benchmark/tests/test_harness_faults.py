"""A run with the timed path broken underneath comes out not correct: the
harness drives the rest of a run on the CPU at a small size with each fault
that a cell can have planted in the program. The exchange between chips
has no place in a one-chip cell; dldet's window-max history never reaches
a second block in a 20 s clip (one block a call), so a state left
unchanged has nothing to change there."""

import numpy as np
import pytest

from _cpu import DL, M3, small_run


def _m3_answer_altered(monkeypatch):
    from metdetpy_tpu_torch.detectors import m3det
    orig = m3det.M3Detector._classify_lines

    def shifted(self, frame_lines):
        lines, cates = orig(self, frame_lines)
        return np.asarray(lines) + 10, cates
    monkeypatch.setattr(m3det.M3Detector, "_classify_lines", shifted)


def _m3_state_unchanged(monkeypatch):
    from metdetpy_tpu_torch.detectors import m3det
    orig = m3det._m3_block_step

    def frozen_state(gray, sub, dy, ema, block, timer, **kw):
        packed, dst, *_ = orig(gray, sub, dy, ema, block, timer, **kw)
        return packed, dst, gray, sub, dy, ema, timer
    monkeypatch.setattr(m3det, "_m3_block_step", frozen_state)


def _half_batch(cls):
    def plant(monkeypatch):
        orig = cls.collect_many

        def half(self, handles):
            out = orig(self, handles)
            empty = (np.zeros((0, 4), int), np.zeros((0, self.num_cls)))
            return [[r if t % 2 == 0 else empty for t, r in enumerate(blk)]
                    for blk in out]
        monkeypatch.setattr(cls, "collect_many", half)
    return plant


def _m3_half_batch(monkeypatch):
    from metdetpy_tpu_torch.detectors import m3det
    _half_batch(m3det.M3Detector)(monkeypatch)


def _dl_half_batch(monkeypatch):
    from metdetpy_tpu_torch.detectors import mldet
    _half_batch(mldet.MLDetector)(monkeypatch)


def _dl_answer_altered(monkeypatch):
    from metdetpy_tpu_torch.detectors import mldet
    orig = mldet.MLDetector._orient_results

    def shifted(self, *args, **kwargs):
        return [(np.asarray(pos) + 10, cls)
                for pos, cls in orig(self, *args, **kwargs)]
    monkeypatch.setattr(mldet.MLDetector, "_orient_results", shifted)


@pytest.mark.parametrize("cell_name, plant", [
    (M3, _m3_answer_altered), (M3, _m3_state_unchanged), (M3, _m3_half_batch),
    (DL, _dl_answer_altered), (DL, _dl_half_batch)])
def test_a_fault_makes_the_run_not_correct(cell_name, plant, monkeypatch):
    plant(monkeypatch)
    _, out = small_run(cell_name)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_recheck_answer_altered_makes_a_draft_recheck_cell_not_correct(
        tmp_path, monkeypatch):
    """The recheck's model answers with its classes rolled by one (each
    box's largest probability put under another class): ``recheck_gap``
    of a draft recheck cell reads the flipped categories."""
    import time
    from _cpu import DRAFT_SMALL, MODEL_HW, SEED, draft
    from benchmark import cell
    from metdetpy_tpu_torch.models import yolo
    orig = yolo.YOLOModel.forward

    def rolled(self, x):
        pos, cls = orig(self, x)
        return pos, np.roll(cls, 1, axis=1)
    monkeypatch.setattr(yolo.YOLOModel, "forward", rolled)
    name, b = draft(str(tmp_path))
    out = cell.Run(name, SEED, 0, False, "cpu", time.time(), bench=b,
                   traffic=DRAFT_SMALL, model_hw=MODEL_HW).execute()
    assert out["correct"] is False
    assert out["checks"]["recheck_gap"]["value"] > out["checks"][
        "recheck_gap"]["limit"]
