"""The control: the reference put in the program's place in the nearest
precision below the configuration's comes out not correct, at a small size
on the CPU (``control.py`` reads it on the card at each cell's own size)."""

import pytest

from _cpu import DL, M3, MODEL_HW, SEED, SMALL


@pytest.mark.parametrize("cell_name", [M3, DL])
def test_the_control_is_not_correct(cell_name):
    from benchmark import cell, control
    r = control.readings(cell_name, SEED, "cpu", SMALL, program=False,
                         model_hw=MODEL_HW)
    limits = cell.cell_files(cell.bench_file(), cell_name)["spec"]["limits"]
    assert r["frames_with_lines"] >= 1
    assert any(r["control"][k] > v for k, v in limits.items())
