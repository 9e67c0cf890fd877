"""On the card: one short run of each cell through run.py, correct, with
the card's numbers (skips without a card: it decides inside the test)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from _cpu import DL, M3, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [M3, DL])
def test_a_short_run_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", cell_name, "--seed", "2147483999", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["device"]["platform"] == "gpu"
    from benchmark import cell
    want = {m["name"] for m in cell.metrics_of(cell.bench_file(), cell_name,
                                                False)}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
