"""What the harness's CPU tests share: the cells at a size the CPU runs in
seconds (the traffic's own parameters but for the frame size and length;
YOLOv5s at 96x96 for both sides of a dldet comparison)."""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {"width": 320, "height": 180, "seconds": 6.0,
         "meteor_start_s": [2.0, 3.0], "meteor_length_frac": [0.2, 0.25],
         "meteor_brightness": [230.0, 240.0]}
M3, DL = "m3_1080p_quiet", "dldet_1080p_quiet"
SEED = 3
MODEL_HW = "96x96"


def small_run(cell_name: str, seed: int = SEED, trace: bool = False):
    """A CPU run of the cell at the small size: one call in the window."""
    from benchmark import cell
    run = cell.Run(cell_name, seed, 0, trace, "cpu", time.time(),
                   traffic=SMALL, model_hw=MODEL_HW)
    return run, run.execute()


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)
