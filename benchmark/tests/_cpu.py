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


# a draft cell of the shipped m3det_normal with its recheck on, on the busy
# mix: its configuration and workload file are written outside the
# checkout, and named by their paths
DRAFT_MIX = "busy_1080p_color_30s"
DRAFT_SMALL = dict(SMALL, seconds=6.0, meteor_start_s=[1.0, 4.0],
                   plane_seconds=[3.0, 5.0])
DRAFT_LIMITS = {"line_gap": 5.0, "recheck_gap": 2.0}


def draft(draft_dir) -> tuple[str, dict]:
    """(the draft cell's name, BENCHMARK.json with the cell and its
    configuration added). The configuration and the workload file are
    written under ``draft_dir``; the cell's name is its workload file's
    path less ``.json``, which ``cell.cell_files`` joins to nothing."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "m3det_normal.json"), encoding="utf-8") as f:
        conf = json.load(f)
    conf["collector"]["recheck_cfg"]["switch"] = True
    conf["reduced"] = ["loader"]
    del conf["assumed"]["collector.recheck_cfg.switch"]
    conf_file = os.path.join(draft_dir, "m3det_normal_recheck.json")
    with open(conf_file, "w", encoding="utf-8") as f:
        json.dump(conf, f)
    name = os.path.join(draft_dir, "m3_1080p_recheck_draft")
    with open(name + ".json", "w", encoding="utf-8") as f:
        json.dump({"entry": "detect_video", "control": "int8",
                   "limits": DRAFT_LIMITS}, f)
    b = bench()
    b["configs"].append({"name": "m3det_normal_recheck",
                         "source": conf["source"], "file": conf_file,
                         "reduced": ["loader"], "why": "the recheck on"})
    b["workloads"].append({"name": name, "config": "m3det_normal_recheck",
                           "traffic": DRAFT_MIX, "chips": 1,
                           "why": "a draft"})
    return name, b
