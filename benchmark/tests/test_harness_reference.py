"""The plain reference against the port's ``detect_video`` on a small CPU
clip of each configuration (a test may import both; the reference imports
nothing of the port)."""

import os
import subprocess
import sys

import pytest

from _cpu import DL, M3, MODEL_HW, ROOT, SMALL


@pytest.mark.parametrize("cell_name", [M3, DL])
def test_reference_equals_the_port(cell_name):
    """The port's call and the plain reference over one small clip: their
    records and the collector's per-frame inputs."""
    from benchmark import cell, judge
    run = cell.Run(cell_name, 3, 0, False, "cpu", 0.0, traffic=SMALL,
                   model_hw=MODEL_HW)
    run._make_inputs()
    c = run._call()
    assert not c.error
    run.reference()
    assert run.ref_targets, "the small clip has a record to compare"
    assert run.ref_frames, "and per-frame outputs"
    if cell_name == M3:
        # the port's step on the CPU runs its plain ops: equal records and
        # lines
        assert judge.targets(c.records, run.entry.px_scale) == run.ref_targets
        assert run.gaps(c) == {"output_gap": 0.0}
        assert run.ref_stats["vote_points"] > 0
    else:
        # the port's body in bfloat16 against the reference's float32
        limits = run.spec["limits"]
        assert all(v <= limits[k] for k, v in run.gaps(c).items())


def test_reference_imports_nothing_of_the_port():
    code = f"""
import sys, json
sys.path.insert(0, {ROOT!r})
sys.modules["metdetpy_tpu_torch"] = None  # importing it would raise
from benchmark.traffic import sky
from benchmark import reference
from benchmark.entries import detect_video as dv
p = json.load(open({os.path.join(ROOT, 'benchmark', 'traffic', 'quiet_1080p_gray_60s.json')!r}))
p.update({SMALL!r}); p.update(seconds=3.0)
conf = json.load(open({os.path.join(ROOT, 'benchmark', 'configs', 'm3det_normal.json')!r}))
clip, = sky.make(p, 1, "cpu")
reference.detect(clip, dv.preset(conf, {ROOT!r}), "cpu", 25.0)
bad = sorted({{m.split(".")[0] for m, v in sys.modules.items() if v is not None}}
             & {{"metdetpy_tpu_torch", "metdetpy_tpu", "jax", "jaxlib", "flax"}})
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_reference_sources_import_no_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for dirpath, _, files in os.walk(ref):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    text = f.read()
                for banned in ("import metdetpy_tpu", "from metdetpy_tpu",
                               "import jax", "from jax"):
                    assert banned not in text, (fn, banned)
