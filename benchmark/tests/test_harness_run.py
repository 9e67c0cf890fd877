"""A whole run on the CPU at a small size (``cell.Run`` without the check
for a card that ``cell.main`` makes), its result's line, the import guard,
and run.py without a card."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from _cpu import DL, M3, ROOT, small_run

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell_name, trace", [(M3, False), (M3, True),
                                              (DL, False), (DL, True)])
def test_last_line_has_the_result_keys(cell_name, trace, monkeypatch):
    from benchmark import cell
    run, out = small_run(cell_name, trace=trace)
    keys = list(out)
    assert keys[:5] == REQUIRED and keys[-1] == "checks"
    assert set(keys) == set(REQUIRED) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == len(run.calls) >= 1
    want = {m["name"] for m in cell.metrics_of(run.bench, cell_name, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        # every end-to-end metric of the cell but the card's peak, which
        # a CPU run has not; setup_s and another among them
        assert want - set(out["metrics"]) == {"device_peak_gib"}
        assert "setup_s" in want and len(want) >= 2
    else:
        assert ({"api.dispatch_ms_per_block", "collector.update_ms_per_block"}
                if cell_name == M3 else
                {"dldet.frames_per_s", "loader.merge_ms_per_block"}
                ) <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["checks"]) == set(run.spec["limits"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_guard_compares_whole_top_level_names(monkeypatch):
    from benchmark import guard
    assert "metdetpy_tpu" not in guard.loaded()
    import metdetpy_tpu_torch  # noqa: F401
    assert guard.loaded() == [] or "metdetpy_tpu_torch" not in guard.loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "metdetpy_tpu.api",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib", None)  # blocked, not loaded
    assert guard.loaded() == ["jax", "metdetpy_tpu"]


def test_run_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    with pytest.raises(ImportError, match="flax"):
        small_run(M3)


def _run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "benchmark", "run.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_run_py_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT, "--workload", M3, "--seed", "1", "--seconds", "1",
                  "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    out = _run_py(ROOT, "--workload", "no_such_cell", "--seed", "1",
                  "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_alone_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ has no program."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(str(tmp_path), "--workload", M3, "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
