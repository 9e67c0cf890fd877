"""BENCHMARK.json keeps to its format and limits, and every workload,
configuration, traffic mix, generator, entry and metric it names is a file
of its own that the harness finds by name."""

import importlib
import json
import os
import re

import pytest

from _cpu import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    assert isinstance(s, str) and 1 <= len(s) <= 200
    assert "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    full = 2 + 14 * 24
    assert full * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        _line(c["source"]), _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # every changed key is explained, and lies in a group named reduced
        assert {k.split(".")[0] for k in conf["assumed"]} <= set(c["reduced"])


def test_workloads_found_by_name():
    from benchmark import cell, judge, reference
    b = bench()
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        _line(w["why"])
        files = cell.cell_files(b, w["name"])
        gen = files["traffic"]["generator"]
        assert hasattr(importlib.import_module("benchmark.traffic." + gen),
                       "make")
        spec = files["spec"]
        entry = importlib.import_module("benchmark.entries." + spec["entry"])
        assert hasattr(entry, "Entry")
        assert spec["control"] in reference.CONTROLS
        for number in spec["limits"]:
            # a built-in comparison, or one found by name
            assert number in judge.BUILT_IN or callable(
                judge.comparison(number))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(names) // 4)


def test_metrics_found_by_name():
    from benchmark import cell
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(cell.metric_module(m["name"]).read)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for c in cells:
        assert len(cell.metrics_of(b, c, False)) >= 2
        assert cell.metrics_of(b, c, True)


def test_each_metric_moves_one_that_its_cells_report():
    """A per-layer metric's ``moves`` is an end-to-end metric of every cell
    that the per-layer metric lists."""
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]
    for m in b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("name", ["m3_1080p_quiet", "dldet_1080p_quiet"])
def test_unknown_names_raise(name):
    from benchmark import cell
    with pytest.raises(KeyError):
        cell.cell_files(bench(), name + "_absent")
