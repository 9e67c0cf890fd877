"""Frozen builds of the PyTorch port on the CPU.

``make_package_zipapp.py --package metdetpy_tpu_torch`` freezes the port's
six entry points into ``.pyz`` archives and ``make_package.py --package
metdetpy_tpu_torch`` into a directory bundle with launchers. Both hold the
port's package and the data trees, nothing of the JAX package and no
build output; run from either with a fresh ``HOME``, the main entry gives
the MDRF of an in-process ``detect_video`` on the same file, with every
import of JAX or of the JAX package failing.
"""

import json
import os
import subprocess
import sys
import zipfile

import pytest
import torch

from metdetpy_tpu_torch import utils
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.structs import MainDetectCfg
from metdetpy_tpu_torch.synth import (SynthMeteor, generate_meteor_video,
                                      write_video)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "metdetpy_tpu_torch"
TOOLS = {"MetDetPy": PORT, "MetDetPhoto": f"{PORT}.photo",
         "ClipToolkit": f"{PORT}.clip", "evaluate": f"{PORT}.evaluate",
         "train": f"{PORT}.train", "bench": f"{PORT}.bench"}
W, H, FPS = 256, 144, 25.0
# the recheck runs as shipped, at a small model input
ENV = {"METDETPY_TPU_YOLO_HW": "96x96"}
CLI_ARGS = ["--mode", "backend", "--exp-time", "real-time"]
# a run from an archive with every import of JAX or the JAX package failing
JAX_BLOCKED = ("import runpy, sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['metdetpy_tpu'] = None\n"
               "sys.argv = sys.argv[1:]\n"
               "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _env(home, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "METDET_RESOURCE_DIR",
                        "METDETPY_TPU_TRACE_DIR")}
    return {**env, **ENV, "HOME": str(home), **extra}


@pytest.fixture(scope="module")
def pyz_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("pyz")
    res = subprocess.run(
        [sys.executable, "make_package_zipapp.py", "--package", PORT,
         "--out", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(os.listdir(out)) == sorted(f"{t}.pyz" for t in TOOLS)
    return out


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    meteor = SynthMeteor(start_sec=0.8, end_sec=2.2,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    frames = generate_meteor_video(width=W, height=H, fps=FPS,
                                   duration_sec=3.0, meteors=[meteor],
                                   n_stars=40, noise_sigma=3.0)
    path = str(tmp_path_factory.mktemp("package_clip") / "clip.avi")
    write_video(frames, path, fps=FPS)
    return path


@pytest.fixture(scope="module")
def expected(clip):
    """``results`` of an in-process detect_video, configured as the main
    entry configures it from CLI_ARGS."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.delenv("METDETPY_TPU_TRACE_DIR", raising=False)
        mp.setattr(utils, "_resource_dir_override", None)
        cfg = MainDetectCfg.from_json_file(
            os.path.join(REPO, "config", "m3det_normal.json"))
        cfg.loader.exp_time = "real-time"
        mdrf = detect_video(clip, None, cfg, work_mode="backend",
                            device="cpu")
    results = mdrf.to_dict()["results"]
    assert results, "the clip's meteor gives no record"
    return results


def _saved_results(path) -> list:
    with open(path, encoding="utf-8") as f:
        return json.load(f)["results"]


@pytest.mark.parametrize("tool", list(TOOLS))
def test_port_pyz_help(pyz_dir, tool, tmp_path):
    res = subprocess.run([sys.executable, str(pyz_dir / f"{tool}.pyz"),
                          "--help"], cwd=tmp_path, env=_env(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"python -m {TOOLS[tool]}" in res.stdout


@pytest.mark.parametrize("tool", list(TOOLS))
def test_port_pyz_holds_no_jax_package_and_no_build(pyz_dir, tool):
    with zipfile.ZipFile(pyz_dir / f"{tool}.pyz") as z:
        names = z.namelist()
    assert {n.split("/", 1)[0] for n in names} == {
        "__main__.py", PORT, "config", "global", "resource", "weights"}
    assert not [n for n in names if n.endswith((".so", ".o", ".pyc"))
                or "/csrc/build/" in n or "__pycache__" in n]
    for src in ("window_diff.cu", "median_binarize_close.cu",
                "hough_vote.cu", "walk_pick.cu", "peak_ladder.cu",
                "walk_segments.cu", "cp_async.cuh"):
        assert f"{PORT}/csrc/{src}" in names


def test_frozen_main_entry_equals_detect_video(pyz_dir, clip, expected,
                                               tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", JAX_BLOCKED, str(pyz_dir / "MetDetPy.pyz"),
         clip, *CLI_ARGS, "--device", "cpu", "--save-path", "out.json"],
        cwd=tmp_path, env=_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert _saved_results(tmp_path / "out.json") == expected
    # the package and data trees were extracted into the fresh cache
    cache = tmp_path / ".cache" / PORT
    (bundle,) = os.listdir(cache)
    assert bundle.startswith("bundle-")
    assert (cache / bundle / PORT / "csrc" / "window_diff.cu").is_file()
    assert (cache / bundle / "weights" / "yolov5s_v5.flax.npz").is_file()


def test_frozen_bench_prints_one_json_line(pyz_dir, tmp_path):
    """The frozen bench with JAX and the JAX package blocked: the link
    probe's one JSON line on the CPU."""
    res = subprocess.run(
        [sys.executable, "-c", JAX_BLOCKED, str(pyz_dir / "bench.pyz"),
         "--device", "cpu"], cwd=tmp_path,
        env=_env(tmp_path, BENCH_MODE="probe"), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    (line,) = res.stdout.splitlines()
    record = json.loads(line)
    assert record["metric"] == "link_probe"
    assert record["device"] == "cpu"


def test_bundle_launcher_equals_detect_video(clip, expected, tmp_path):
    bundle = tmp_path / "bundle"
    res = subprocess.run(
        [sys.executable, "make_package.py", "--package", PORT, "--out",
         str(bundle)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert not (bundle / "metdetpy_tpu").exists()
    built = [os.path.join(d, f) for d, _, fs in os.walk(bundle) for f in fs
             if f.endswith((".so", ".o", ".pyc"))]
    assert not built and not (bundle / PORT / "csrc" / "build").exists()
    for tool in TOOLS:
        assert os.access(bundle / tool, os.X_OK)
    # modules that fail to import, after the bundle on the launcher's path
    blocked = tmp_path / "blocked"
    blocked.mkdir()
    for mod in ("jax", "metdetpy_tpu"):
        (blocked / f"{mod}.py").write_text(
            f"raise ImportError('{mod} is blocked')\n")
    run = subprocess.run(
        [str(bundle / "MetDetPy"), clip, *CLI_ARGS, "--device", "cpu",
         "--save-path", "out.json"], cwd=tmp_path,
        env=_env(tmp_path, PYTHONPATH=str(blocked)), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert _saved_results(tmp_path / "out.json") == expected


def test_frozen_tool_without_card_exits_with_resolve_device_message(
        pyz_dir, clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    res = subprocess.run(
        [sys.executable, str(pyz_dir / "MetDetPy.pyz"), clip, *CLI_ARGS,
         "--save-path", "out.json"], cwd=tmp_path, env=_env(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert not (tmp_path / "out.json").exists()


@pytest.mark.parametrize("sub", ["csrc", "native"])
def test_read_only_package_builds_into_user_cache(sub, tmp_path,
                                                  monkeypatch):
    src = os.path.join(REPO, PORT, sub)
    assert utils.build_root(src) == src
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(utils.os, "access", lambda p, mode: False)
    assert utils.build_root(src) == str(tmp_path / ".cache" / PORT / sub)
