"""PyTorch port end to end on the CPU: ``detect_video`` against the JAX
package, the CLI, failure recovery, and the port's independence from JAX.

The port's MDRF on the synthetic clip of ``tests/test_e2e_detect.py`` must
equal the JAX package's: same records, categories, frames and points.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video, write_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import api as tapi
from metdetpy_tpu_torch.__main__ import main as cli_main
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.detectors.m3det import M3Detector
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg
from metdetpy_tpu_torch.utils import set_resource_dir

# the tensors here are small: two threads run them fastest and leave the
# host's other cores to the other test workers
torch.set_num_threads(2)

W, H, FPS = 256, 144, 25.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth_frames():
    meteor = SynthMeteor(start_sec=2.4, end_sec=4.4,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    return generate_meteor_video(width=W, height=H, fps=FPS,
                                 duration_sec=6.5, meteors=[meteor],
                                 n_stars=40, noise_sigma=3.0)


def _cfg(cls):
    cfg = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    return cfg


def _meteors(mdrf):
    return [t for rec in mdrf.results for t in rec.target
            if t.category == "METEOR"]


def test_mdrf_matches_jax(synth_frames, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    want = jax_detect_video(synth_frames, None, _cfg(MainDetectCfg),
                            work_mode="backend")
    got = detect_video(synth_frames, None, _cfg(TMainDetectCfg),
                       work_mode="backend", device="cpu")
    assert _meteors(want)
    assert ([r.to_dict() for r in got.results]
            == [r.to_dict() for r in want.results])


def test_device_failure_recovery(synth_frames, monkeypatch):
    """A fault while collecting the first block resets the detector's
    device state once; the meteor in a later block is still found."""
    monkeypatch.setattr(tapi, "_collect_deferred", lambda *a: False)
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    orig_collect = M3Detector.collect
    orig_reset = M3Detector.reset_device_state
    state = {"calls": 0, "resets": 0}

    def flaky_collect(self, handle):
        state["calls"] += 1
        if state["calls"] == 1:
            raise RuntimeError("injected device fault")
        return orig_collect(self, handle)

    def counting_reset(self):
        state["resets"] += 1
        return orig_reset(self)

    monkeypatch.setattr(M3Detector, "collect", flaky_collect)
    monkeypatch.setattr(M3Detector, "reset_device_state", counting_reset)
    mdrf = detect_video(synth_frames, None, _cfg(TMainDetectCfg),
                        work_mode="backend", device="cpu")
    assert state["resets"] == 1
    assert _meteors(mdrf), "meteor lost after recovered fault"


def test_unported_options_raise(synth_frames, video_file, tmp_path):
    """What used to be refused now runs: the time-sharded mode of the CLI
    (``--temporal-shards 2 --device cpu``: two shards on the CPU) and a
    batch pipeline sharded over a mesh; only a resume without a checkpoint
    file is still refused. Checkpoint/resume is ported
    (tests/test_torch_port_checkpoint.py), the video writers too
    (tests/test_torch_port_videowriter.py), the parallel modules in
    tests/test_torch_port_{parallel,temporal,parallel_dldet}.py."""
    from metdetpy_tpu_torch.models.pipeline import BatchPipeline
    from metdetpy_tpu_torch.parallel.mesh import shared_mesh
    with pytest.raises(ValueError, match="checkpoint_path"):
        detect_video(synth_frames, None, _cfg(TMainDetectCfg), resume=True,
                     device="cpu")
    out = tmp_path / "temporal.json"
    cli_main([video_file, "--temporal-shards", "2", "--device", "cpu",
              "--mode", "backend", "--exp-time", "real-time", "--recheck",
              "off", "--save-path", str(out)])
    mdrf = json.loads(out.read_text())
    assert mdrf["type"] == "prediction" and mdrf["basic_info"]["video"] \
        == video_file

    class Model:
        nms = False

        def forward_batch(self, imgs):
            return [([], [])] * len(imgs)

    pipe = BatchPipeline(Model(), inflight=0, sharding=shared_mesh(2, "cpu"))
    assert pipe.submit(["a", "b", "c"], np.zeros((3, 8, 8, 3), np.uint8)) \
        == [("a", ([], [])), ("b", ([], [])), ("c", ([], []))]


@pytest.fixture(scope="module")
def video_file(synth_frames, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "synth.avi")
    write_video(synth_frames[50:100], path, fps=FPS)
    return path


def test_cli_refuses_recheck_on(video_file, capsys, monkeypatch, tmp_path):
    """The default preset switches the recheck on. The CLI used to stop
    there; now it runs the preset as shipped, and what it refuses is a
    recheck it cannot do: a weight file that does not exist ends the run
    with an error instead of switching the recheck off."""
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    out = str(tmp_path / "out.json")
    cli_main([video_file, "--device", "cpu", "--mode", "backend",
              "--save-path", out])
    with open(out, encoding="utf-8") as f:
        assert json.load(f)["config"]["collector"]["recheck_cfg"]["switch"]
    empty = tmp_path / "resources"
    for sub in ("config", "global"):
        shutil.copytree(os.path.join(REPO, sub), empty / sub)
    try:
        with pytest.raises(FileNotFoundError, match="yolov5s_v5.flax.npz"):
            cli_main([video_file, "--device", "cpu", "--mode", "backend",
                      "--resource-dir", str(empty)])
    finally:
        set_resource_dir(None)


def test_cli_writes_mdrf(video_file, tmp_path, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    out = str(tmp_path / "out.json")
    cli_main([video_file, "--recheck", "off", "--device", "cpu",
              "--mode", "backend", "--exp-time", "real-time",
              "--resize", "256", "--save-path", out])
    with open(out, encoding="utf-8") as f:
        mdrf = json.load(f)
    assert mdrf["type"] == "prediction"
    assert mdrf["basic_info"]["resolution"] == [W, H]
    assert isinstance(mdrf["results"], list)


def test_port_imports_no_jax_and_no_jax_package():
    """Importing every module of the port (``dryrun.py`` named first, the
    counterpart of ``__graft_entry__.py``) and chip_smoke loads no jax
    module and nothing of the JAX package (``metdetpy_tpu`` or
    ``metdetpy_tpu.*``; ``metdetpy_tpu_torch`` shares the prefix)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import metdetpy_tpu_torch, metdetpy_tpu_torch.api, chip_smoke\n"
        "import metdetpy_tpu_torch.dryrun\n"
        "for m in pkgutil.walk_packages(metdetpy_tpu_torch.__path__,\n"
        "                               'metdetpy_tpu_torch.'):\n"
        "    if not m.name.endswith('.libmetring'):  # the built C library\n"
        "        importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "             or m == 'metdetpy_tpu'\n"
        "             or m.startswith('metdetpy_tpu.'))\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_without_card():
    """chip_smoke.py exits non-zero and prints no result without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
