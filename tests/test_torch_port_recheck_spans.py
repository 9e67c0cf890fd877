"""PyTorch port: the recheck's spans and counters in a ``detect_video``
call, and its YOLOv5s forward against the benchmark's plain reference.

- A recheck-on call of the shipped ``m3det_normal`` on a small colour clip
  puts the exporter thread's spans (``exporter_recheck_s``,
  ``recheck_forward_s``), its counters (``recheck_clips``,
  ``recheck_tiles``), the api's ``exporter_join_s`` and the loader's
  ``loader_color_stack_s`` into MDRF ``performance``; ``recheck_tiles`` is
  the clips times the tiles of the reference's own plan of the clip's
  size. With the recheck off no clip is forwarded.
- ``YOLOModel.forward`` as the recheck runs it (``multiscale_pred`` 2,
  partition 2, a suppression per tile and one over all tiles) at 96x96 in
  float32, against ``benchmark/reference/dl.py``'s YOLO and
  ``reference/recheck.py``'s ``forward``, on seeded random weights (each
  shipped value times a seeded factor exp(0.1 N(0, 1)): a random network
  whose boxes still depend on the image). The decoded head outputs agree
  within rtol 2e-4 and atol 2e-4 x max|head| (float32 through some 60
  layers, each side summing in its own order, as in
  ``test_torch_port_yolo.py``); the boxes after the suppressions are equal,
  and their class probabilities within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

from benchmark.reference import dl
from benchmark.reference import recheck as ref_recheck
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.models import yolo as tyolo
from metdetpy_tpu_torch.models import yolov5 as tv5
from metdetpy_tpu_torch.structs import MainDetectCfg
from metdetpy_tpu_torch.utils import relative2abs_path

torch.set_num_threads(2)

W, H, FPS = 256, 144, 25.0
HW = 96
WEIGHTS = relative2abs_path("./weights/yolov5s_v5.flax.npz")


@pytest.fixture(scope="module")
def clip():
    meteor = SynthMeteor(start_sec=2.4, end_sec=4.4,
                         pt1=(int(W * 0.45), int(H * 0.25)),
                         pt2=(int(W * 0.30), int(H * 0.55)))
    return generate_meteor_video(width=W, height=H, fps=FPS,
                                 duration_sec=6.5, meteors=[meteor],
                                 n_stars=40, noise_sigma=3.0, color=True)


def _cfg(recheck: bool):
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = recheck
    return cfg


def _plan_count(h: int, w: int) -> int:
    _, levels = dl.plan_tiles(h, w, HW, HW, 2, 2)
    return sum(len(tiles) for tiles in levels)


def test_a_recheck_call_reports_its_spans_and_counters(clip, monkeypatch):
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", f"{HW}x{HW}")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    perf = detect_video(clip.copy(), None, _cfg(True), work_mode="backend",
                        device="cpu").performance
    assert perf["recheck_clips"] >= 1
    assert perf["recheck_forward_calls"] == perf["recheck_clips"]
    assert perf["recheck_tiles"] == perf["recheck_clips"] * _plan_count(H, W)
    assert perf["exporter_stack_calls"] == perf["recheck_clips"]
    assert perf["exporter_stack_bytes"] >= perf["recheck_clips"] * H * W * 3
    assert perf["exporter_join_calls"] == 1
    # every merged frame went into a colour stack
    assert perf["loader_color_stack_calls"] == len(clip)
    assert perf["loader_color_stack_bytes"] == clip.nbytes
    for key in ("exporter_recheck_s", "recheck_forward_s", "exporter_join_s",
                "loader_color_stack_s", "exporter_wait_s"):
        assert perf[key] >= 0.0
    # nested: the forwards and stacks inside the recheck, the colour stacks
    # inside the loader's merge
    assert perf["recheck_forward_s"] + perf["exporter_stack_s"] <= \
        perf["exporter_recheck_s"]
    assert perf["loader_color_stack_s"] <= perf["loader_merge_s"]


def test_a_call_with_the_recheck_off_forwards_no_clip(clip):
    perf = detect_video(clip[:60].copy(), None, _cfg(False),
                        work_mode="backend", device="cpu").performance
    assert "exporter_join_s" in perf and "exporter_wait_s" in perf
    for key in ("recheck_forward_s", "recheck_clips", "recheck_tiles",
                "exporter_recheck_s", "loader_color_stack_s"):
        assert key not in perf


def _random_weights(path, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with np.load(WEIGHTS) as d:
        out = {k: (d[k] * np.exp(0.1 * rng.normal(size=d[k].shape))
                   ).astype(np.float32) for k in d.files}
    np.savez(path, **out)


@pytest.mark.parametrize("seed", range(6))
def test_recheck_forward_equals_the_plain_reference(clip, tmp_path,
                                                    monkeypatch, seed):
    monkeypatch.setattr(tv5, "YOLOv5", functools.partial(
        tv5.YOLOv5, dtype=torch.float32))
    monkeypatch.setattr(tyolo, "_WEIGHT_CACHE", {})
    path = str(tmp_path / f"random_{seed}.npz")
    _random_weights(path, seed)
    port = tyolo.YOLOModel(
        weight_path=path, nms=True, warmup=False, pos_thre=0.25,
        nms_thre=0.45, multiscale_pred=2, multiscale_partition=2,
        input_hw=(HW, HW), device="cpu")
    ref = dl.YOLO({"weight_path": path, "input_hw": f"{HW}x{HW}",
                   "pos_thre": 0.25, "multiscale_pred": 2,
                   "multiscale_partition": 2}, port.nc, torch.device("cpu"))
    # a colour max-stack over the meteor, as the loader keeps it
    stack = clip[55:115].max(axis=0)

    # the decoded head outputs of two tiles
    crops = torch.from_numpy(np.stack([stack[:HW, :HW],
                                       stack[20:20 + HW, 50:50 + HW]]))
    with torch.inference_mode():
        got = tyolo._forward_decode(port.model, crops, hw=(HW, HW)).numpy()
    want = ref._forward(crops.to(torch.float32) / 255.0)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())

    # the boxes after the per-tile and the cross-tile suppressions
    pos, cls = port.forward(stack)
    rpos, rcls, _, _ = ref_recheck.forward(ref, torch.from_numpy(stack),
                                           0.45)
    assert port.last_tiles == _plan_count(H, W)
    assert len(rpos) >= 1
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_allclose(cls, rcls, rtol=0, atol=1e-5)
