"""Checkpoint / resume for long-running (live-mode) detection.

Counterpart of ``metdetpy_tpu/checkpoint.py`` with the same file format,
key for key, so a checkpoint written by either package resumes in the
other. It snapshots everything needed to resume a stream mid-run:

  - the detector's device carries (window / sub-ROI / dynamic-mask
    histories, EMA state, frame timer; ClassicDetector's last three
    frames; MLDetector's window-max history),
  - the collector's track state (every active/waiting MeteorSeries),
  - the exporter's output so far (SingleMDRecord list),
  - the merged-frame cursor.

Format: one .npz of arrays plus a ``__meta__`` JSON (``version``,
``merged_idx``, ``collector``). The arrays are ``gray_hist``, ``sub_hist``,
``dy_hist`` (uint8), ``timer`` (int64), ``ema_0`` ... ``ema_5`` (the
EmaState fields in order: cur_value float32, t int32, warmup_on bool,
cur_momentum, bi_threshold, bi_thr_float float32; 0-d arrays),
``classic_hist`` for a ClassicDetector and ``ml_hist`` for an MLDetector.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from .structs import SingleMDRecord, from_dict
from .track.series import MeteorSeries, PointList

CHECKPOINT_VERSION = 1
_EMA_DTYPES = (np.float32, np.int32, np.bool_, np.float32, np.float32,
               np.float32)


# ---------------------------------------------------------------------------
# Series (de)serialization
# ---------------------------------------------------------------------------


def series_state(ms: MeteorSeries) -> dict[str, Any]:
    return {
        "pts": ms.coord_list.pts.tolist(),
        "pts_frames": ms.coord_list.frame_num.tolist(),
        "centers": ms.center_list.pts.tolist(),
        "centers_frames": ms.center_list.frame_num.tolist(),
        "drct_list": list(ms.drct_list),
        "start_frame": int(ms.start_frame),
        "end_frame": int(ms.end_frame),
        "last_activate_frame": int(ms.last_activate_frame),
        "max_acti_frame": (None if np.isnan(ms.max_acti_frame)
                           else float(ms.max_acti_frame)),
        "max_acceptable_dist": (None if (isinstance(ms.max_acceptable_dist,
                                                    float)
                                         and np.isnan(ms.max_acceptable_dist))
                                else float(ms.max_acceptable_dist)),
        "count": int(ms.count),
        "cate_prob": (None if ms.cate_prob is None
                      else np.asarray(ms.cate_prob).tolist()),
        "fps": float(ms.fps),
        "runtime_length": int(ms.runtime_length),
        "range": [list(ms.range[0]), list(ms.range[1])],
    }


def series_from_state(state: dict[str, Any]) -> MeteorSeries:
    ms = MeteorSeries.__new__(MeteorSeries)
    ms.coord_list = PointList()
    ms.coord_list.pts = np.asarray(state["pts"], np.int32).reshape(-1, 2)
    ms.coord_list.frame_num = np.asarray(state["pts_frames"], np.int64)
    ms.center_list = PointList()
    ms.center_list.pts = np.asarray(state["centers"], np.int32).reshape(-1, 2)
    ms.center_list.frame_num = np.asarray(state["centers_frames"], np.int64)
    ms.drct_list = list(state["drct_list"])
    ms.start_frame = state["start_frame"]
    ms.end_frame = state["end_frame"]
    ms.last_activate_frame = state["last_activate_frame"]
    ms.max_acti_frame = (np.nan if state["max_acti_frame"] is None
                         else state["max_acti_frame"])
    ms.max_acceptable_dist = (np.nan
                              if state["max_acceptable_dist"] is None
                              else state["max_acceptable_dist"])
    ms.count = state["count"]
    ms.cate_prob = (None if state["cate_prob"] is None
                    else np.asarray(state["cate_prob"], np.float64))
    ms.fps = state["fps"]
    ms.runtime_length = state["runtime_length"]
    rng = state["range"]
    ms.range = (list(rng[0]), list(rng[1]))
    return ms


# ---------------------------------------------------------------------------
# Detector / collector state
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def detector_state(detector) -> dict[str, np.ndarray]:
    """The detector's device carries as host arrays (LineDetector window,
    EMA and dynamic-mask histories; MLDetector's rolling window-max
    history)."""
    if not hasattr(detector, "_gray_hist"):
        if hasattr(detector, "_hist"):  # MLDetector
            return {"ml_hist": _host(detector._hist)}
        return {}  # stateless detector: it re-warms after a resume
    out = {
        "gray_hist": _host(detector._gray_hist),
        "sub_hist": _host(detector._sub_hist),
        "dy_hist": _host(detector._dy_hist),
        "timer": np.asarray(detector.timer, np.int64),
    }
    for i, (v, dt) in enumerate(zip(detector._ema.tensors(), _EMA_DTYPES)):
        out[f"ema_{i}"] = np.asarray(_host(v), dt)
    if hasattr(detector, "_classic_hist"):
        out["classic_hist"] = _host(detector._classic_hist)
    return out


def restore_detector(detector, arrays: dict[str, np.ndarray]) -> None:
    """Load carries saved by either package into ``detector``."""
    from .detectors.m3det import load_state_numpy
    if "gray_hist" not in arrays:
        if "ml_hist" in arrays and hasattr(detector, "_hist"):
            hist = torch.from_numpy(np.array(arrays["ml_hist"], np.uint8))
            if tuple(hist.shape) != tuple(detector._hist.shape):
                raise ValueError(f"ml_hist shape {tuple(hist.shape)}, "
                                 f"expected {tuple(detector._hist.shape)}")
            detector._hist = hist.to(detector.device)
        return
    state = {k: arrays[k] for k in ("gray_hist", "sub_hist", "dy_hist",
                                    "timer")}
    state["ema"] = [arrays[f"ema_{i}"] for i in range(len(_EMA_DTYPES))]
    if "classic_hist" in arrays:
        state["classic_hist"] = arrays["classic_hist"]
    load_state_numpy(detector, state)


def collector_state(collector) -> dict[str, Any]:
    active = [series_state(ms) for ms in collector.active_meteor
              if ms is not collector._sentinel]
    waiting = [series_state(ms) for ms in collector.waiting_meteor]
    records = [rec.to_dict() for rec in collector.met_exporter.meteor_list]
    return {"active": active, "waiting": waiting, "records": records,
            "cur_frame": int(collector.cur_frame)}


def restore_collector(collector, state: dict[str, Any]) -> None:
    collector.active_meteor = (
        [series_from_state(s) for s in state["active"]]
        + [collector._sentinel])
    collector.waiting_meteor = [series_from_state(s)
                                for s in state["waiting"]]
    collector.met_exporter.meteor_list = [
        from_dict(SingleMDRecord, rec) for rec in state["records"]]
    collector.cur_frame = state["cur_frame"]


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, detector, collector,
                    merged_idx: int) -> None:
    arrays = detector_state(detector)
    meta = {
        "version": CHECKPOINT_VERSION,
        "merged_idx": int(merged_idx),
        "collector": collector_state(collector),
    }
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_checkpoint(path: str, detector, collector) -> int:
    """Restore detector + collector; returns the merged-frame cursor."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta["version"] != CHECKPOINT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']}, "
                             f"expected {CHECKPOINT_VERSION}")
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    restore_detector(detector, arrays)
    restore_collector(collector, meta["collector"])
    return int(meta["merged_idx"])
