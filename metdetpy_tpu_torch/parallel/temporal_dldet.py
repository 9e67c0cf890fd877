"""Time-sharded dldet batch detection: the MLDetector pipeline with the
clip's time axis sharded over the device mesh.

Counterpart of ``metdetpy_tpu/parallel/temporal_dldet.py``. Per shard:
the rolling colour window-max over its frames with an (n-1)-frame halo
from its left neighbour (shard 0's halo is zeros, exactly MLDetector's
initial history, or the previous super-block's tail), then the YOLO
forward on the stacks (the shards of a device as one batch, one model
replica per device). On the host the per-frame candidates feed the same
MeteorCollector cadence as the block loop, so the results equal the
sequential path's.

The streaming variant carries the last shard's (n-1)-frame tail to shard
0 between super-blocks, bounding host memory by one super-block.

The reference MLDetector is strictly sequential, one onnxruntime call per
stacked window under a global lock (MetLib/Detector.py:522-573,
model.py:142-166); time sharding has no analog there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..detectors.mldet import _window_max_color
from .dataparallel import model_replica
from .mesh import DeviceMesh, build_mesh, canonical
from .temporal import _halo_from_left, _runtime, _shard, _tail_to_first


def temporal_window_max_color(frames, n: int, mesh: DeviceMesh,
                              axis_name: str = "time", carry=None):
    """Sharded rolling window-max over [T, H, W, 3] uint8 frames (numpy or
    a tensor; T must divide by the mesh size). ``carry`` is the previous
    super-block's [n-1, H, W, 3] tail, or None at stream start. Returns
    (the stacks of each device group, [S_g * T/S, H, W, 3] on its device;
    the next carry)."""
    s = mesh.size
    if frames.shape[0] % s:
        raise ValueError(f"T={frames.shape[0]} must divide over the {s} "
                         "shards")
    t_local = frames.shape[0] // s
    local = _shard(frames, mesh, t_local)
    if n > 1 and t_local < n - 1:
        raise ValueError(
            f"each time shard must hold at least the window halo "
            f"(n-1={n - 1} frames); got {frames.shape[0]}/{s} per shard -- "
            f"use fewer shards or longer super-blocks")
    with torch.inference_mode():
        if n > 1:
            stacks = [_window_max_color(halo, loc, n)[0] for loc, halo in
                      zip(local, _halo_from_left(local, n, carry))]
            carry = _tail_to_first(local, n, canonical(mesh.devices[0]))
        else:
            stacks = local
        return [x.reshape((-1,) + tuple(x.shape[2:])) for x in stacks], carry


def _feed_collector_dldet(collector, results, t_start: int, rt) -> None:
    """Mirror the block loop's collector cadence (api._run_block_loop
    consume): update on frames with candidates and on the eq-fps tick."""
    eq_int_fps = max(int(rt.eq_int_fps), 1)
    e = max(int(rt.exp_frame), 1)
    for j, (lines, cates) in enumerate(results):
        t = t_start + j
        if len(lines) or t % eq_int_fps == 0:
            collector.update(t * e, lines=lines, cates=cates)


def _make_detector(cfg, fps: float, mask: Optional[np.ndarray],
                   h: int, w: int, logger, mesh: DeviceMesh):
    from ..detectors.mldet import MLDetector
    from ..utils import get_num_class
    det_mask = (mask if mask is not None
                else np.ones((h, w, 3), np.uint8))
    return MLDetector(window_sec=cfg.detector.window_sec, fps=fps,
                      mask=det_mask, num_cls=get_num_class(),
                      cfg=cfg.detector.cfg, logger=logger,
                      device=mesh.devices[0])


def _replicas(det, mesh: DeviceMesh) -> list:
    """The detector's model on each device group's device."""
    return [model_replica(det.model, dev) for dev, _, _ in mesh.groups()]


def _detect_stacks(det, models: list, stacks: list) -> list:
    """The forward (``models``: one per device group) and the detector's
    box orientation on each device group's stacks; the frame results in
    order."""
    results: list = []
    for model, x in zip(models, stacks):
        results.extend(det._orient_results(x, model.forward_batch_device(x)))
    return results


def _pad_to_shards(frames: np.ndarray, n: int, s: int) -> np.ndarray:
    """Pad the time axis by repeating the last frame up to a multiple of
    the mesh size that also gives every shard its (n-1)-frame halo;
    windows look backwards, so padded rows never change real rows."""
    t_real = frames.shape[0]
    target = -(-max(t_real, (n - 1) * s, s) // s) * s
    if target > t_real:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], target - t_real, axis=0)])
    return frames


def _masked(frames: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    if mask is None:
        return frames
    return (frames * (mask if mask.ndim == 3 else mask[..., None])
            ).astype(np.uint8)


def detect_frames_temporal_dldet(frames: np.ndarray, cfg, fps: float,
                                 mask: Optional[np.ndarray] = None,
                                 mesh: Optional[DeviceMesh] = None,
                                 axis_name: str = "time", logger=None,
                                 rt_params=None, device: str = "cuda"):
    """Batch-detect a whole in-memory colour clip with MLDetector, time
    axis sharded over the mesh. frames: [T, H, W, 3] uint8 runtime-size;
    the time axis is padded (repeats of the last frame, results trimmed)
    up to a shardable length, so every real frame is processed, clips
    shorter than the mesh included.

    Returns (records, n_frames_used)."""
    from ..log import BaseMetLog
    from ..track.collector import MeteorCollector

    logger = logger or BaseMetLog()
    mesh = mesh if mesh is not None else build_mesh(axis_name=axis_name,
                                                    device=device)
    t_real = frames.shape[0]
    if t_real == 0:
        raise ValueError("no frames decoded")
    h, w = frames.shape[1:3]
    frames = _masked(frames, mask)
    det = _make_detector(cfg, fps, mask, h, w, logger, mesh)
    stacks, _ = temporal_window_max_color(
        _pad_to_shards(frames, det.n, mesh.size), det.n, mesh, axis_name)
    results = _detect_stacks(det, _replicas(det, mesh), stacks)[:t_real]

    rt = _runtime(fps, h, w, rt_params)
    collector = MeteorCollector(cfg.collector, rt, video_loader=None,
                                logger=logger, device=mesh.devices[0])
    _feed_collector_dldet(collector, results, 0, rt)
    collector.clear()
    return collector.met_exporter.meteor_list, t_real


def detect_frames_temporal_dldet_streaming(block_iter, cfg, fps: float,
                                           mask: Optional[np.ndarray]
                                           = None,
                                           mesh: Optional[DeviceMesh]
                                           = None,
                                           axis_name: str = "time",
                                           super_block_frames: int = 512,
                                           logger=None, rt_params=None,
                                           device: str = "cuda"):
    """Streaming complement: colour merged frames super-block by
    super-block with the (n-1)-frame window tail carried on the device
    between sharded steps. Equal to the whole-clip mode; host memory is
    bounded by one super-block. Returns (records, n_frames_used)."""
    from ..log import BaseMetLog
    from ..track.collector import MeteorCollector

    logger = logger or BaseMetLog()
    mesh = mesh if mesh is not None else build_mesh(axis_name=axis_name,
                                                    device=device)
    s = mesh.size
    n_win = max(int(cfg.detector.window_sec * fps), 1)
    # every middle super-block must give each shard the (n-1)-frame halo
    sb = max(super_block_frames // s, n_win - 1, 1) * s

    det = None
    models = None
    collector = None
    rt = None
    carry = None
    t_done = 0
    pending: list[np.ndarray] = []
    n_pending = 0

    def run_super_block(chunk: np.ndarray):
        nonlocal det, models, collector, rt, carry, t_done
        if det is None:
            h, w = chunk.shape[1:3]
            det = _make_detector(cfg, fps, mask, h, w, logger, mesh)
            models = _replicas(det, mesh)
            rt = _runtime(fps, h, w, rt_params)
            collector = MeteorCollector(cfg.collector, rt,
                                        video_loader=None, logger=logger,
                                        device=mesh.devices[0])
        n_real = chunk.shape[0]
        # the tail super-block is padded and its results trimmed, as the
        # whole-clip mode does
        stacks, carry = temporal_window_max_color(
            _pad_to_shards(_masked(chunk, mask), det.n, s), det.n, mesh,
            axis_name, carry=carry)
        results = _detect_stacks(det, models, stacks)[:n_real]
        _feed_collector_dldet(collector, results, t_done, rt)
        t_done += n_real

    for blk in block_iter:
        pending.append(np.asarray(blk))
        n_pending += pending[-1].shape[0]
        while n_pending >= sb:
            buf = np.concatenate(pending, axis=0)
            run_super_block(buf[:sb])
            rest = buf[sb:]
            pending = [rest] if rest.size else []
            n_pending = rest.shape[0] if rest.size else 0
    if n_pending:  # tail: padded + trimmed inside run_super_block
        run_super_block(np.concatenate(pending, axis=0))
    if collector is not None:
        collector.clear()
        return collector.met_exporter.meteor_list, t_done
    return [], 0
