"""Multi-stream detection: S camera feeds through one batched M3 step.

Counterpart of ``metdetpy_tpu/parallel/multistream.py`` (BASELINE.json
configuration 5, "8 concurrent camera feeds, vectorized Hough voting +
recheck"). The JAX package maps ``_m3_block_step`` over the streams with
``jax.vmap`` inside a ``shard_map``; here the streams of each device are a
leading axis of one ``_m3_block_step`` call: one window_diff and one
median_binarize_close launch per block and device for all its streams,
and S*T/8 launches of the Hough pair (8-frame chunks of all frames). The
window / EMA / dynamic-mask carries stay on the devices, one per stream;
the per-stream collectors stay on the host and read one copy of the
packed buffers per device.

The reference's only concurrency is intra-process threads
(SURVEY.md §2.4); this is its scale-out replacement.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..detectors.base import FrameResult
from ..detectors.m3det import (ABS_SENSITIVITY, NUM_LINES_TOOMUCH,
                               SENSITIVITY_COEF, EmaState, _m3_block_step,
                               _unpack, select_subarea)
from ..log import BaseMetLog
from ..structs import BinaryCfg
from ..utils import lineset_nms
from .mesh import DeviceMesh, build_mesh, split_leading


class MultiStreamM3Detector:
    """M3 detection over S independent streams that share a frame timer;
    the streams are split evenly over the mesh's shards (S must divide by
    its size), and the shards of one device run as one batched step."""

    def __init__(self, n_streams: int, window_sec: float, fps: float,
                 mask: np.ndarray, num_cls: int, cfg: BinaryCfg,
                 logger: BaseMetLog, mesh: Optional[DeviceMesh] = None,
                 max_points: int = 8192, max_peaks: int = 64,
                 device: str = "cuda") -> None:
        self.s = n_streams
        self.num_cls = num_cls
        self.logger = logger
        self.mask_area = int(np.sum(mask))
        self.n = max(int(window_sec * fps), 1)
        h, w = mask.shape[:2]
        self.hw = (h, w)
        self.max_points = max_points
        self.max_peaks = max_peaks
        bi = cfg.binary
        self.std_roi = select_subarea(mask, bi.area)
        momentum = 1 - bi.interval / 60
        adaptive = bool(bi.adaptive_bi_thre)
        coef_a, coef_b = (SENSITIVITY_COEF[bi.sensitivity] if adaptive
                          else (0.0, 0.0))
        init_thr = (ABS_SENSITIVITY[bi.sensitivity] if adaptive
                    else bi.init_value)

        self.mesh = mesh if mesh is not None else build_mesh(
            axis_name="stream", device=device)
        if n_streams % self.mesh.size:
            raise ValueError(f"{n_streams} streams do not divide over "
                             f"{self.mesh.size} shards")
        self._step_kw = dict(
            n=self.n, roi=self.std_roi, dy_mask=bool(cfg.dynamic.dy_mask),
            mask_area=self.mask_area, std_interval=bi.interval * self.n,
            momentum=momentum, warmup_speed=float(self.n),
            adaptive=adaptive, coef_a=coef_a, coef_b=coef_b,
            hough_threshold=int(cfg.hough_line.threshold),
            min_len=int(cfg.hough_line.min_len),
            max_gap=float(cfg.hough_line.max_gap), max_points=max_points,
            max_peaks=max_peaks, sharded_fold=True)

        # the carries of each device group: [S_g, ...] on its device
        r1, c1, r2, c2 = self.std_roi
        per = n_streams // self.mesh.size
        self._carries = []
        for dev, a, b in self.mesh.groups():
            s_g = (b - a) * per

            def zeros(*shape):
                return torch.zeros((s_g, self.n - 1) + shape,
                                   dtype=torch.uint8, device=dev)
            self._carries.append([
                zeros(h, w), zeros(r2 - r1, c2 - c1), zeros(h, w),
                EmaState.init(momentum, float(init_thr), dev, (s_g,))])
        self.timer = 0

    def process_blocks_async(self, blocks) -> Any:
        """blocks: [S, T, H, W] uint8, one block per stream (same T), a
        numpy array (uploaded here, the copy done before this returns) or
        a tensor the caller does not write to afterwards (the carries may
        keep its last frames as a view). Enqueues every device's step and
        returns its packed buffers."""
        assert blocks.shape[0] == self.s
        packed = []
        for carry, frames in zip(self._carries,
                                 split_leading(blocks, self.mesh)):
            # the frame timer as a device tensor of each block, as the JAX
            # multistream device_puts one (a fill on the device)
            timer = torch.full((), self.timer, dtype=torch.int32,
                               device=frames.device)
            out, _dst, *new_carry, _new_timer = _m3_block_step(
                *carry, frames.contiguous(), timer, **self._step_kw)
            carry[:] = new_carry
            packed.append(out)
        self.timer += blocks.shape[1]
        return packed

    def collect(self, handle: Any) -> list[list[FrameResult]]:
        """One copy per device for all its streams; returns per-stream
        frame results."""
        buf = np.concatenate([p.cpu().numpy() for p in handle])
        out: list[list[FrameResult]] = []
        for s in range(self.s):
            lines, valid, extras = _unpack(buf[s], self.max_peaks)
            stream_results: list[FrameResult] = []
            for t in range(lines.shape[0]):
                if extras[t, 2] > 0.5:
                    stream_results.append((np.zeros((0, 4), int),
                                           np.zeros((0, self.num_cls))))
                    continue
                fl = lines[t][valid[t]]
                if len(fl) == 0 or len(fl) > NUM_LINES_TOOMUCH:
                    stream_results.append((np.zeros((0, 4), int),
                                           np.zeros((0, self.num_cls))))
                    continue
                nms_lines, nonline = lineset_nms(fl)
                cls_pred = np.zeros((len(nms_lines), self.num_cls))
                cls_pred[:, -1] = nonline
                cls_pred[:, 0] = 1 - nonline
                stream_results.append((nms_lines, cls_pred))
            out.append(stream_results)
        return out

    def process_blocks(self, blocks) -> list[list[FrameResult]]:
        return self.collect(self.process_blocks_async(blocks))


def detect_multi_stream(stream_frames: Sequence[np.ndarray], cfg,
                        rt_params, logger: BaseMetLog,
                        mesh: Optional[DeviceMesh] = None,
                        block_frames: int = 64,
                        max_points: int = 8192, max_peaks: int = 64,
                        device: str = "cuda"):
    """Run S in-memory streams through one batched pipeline with
    per-stream collectors; returns per-stream SingleMDRecord lists.

    stream_frames: S arrays [T, H, W] uint8 (grayscale runtime frames).
    rt_params: RuntimeParams shared by the streams. Whole blocks only: the
    frames past the last full block of the shortest stream are not read.
    """
    from ..track.collector import MeteorCollector
    from ..utils import get_num_class

    s = len(stream_frames)
    h, w = stream_frames[0].shape[1:3]
    det = MultiStreamM3Detector(
        s, cfg.detector.window_sec, rt_params.eq_fps,
        np.ones((h, w), np.uint8), num_cls=get_num_class(),
        cfg=cfg.detector.cfg, logger=logger, mesh=mesh,
        max_points=max_points, max_peaks=max_peaks, device=device)
    collectors = [
        MeteorCollector(cfg.collector, rt_params, video_loader=None,
                        logger=logger, device=det.mesh.devices[0])
        for _ in range(s)]
    n_frames = min(f.shape[0] for f in stream_frames)
    e = rt_params.exp_frame
    for pos in range(0, n_frames - block_frames + 1, block_frames):
        blocks = np.stack([f[pos:pos + block_frames]
                           for f in stream_frames])
        per_stream = det.process_blocks(blocks)
        for si, results in enumerate(per_stream):
            for j, (lines, cates) in enumerate(results):
                frame_idx = (pos + j) * e
                if len(lines) or (pos + j) % max(rt_params.eq_int_fps,
                                                 1) == 0:
                    collectors[si].update(frame_idx, lines, cates)
    for c in collectors:
        c.clear()
    return [c.met_exporter.meteor_list for c in collectors]
