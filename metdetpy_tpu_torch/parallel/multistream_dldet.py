"""Multi-stream dldet: S colour camera feeds, an MLDetector pipeline each,
batched over a device mesh.

Counterpart of ``metdetpy_tpu/parallel/multistream_dldet.py``, the dldet
complement of ``multistream.py``: each stream's rolling colour window-max
runs with its own device history carry (the streams of a device as one
batch), and the YOLO forward takes the flattened [S*T] stacks of each
device in one dispatch (one model replica per device). The host keeps one
MeteorCollector per stream. Box orientation is MLDetector's: the ROIs of
all boxes of a block come back in one copy.

The reference's only concurrency is intra-process threads
(SURVEY.md §2.4); it has no multi-camera scale-out at all.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..detectors.base import FrameResult
from ..detectors.mldet import _window_max_color, orient_results
from ..log import BaseMetLog
from ..structs import DLCfg
from .dataparallel import model_replica
from .mesh import DeviceMesh, build_mesh, split_leading


class MultiStreamMLDetector:
    """MLDetector over S independent streams, split evenly over the mesh's
    shards (S must divide by its size)."""

    def __init__(self, n_streams: int, window_sec: float, fps: float,
                 mask: np.ndarray, num_cls: int, cfg: DLCfg,
                 logger: BaseMetLog, mesh: Optional[DeviceMesh] = None,
                 device: str = "cuda") -> None:
        from ..models import init_model
        self.s = n_streams
        self.num_cls = num_cls
        self.logger = logger
        self.n = max(int(window_sec * fps), 1)
        h, w = mask.shape[:2]
        c = mask.shape[2] if mask.ndim == 3 else 3
        self.mesh = mesh if mesh is not None else build_mesh(
            axis_name="stream", device=device)
        if n_streams % self.mesh.size:
            raise ValueError(f"{n_streams} streams do not divide over "
                             f"{self.mesh.size} shards")
        self.model = init_model(cfg.model, logger=self.logger,
                                device=self.mesh.devices[0])
        per = n_streams // self.mesh.size
        # per device group: [model replica, window history [S_g, n-1, ...]]
        self._groups = [
            [model_replica(self.model, dev),
             torch.zeros(((b - a) * per, self.n - 1, h, w, c),
                         dtype=torch.uint8, device=dev)]
            for dev, a, b in self.mesh.groups()]

    def process_blocks_async(self, blocks) -> Any:
        """blocks: [S, T, H, W, 3] uint8, one block per stream (same T).
        Enqueues the window-max and every YOLO level of each device; the
        history carries advance at once, so block groups can pipeline."""
        assert blocks.shape[0] == self.s
        handles = []
        with torch.inference_mode():
            for group, frames in zip(self._groups,
                                     split_leading(blocks, self.mesh)):
                stacks, group[1] = _window_max_color(group[1], frames,
                                                     self.n)
                flat = stacks.reshape((-1,) + tuple(stacks.shape[2:]))
                handles.append((flat, group[0].dispatch_batch_device(flat)))
        return handles, blocks.shape[1]

    def collect(self, handle: Any) -> list[list[FrameResult]]:
        """The candidates of each device in one fetch, the boxes oriented
        as MLDetector orients them; per-stream frame results."""
        handles, t = handle
        results: list[FrameResult] = []
        for (flat, model_handle), (model, _) in zip(handles, self._groups):
            results.extend(orient_results(
                flat, model.collect_batch_device(model_handle),
                self.num_cls))
        return [results[s * t:(s + 1) * t] for s in range(self.s)]

    def process_blocks(self, blocks) -> list[list[FrameResult]]:
        return self.collect(self.process_blocks_async(blocks))


def detect_multi_stream_dldet(stream_frames: Sequence[np.ndarray], cfg,
                              rt_params, logger: BaseMetLog,
                              mesh: Optional[DeviceMesh] = None,
                              block_frames: int = 64,
                              device: str = "cuda"):
    """Run S in-memory COLOUR streams through one batched dldet pipeline
    with per-stream collectors; returns per-stream SingleMDRecord lists.

    stream_frames: S arrays [T, H, W, 3] uint8 (runtime-size colour).
    rt_params: RuntimeParams shared by the streams.
    """
    from ..track.collector import MeteorCollector
    from ..utils import get_num_class

    s = len(stream_frames)
    h, w = stream_frames[0].shape[1:3]
    det = MultiStreamMLDetector(
        s, cfg.detector.window_sec, rt_params.eq_fps,
        np.ones((h, w, 3), np.uint8), num_cls=get_num_class(),
        cfg=cfg.detector.cfg, logger=logger, mesh=mesh, device=device)
    collectors = [
        MeteorCollector(cfg.collector, rt_params, video_loader=None,
                        logger=logger, device=det.mesh.devices[0])
        for _ in range(s)]
    n_frames = min(f.shape[0] for f in stream_frames)
    e = rt_params.exp_frame
    eq_int_fps = max(rt_params.eq_int_fps, 1)
    for pos in range(0, n_frames - block_frames + 1, block_frames):
        blocks = np.stack([f[pos:pos + block_frames]
                           for f in stream_frames])
        per_stream = det.process_blocks(blocks)
        for si, results in enumerate(per_stream):
            for j, (lines, cates) in enumerate(results):
                if len(lines) or (pos + j) % eq_int_fps == 0:
                    collectors[si].update((pos + j) * e, lines=lines,
                                          cates=cates)
    for c in collectors:
        c.clear()
    return [c.met_exporter.meteor_list for c in collectors]
