"""Dispatch/collect pipelining for batched photo inference.

Counterpart of ``metdetpy_tpu/models/pipeline.py``. ``BatchPipeline`` keeps
up to ``inflight`` batches pending: it uploads batch N+1 and enqueues its
device work (launches are asynchronous) before it collects batch N's
results, so the upload and the device's work overlap the host
postprocess of the previous batch. With ``inflight=0`` it is the
synchronous call order (the photo entry point's interactive ``--visu``
mode, which shows one image at a time).

The path is settled once, from the model: a model with NMS runs on the
device (``YOLOModel.dispatch_batch_device`` / ``collect_batch_device``,
each batch uploaded from pinned host memory); a model without it cannot
keep its candidates on the device and runs ``forward_batch`` per batch.
Nothing switches from one to the other on an exception. (The reference
has no analog: it runs one onnxruntime session call per image under a
global lock, MetLib/model.py:341-383.)
"""

from __future__ import annotations

import collections

import numpy as np
import torch


class BatchPipeline:
    """Order-preserving dispatch/collect pipeline over batched YOLO
    inference. ``submit`` returns completed (tag, (boxes, cls)) pairs
    for batches pushed beyond the in-flight budget; ``drain`` flushes
    the rest."""

    def __init__(self, model, inflight: int = 1, sharding=None) -> None:
        if sharding is not None:
            raise NotImplementedError(
                "sharding a batch over devices comes with the multi-device "
                "slice of the PyTorch/CUDA port")
        self.model = model
        self.inflight = max(int(inflight), 0)
        self.device_path = bool(getattr(model, "nms", False))
        self._q: collections.deque = collections.deque()

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """The batch on the model's device: through a pinned host copy on
        a card (the copy is enqueued and the host returns), as it is on
        the CPU."""
        src = torch.from_numpy(np.ascontiguousarray(x))
        dev = self.model.device
        if dev.type != "cuda":
            return src
        staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        staged.copy_(src)
        with torch.cuda.device(dev):
            return staged.to(dev, non_blocking=True)

    def _dispatch(self, imgs: np.ndarray):
        if not self.device_path:
            return self.model.forward_batch(imgs)
        from .yolo import _ensure_3ch

        # mirror forward_batch's preconditions: photo folders load with
        # IMREAD_UNCHANGED, so grayscale (2-D) and RGBA frames must be
        # channel-normalised before the device path sees them
        x = imgs
        if x.ndim == 3 or x.shape[-1] != 3:
            x = np.stack([_ensure_3ch(im) for im in x])
        return self.model.dispatch_batch_device(self._upload(x))

    def _collect(self, entry) -> list:
        tags, handle = entry
        outs = (self.model.collect_batch_device(handle) if self.device_path
                else handle)
        return list(zip(tags, outs))

    def submit(self, tags: list, imgs: np.ndarray) -> list:
        """Dispatch one batch (tags are caller-opaque, one per image);
        collect and return batches now beyond the in-flight budget, in
        submission order."""
        self._q.append((list(tags), self._dispatch(imgs)))
        done: list = []
        while len(self._q) > self.inflight:
            done.extend(self._collect(self._q.popleft()))
        return done

    def drain(self) -> list:
        """Collect every pending batch, in submission order."""
        done: list = []
        while self._q:
            done.extend(self._collect(self._q.popleft()))
        return done
