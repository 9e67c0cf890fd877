"""Batch-data-parallel YOLO inference over a device mesh.

Counterpart of ``metdetpy_tpu/parallel/dataparallel.py``. The reference's
photo mode is a single onnxruntime session behind a global lock
(MetLib/model.py:142-166); here a folder scan splits each image batch over
the mesh's devices, one model replica each. The forward, decode and top-k
have no cross-image operation (NMS runs per image), so each device runs
its own sub-batch and only the per-image candidates come back to the host.
Shards that share a device are one sub-batch.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from .mesh import DeviceMesh, build_mesh, canonical, split_leading


def batch_sharding(n_devices: Optional[int] = None,
                   device: str = "cuda") -> DeviceMesh:
    """A mesh that splits the leading (batch) axis over up to
    ``n_devices`` cards (default: all); raises where there are fewer."""
    return build_mesh(n_devices, axis_name="batch", device=device)


def put_batch_sharded(imgs: np.ndarray, mesh: DeviceMesh,
                      upload: Optional[Callable] = None):
    """Upload an image batch split over the mesh, padding the batch axis
    with copies of the last image up to a multiple of the mesh size.
    ``upload(part, device)`` copies one device group's rows (default: a
    plain ``.to(device)``).

    Returns (one tensor per device group, ``mesh.groups()`` order, n_real):
    results for rows >= n_real are padding and must be dropped."""
    n_real = imgs.shape[0]
    rem = n_real % mesh.size
    if rem:
        pad = np.repeat(imgs[-1:], mesh.size - rem, axis=0)
        imgs = np.concatenate([imgs, pad], axis=0)
    if upload is None:
        return split_leading(imgs, mesh), n_real
    per = imgs.shape[0] // mesh.size
    return [upload(imgs[a * per:b * per], dev)
            for dev, a, b in mesh.groups()], n_real


def model_replica(model, device):
    """``model`` (a ``YOLOModel``) on ``device``: itself where it lies
    there, else a copy whose network weights are copied to ``device``."""
    dev = canonical(device)
    if canonical(model.device) == dev:
        return model
    replica = copy.copy(model)
    replica.device = dev
    with torch.inference_mode():
        replica.model = copy.deepcopy(model.model).to(dev)
    return replica
