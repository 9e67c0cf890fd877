"""Device meshes of the port.

Counterpart of ``metdetpy_tpu/parallel/mesh.py``. The JAX package lays a
1-D ``jax.sharding.Mesh`` over its devices and runs one program on every
shard through ``shard_map``. The port keeps that single-controller model
without a process group: a ``DeviceMesh`` is a tuple of ``torch.device``,
one per shard, and a parallel module runs the shards that share a device
as a batch axis of one call (``groups``), the shards of different devices
one call each, exchanging halos by ``.to(device)``. A mesh whose shards
all lie on one device (``shared_mesh``, and any mesh on the CPU) is the
counterpart of the JAX package's virtual 8-device CPU platform. A
``GridMesh`` is the 2-D form (the train step's ``(dp, mdl)`` mesh); its
slices along an axis are ``DeviceMesh``es.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh: the device of each shard, in shard order."""
    devices: tuple
    axis_name: str = "stream"

    @property
    def size(self) -> int:
        return len(self.devices)

    def groups(self) -> list[tuple[torch.device, int, int]]:
        """(device, first shard, end shard) for each run of consecutive
        shards on one device, in shard order."""
        out: list[tuple[torch.device, int, int]] = []
        for i, dev in enumerate(self.devices):
            dev = canonical(dev)
            if out and out[-1][0] == dev:
                out[-1] = (dev, out[-1][1], i + 1)
            else:
                out.append((dev, i, i + 1))
        return out


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A 2-D mesh: ``devices[i][j]`` is the device of shard (i, j), the
    axes named ``axis_names`` (the counterpart of a ``jax.sharding.Mesh``
    over a 2-D device array, such as the train step's ``(dp, mdl)``)."""
    devices: tuple
    axis_names: tuple = ("dp", "mdl")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    def along(self, axis: str) -> DeviceMesh:
        """The 1-D mesh of the slices along ``axis``: slice k holds the
        shards whose index on ``axis`` is k, and lies where they lie; a
        slice whose shards lie on more than one device raises
        ``ValueError``."""
        grid = (self.devices if self.axis_names.index(axis) == 0
                else tuple(zip(*self.devices)))
        out = []
        for k, row in enumerate(grid):
            devs = {canonical(d) for d in row}
            if len(devs) != 1:
                raise ValueError(f"the shards of {axis} slice {k} lie on "
                                 f"{len(devs)} devices, not one")
            out.append(devs.pop())
        return DeviceMesh(tuple(out), axis)


def shared_grid(shape: tuple[int, int],
                device: Union[str, torch.device] = "cuda") -> GridMesh:
    """A ``(dp, mdl)`` mesh of ``shape`` whose shards all lie on one
    device."""
    if min(shape) < 1:
        raise ValueError(f"a mesh needs at least one shard, not {shape}")
    dev = canonical(resolve_device(device))
    return GridMesh(tuple((dev,) * shape[1] for _ in range(shape[0])))


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card, so that
    devices compare equal where tensors on them do."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(n_devices: Optional[int] = None, axis_name: str = "stream",
               device: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` cards (default: all), one
    shard each; raises ``ValueError("need n devices, have m")`` where there
    are fewer, as the JAX package does. On ``"cpu"``, a mesh of
    ``n_devices`` (default 1) shards, all on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return shared_mesh(n_devices or 1, dev, axis_name)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, not {n}")
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return DeviceMesh(tuple(torch.device("cuda", i) for i in range(n)),
                      axis_name)


def shared_mesh(n_shards: int, device: Union[str, torch.device] = "cuda",
                axis_name: str = "stream") -> DeviceMesh:
    """A mesh of ``n_shards`` shards that all lie on one device."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_shards}")
    return DeviceMesh((canonical(resolve_device(device)),) * n_shards,
                      axis_name)


def split_leading(x, mesh: DeviceMesh) -> list[torch.Tensor]:
    """Split the leading axis of ``x`` (numpy or a tensor) evenly over the
    mesh's shards, as the JAX package's ``stream_sharding`` does: one
    tensor per device group (``mesh.groups()``), holding that group's
    shards' rows, on its device. The leading axis must divide by the
    mesh's size."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                         f"{mesh.size} shards")
    per = x.shape[0] // mesh.size
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return [x[a * per:b * per].to(dev) for dev, a, b in mesh.groups()]
