"""Compile check and multi-device dry run of the port.

    python -m metdetpy_tpu_torch.dryrun [N] [--device cuda|cpu] [--shared]

Counterpart of ``__graft_entry__.py``. ``entry()`` gives the M3 block
step with example arguments (216x384 frames, T=16, n=8, 2048 points):
every kernel of the main path. ``dryrun_multichip(n)`` runs six programs
on an n-shard mesh and prints one line for each, naming its shards and
the devices they lie on:

1. the M3 step over S = n streams with a cross-stream total of the
   packed buffers' diff-area column (each device group's partial moved to
   the first device and added there, as the JAX package's ``psum`` does);
2. ``parallel.temporal.temporal_m3_detect`` over a time mesh;
3. the same over two super-blocks with the state carried between them;
4. ``models.train.make_sharded_train_step`` on a ``(dp, mdl)`` grid;
5. data-parallel inference of a batch that does not divide over the mesh
   (the pad path);
6. ``parallel.temporal_dldet.temporal_window_max_color`` with its carried
   tail, held to a numpy max.

Without ``shared`` the mesh is ``build_mesh(n, device=device)``: n cards
(``ValueError("need n devices, have m")`` where there are fewer), or n
shards on the CPU with ``device="cpu"``. ``shared=True`` lays all n
shards on one device (``shared_mesh``), by choice, never as a fallback.

The train program keeps each dp slice's mdl shards on one device (the
port's ``make_sharded_train_step`` requires it), so on n cards its
``(n/2, 2)`` grid lies over n/2 cards, dp slice k on card k. Its weights
come from ``yolov5.init_params(seed=0)`` (a ``torch.Generator``), not
from the JAX package's initialiser; the loss printed is the first
step's, taken before the optimiser's update.

The default device is ``cuda``, which raises without a card. Both parts
run in one process: the port has no backend to re-initialise.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .detectors.m3det import EmaState, _m3_block_step
from .parallel.mesh import (DeviceMesh, GridMesh, build_mesh, canonical,
                            shared_mesh)

# program 1-3's detector at the JAX dry run's sizes
STREAM_N, STREAM_T, STREAM_H, STREAM_W = 4, 4, 48, 64
STREAM_ROI = (16, 24, 32, 40)
STREAM_KW = dict(n=STREAM_N, roi=STREAM_ROI, dy_mask=True,
                 mask_area=STREAM_H * STREAM_W, std_interval=2 * STREAM_N,
                 momentum=1 - 2 / 60, warmup_speed=float(STREAM_N),
                 adaptive=True, coef_a=1.2, coef_b=3.6, hough_threshold=5,
                 min_len=5, max_gap=5.0, max_points=256, max_peaks=8)
TRAIN_HW, TRAIN_NC = (64, 64), 8


def _m3_args(n, t_block, h, w, roi, max_points, max_peaks, device):
    """The step's carries from stream start (zero histories, a fresh EMA),
    a [t_block, h, w] block of noise from ``default_rng(0)`` and the frame
    timer 100 (a 0-dim int32, as the JAX entry passes ``jnp.int32(100)``),
    on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    r1, c1, r2, c2 = roi

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device=dev)
    frames = rng.integers(0, 40, (t_block, h, w), np.uint8)
    return (zeros(n - 1, h, w),                       # gray history
            zeros(n - 1, r2 - r1, c2 - c1),           # sub-ROI history
            zeros(n - 1, h, w),                       # dynamic-mask history
            EmaState.init(1 - 2 / 60, 5.0, dev),
            torch.from_numpy(frames).to(dev),
            torch.full((), 100, dtype=torch.int32, device=dev))  # timer0


def entry(device: str = "cuda"):
    """(fn, example_args): the M3 block step (window diff -> EMA
    threshold -> median/binarize/close -> dynamic mask -> batched Hough ->
    packed buffer) over a [16, 216, 384] u8 block, its arguments on
    ``device``."""
    n, t_block, h, w = 8, 16, 216, 384
    roi = (74, 132, 142, 252)  # centred ~10% sub-ROI
    fn = functools.partial(
        _m3_block_step, n=n, roi=roi, dy_mask=True, mask_area=h * w,
        std_interval=2 * n, momentum=1 - 2 / 60, warmup_speed=float(n),
        adaptive=True, coef_a=1.2, coef_b=3.6, hough_threshold=10,
        min_len=10, max_gap=10.0, max_points=2048, max_peaks=32)
    return fn, _m3_args(n, t_block, h, w, roi, 2048, 32, device)


def where(mesh) -> str:
    """``"<n> shards over <k> device(s) (<devices>)"`` of a mesh."""
    devs = (mesh.devices if isinstance(mesh, DeviceMesh)
            else [d for row in mesh.devices for d in row])
    n = len(devs)
    distinct = list(dict.fromkeys(canonical(d) for d in devs))
    return (f"{n} shards over {len(distinct)} "
            f"device{'s' if len(distinct) > 1 else ''} "
            f"({', '.join(str(d) for d in distinct)})")


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {msg}")


def stream_step(mesh: DeviceMesh):
    """Program 1: S = mesh.size streams of the same block through the
    step (the shards of each device as one batched call, the sharded
    programs' fold of the diff area); the cross-stream total of each
    stream's summed ``packed[:, -6]``, added in stream order on the first
    device. Returns (packed [S, T, K*5+6], total) as numpy."""
    gray, sub, dy, _, frames, timer0 = _m3_args(
        STREAM_N, STREAM_T, STREAM_H, STREAM_W, STREAM_ROI, 256, 8, "cpu")
    dev0 = canonical(mesh.devices[0])
    packed, sums = [], []
    for dev, a, b in mesh.groups():
        def rep(x):
            return x[None].expand((b - a,) + tuple(x.shape)).to(
                dev).contiguous()
        ema = EmaState.init(1 - 2 / 60, 5.0, dev, (b - a,))
        p, *_ = _m3_block_step(rep(gray), rep(sub), rep(dy), ema,
                               rep(frames), timer0, **STREAM_KW,
                               sharded_fold=True)
        packed.append(p)
        col = p[..., -6]
        for s in range(b - a):        # each stream's sum, frame by frame
            acc = col[s, 0]
            for t in range(1, col.shape[1]):
                acc = acc + col[s, t]
            sums.append(acc.to(dev0))
    total = sums[0]
    for x in sums[1:]:
        total = total + x
    return (np.concatenate([p.cpu().numpy() for p in packed]),
            np.float32(total.item()))


def _temporal_frames(n_shards: int) -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, 40, (n_shards * (STREAM_N + 2), STREAM_H, STREAM_W), np.uint8)


def temporal(mesh: DeviceMesh):
    """Program 2: the M3 step over n·(n_win+2) frames on a time mesh.
    Returns (packed, dst) as numpy."""
    from .parallel.temporal import temporal_m3_detect
    packed, dst = temporal_m3_detect(
        _temporal_frames(mesh.size), **STREAM_KW,
        mesh=dataclasses.replace(mesh, axis_name="time"), axis_name="time")
    return packed.cpu().numpy(), dst.cpu().numpy()


def streaming_temporal(mesh: DeviceMesh):
    """Program 3: two chained super-blocks of program 2's frames, the
    state carried on the first device between them. Returns (the two
    packed buffers, the super-block's length)."""
    from .parallel.temporal import temporal_m3_detect
    tmesh = dataclasses.replace(mesh, axis_name="time")
    frames = _temporal_frames(mesh.size)
    half = frames.shape[0] // 2 // mesh.size * mesh.size
    p1, _, carry = temporal_m3_detect(
        frames[:half], **STREAM_KW, mesh=tmesh, axis_name="time",
        return_carry=True)
    p2, _, carry = temporal_m3_detect(
        frames[half:2 * half], **STREAM_KW, mesh=tmesh, axis_name="time",
        carry=carry, return_carry=True)
    return p1.cpu().numpy(), p2.cpu().numpy(), half


def train_grid(mesh: DeviceMesh) -> GridMesh:
    """Program 4's ``(dp, mdl)`` grid: mdl = 2 where the mesh's size is
    even, else 1; dp slice k lies on the mesh's shard k."""
    mdl = 2 if mesh.size % 2 == 0 else 1
    dp = mesh.size // mdl
    return GridMesh(tuple((mesh.devices[k],) * mdl for k in range(dp)))


def train_step(mesh: DeviceMesh, params: Optional[dict] = None):
    """Program 4: one step of YOLOv5s (nc 8, bfloat16 body) at 64x64 over
    ``train_grid(mesh)`` on ``synth_batch(default_rng(1), dp, ...)``, Adam
    at 1e-3. ``params``: a flattened flax tree to start from (default:
    ``init_params(seed=0)``). Returns (the first step's loss, the grid)."""
    from .models import train, yolov5
    from .models.weights import params_from_flax
    grid = train_grid(mesh)
    dev0 = canonical(mesh.devices[0])
    if params is None:
        model = yolov5.init_params(nc=TRAIN_NC, input_hw=TRAIN_HW, seed=0,
                                   device=dev0)
    else:
        model = yolov5.YOLOv5(nc=TRAIN_NC)
        model.load_state_dict(params_from_flax(params), strict=True)
        model = model.to(dev0)
    opt = train.Adam(model.parameters(), 1e-3)
    step = train.make_sharded_train_step(model, opt, TRAIN_NC, grid)
    dp = grid.shape["dp"]
    imgs, targets = train.synth_batch(np.random.default_rng(1), dp,
                                      TRAIN_HW, TRAIN_NC)
    loss = float(step(imgs, targets))
    _require(np.isfinite(loss), f"train step loss {loss}")
    return loss, grid


def data_parallel(mesh: DeviceMesh):
    """Program 5: YOLOv5s with the shipped weights (nms on, single scale,
    64x64) on n + 3 random images split over the mesh, the batch padded
    to a multiple of its size, one replica per device. Returns the n + 3
    results (boxes, scores) as numpy."""
    from .log import BaseMetLog
    from .models.yolo import YOLOModel
    from .parallel.dataparallel import model_replica, put_batch_sharded
    from .utils import relative2abs_path
    bmesh = dataclasses.replace(mesh, axis_name="batch")
    model = YOLOModel(
        weight_path=relative2abs_path("./weights/yolov5s_v5.flax.npz"),
        dtype="float32", nms=True, warmup=False, multiscale_pred=0,
        logger=BaseMetLog(), input_hw=TRAIN_HW, device=bmesh.devices[0])
    imgs = np.random.default_rng(0).integers(
        0, 255, (mesh.size + 3, 64, 64, 3), np.uint8)
    parts, n_real = put_batch_sharded(imgs, bmesh)
    outs = []
    for (dev, _, _), part in zip(bmesh.groups(), parts):
        outs.extend(model_replica(model, dev).forward_batch_device(part))
    outs = outs[:n_real]
    _require(len(outs) == mesh.size + 3,
             f"{len(outs)} results for {mesh.size + 3} images")
    return [tuple(np.asarray(x) for x in r) for r in outs]


def temporal_dldet(mesh: DeviceMesh):
    """Program 6: the colour window-max (n=3) over 4n frames of 16x24
    from ``default_rng(1)`` on a time mesh, twice, the second call
    carrying the first one's tail; the second call's first stack must be
    the max over the clip's last two frames and its first. Returns the
    frames and both calls' stacks as numpy."""
    from .parallel.temporal_dldet import temporal_window_max_color
    tmesh = dataclasses.replace(mesh, axis_name="time")
    tfr = np.random.default_rng(1).integers(
        0, 255, (4 * mesh.size, 16, 24, 3), np.uint8)
    stacks, carry = temporal_window_max_color(tfr, 3, tmesh, "time")
    stacks2, _ = temporal_window_max_color(tfr, 3, tmesh, "time",
                                           carry=carry)
    stacks = np.concatenate([x.cpu().numpy() for x in stacks])
    stacks2 = np.concatenate([x.cpu().numpy() for x in stacks2])
    ref = np.max(np.stack([tfr[-2], tfr[-1], tfr[0]]), axis=0)
    _require(np.array_equal(stacks2[0], ref),
             "the carried tail did not reach shard 0 of the second call")
    return tfr, stacks, stacks2


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     shared: bool = False) -> dict:
    """Run the six programs on an ``n_devices``-shard mesh, one line
    printed for each; returns each program's outputs as numpy."""
    mesh = (shared_mesh(n_devices, device) if shared
            else build_mesh(n_devices, device=device))
    out = {}
    packed, total = stream_step(mesh)
    _require(packed.shape[0] == n_devices, f"packed {packed.shape}")
    out["stream"] = {"packed": packed, "total": total}
    print(f"dryrun_multichip OK on {where(mesh)}: packed {packed.shape}, "
          f"cross-stream total {total}", flush=True)

    tpacked, tdst = temporal(mesh)
    _require(tpacked.shape[0] == n_devices * (STREAM_N + 2),
             f"temporal packed {tpacked.shape}")
    out["temporal"] = {"packed": tpacked, "dst": tdst}
    print(f"dryrun temporal OK on {where(mesh)} (time mesh): packed "
          f"{tpacked.shape}", flush=True)

    p1, p2, half = streaming_temporal(mesh)
    out["streaming"] = {"packed1": p1, "packed2": p2}
    print(f"dryrun streaming temporal OK on {where(mesh)}: 2 super-blocks "
          f"of {half} frames, carried state on {mesh.devices[0]}",
          flush=True)

    loss, grid = train_step(mesh)
    dp, mdl = grid.shape["dp"], grid.shape["mdl"]
    out["train"] = {"loss": loss}
    print(f"dryrun train step OK on ({dp}x{mdl}) mesh, {where(grid)}, dp "
          f"slice k on shard k's device: loss={loss:.4f}", flush=True)

    results = data_parallel(mesh)
    out["data_parallel"] = {"results": results}
    print(f"dryrun data-parallel inference OK: batch {len(results)} (+pad) "
          f"sharded over {where(mesh)}", flush=True)

    tfr, stacks, stacks2 = temporal_dldet(mesh)
    out["temporal_dldet"] = {"frames": tfr, "stacks": stacks,
                             "stacks2": stacks2}
    print(f"dryrun temporal-dldet window-max OK: halo + carried tail over "
          f"{where(mesh)} (time shards)", flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m metdetpy_tpu_torch.dryrun",
        description="Compile check of the M3 step and a dry run of the "
                    "six multi-device programs.")
    parser.add_argument("n", nargs="?", type=int, default=8,
                        help="shards of the mesh (default 8)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; n cards) or cpu (n shards)")
    parser.add_argument("--shared", action="store_true",
                        help="lay all n shards on one device")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    outs = fn(*example)
    print("entry OK:", [tuple(o.shape) for o in outs
                        if isinstance(o, torch.Tensor)], flush=True)
    dryrun_multichip(args.n, device=args.device, shared=args.shared)


if __name__ == "__main__":
    main()
