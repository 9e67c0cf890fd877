"""Temporal (sequence) sharding with halo exchange.

Counterpart of ``metdetpy_tpu/parallel/temporal.py``. A long block of T
frames is split into S consecutive shards of T/S frames; every shard
needs the n-1 frames before it for its trailing windows, so it receives
them from its LEFT neighbour (the halo), and shard 0 receives the tail of
the previous super-block (the carry) or zeros at stream start.

``temporal_m3_detect`` runs the complete M3 detect step (window stats ->
EMA adaptive threshold -> median/binarize/close -> dynamic mask ->
batched Hough -> packed readback) time-sharded, with results exactly
equal to ``detectors.m3det._m3_block_step`` on the whole block.

The noise EMA is a sequential scan over per-frame sub-ROI stds, scalars
([T] floats): the stds of all shards are gathered and the scan runs once
over them, exactly as on one device; only the per-pixel work is sharded.
(The JAX package runs the same scan redundantly on every shard, which
gives the same result.) The dynamic-mask halo is the last n-1 BINARIZED
frames of the left neighbour, themselves outputs of this step: every
shard binarizes first, then the binarized tails move right -- two phases
in one call.

Layout: the shards of one device run as a batch axis of each call (one
window_diff and one median_binarize_close launch for all of them, one
Hough batch of all their frames); a halo crosses devices by
``.to(device)``, which is no copy where the shards share one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..detectors.m3det import (ABS_SENSITIVITY, SENSITIVITY_COEF, EmaState,
                               _ema_threshold_scan, _m3_lines,
                               median_binarize_close_blocks, select_subarea)
from ..ops import kernels, windows
from .mesh import DeviceMesh, build_mesh, canonical, split_leading


def _check_shards(t_total: int, s: int, n: int) -> int:
    """The shard length T/S; raises where T does not divide over the
    shards or a shard is shorter than the halo."""
    if t_total % s:
        raise ValueError(f"T={t_total} must divide over the {s} shards")
    if t_total // s < n - 1:
        raise ValueError(
            f"each time shard must hold at least n-1={n - 1} frames for "
            f"the halo; got {t_total}/{s} -- use fewer shards or longer "
            "super-blocks")
    return t_total // s


def _shard(frames, mesh: DeviceMesh, t_local: int) -> list[torch.Tensor]:
    """[T, ...] frames (numpy or a tensor) -> per device group, its
    shards' frames as [S_g, T/S, ...] on its device."""
    return [x.reshape((-1, t_local) + tuple(x.shape[1:]))
            for x in split_leading(frames, mesh)]


def _halo_from_left(local: list[torch.Tensor], n: int,
                    carry: Optional[torch.Tensor] = None
                    ) -> list[torch.Tensor]:
    """Each shard receives the last n-1 frames of its LEFT neighbour; the
    first shard gets ``carry`` (the tail of the previous super-block) or
    zeros at stream start. ``local``: per device group [S_g, T/S, ...];
    returns per group [S_g, n-1, ...] on its device."""
    halos = []
    left = carry
    for g in local:
        tails = g[:, g.shape[1] - (n - 1):]
        first = (torch.zeros_like(tails[:1]) if left is None
                 else left.to(g.device)[None])
        halos.append(torch.cat([first, tails[:-1]], dim=0))
        left = tails[-1]
    return halos


def _tail_to_first(local: list[torch.Tensor], n: int,
                   device: torch.device) -> torch.Tensor:
    """The LAST shard's n-1 tail frames on shard 0's device, where the
    next super-block's first shard needs them as its left halo."""
    last = local[-1][-1]
    return last[last.shape[0] - (n - 1):].to(device).clone()


def temporal_window_stats(frames, n: int,
                          mesh: Optional[DeviceMesh] = None,
                          axis_name: str = "time", device: str = "cuda"):
    """Rolling window max/mean/diff over a time-sharded [T, H, W] block
    from stream start (zero history before shard 0); plain PyTorch.

    Returns WindowStats of all T positions, on the first shard's device.
    """
    mesh = mesh if mesh is not None else build_mesh(axis_name=axis_name,
                                                    device=device)
    t_local = _check_shards(frames.shape[0], mesh.size, n)
    local = _shard(frames, mesh, t_local)
    dev0 = canonical(mesh.devices[0])
    parts = []
    for (_, a, _), loc, halo in zip(mesh.groups(), local,
                                    _halo_from_left(local, n)):
        stats, _ = windows.window_stats(halo, loc, n, a * t_local, t_local)
        parts.append([x.reshape((-1,) + x.shape[2:]).to(dev0)
                      for x in stats])
    return windows.WindowStats(*(torch.cat(p) for p in zip(*parts)))


def init_temporal_carry(mesh: DeviceMesh, *, n: int, h: int, w: int,
                        momentum: float, init_threshold: float):
    """Fresh stream-start carry for :func:`temporal_m3_detect`, on the
    first shard's device: (EMA state with its host schedule, gray tail,
    binarized tail, frame offset)."""
    dev0 = canonical(mesh.devices[0])
    zeros = torch.zeros((n - 1, h, w), dtype=torch.uint8, device=dev0)
    return (EmaState.init(momentum, init_threshold, dev0), zeros,
            zeros.clone(), 0)


def temporal_m3_detect(frames, *, n: int, roi: tuple, dy_mask: bool,
                       mask_area: int, std_interval: int, momentum: float,
                       warmup_speed: float, adaptive: bool, coef_a: float,
                       coef_b: float, hough_threshold: int, min_len: int,
                       max_gap: float, max_points: int = 2048,
                       max_peaks: int = 32,
                       mesh: Optional[DeviceMesh] = None,
                       axis_name: str = "time", init_threshold: float = 5.0,
                       carry=None, return_carry: bool = False,
                       device: str = "cuda"):
    """Full fused M3 detect over a time-sharded [T, H, W] stream segment
    (numpy, or a tensor).

    With ``carry=None``, identical to ``_m3_block_step`` on the whole
    block from stream start (timer 0, zero histories, fresh EMA). Passing
    the carry returned by a previous call (``return_carry=True``)
    continues the stream exactly: the previous super-block's gray and
    binarized tails become shard 0's halos, the EMA scan resumes from its
    carried state (with its host schedule), the timers continue.

    Returns (packed [T, K*5+6] f32, dst [T, H, W] u8) on the first
    shard's device, plus the next carry when ``return_carry``.
    """
    mesh = mesh if mesh is not None else build_mesh(axis_name=axis_name,
                                                    device=device)
    t_total, h, w = frames.shape
    t_local = _check_shards(t_total, mesh.size, n)
    dev0 = canonical(mesh.devices[0])
    if carry is None:
        carry = init_temporal_carry(mesh, n=n, h=h, w=w, momentum=momentum,
                                    init_threshold=init_threshold)
    ema0, gray_tail, dy_tail, t_offset = carry
    groups = mesh.groups()
    r1, c1, r2, c2 = roi
    local = _shard(frames, mesh, t_local)

    # phase 1: window diff and sub-ROI stds, gray halos from the left
    diffs, stds = [], []
    for (_, a, _), loc, halo in zip(groups, local,
                                    _halo_from_left(local, n, gray_tail)):
        timer0 = t_offset + a * t_local
        diffs.append(kernels.window_diff(halo, loc, n, timer0, t_local)[0])
        stds.append(windows.window_noise_std(
            halo[..., r1:r2, c1:c2], loc[..., r1:r2, c1:c2], n, timer0,
            t_local)[0])

    # phase 2: the exact global EMA over the gathered [T] stds, once
    stds_full = torch.cat([x.reshape(-1).to(dev0) for x in stds])
    thr, thr_f, ema_vals, ema_next = _ema_threshold_scan(
        stds_full, t_offset, ema0, n=n, std_interval=std_interval,
        momentum=momentum, warmup_speed=warmup_speed, adaptive=adaptive,
        coef_a=coef_a, coef_b=coef_b)

    def part(x, dev, a, b):
        return x[a * t_local:b * t_local].to(dev).reshape(b - a, t_local)

    # phase 3: binarize every shard, THEN move the binarized tails right
    closed = [median_binarize_close_blocks(d, part(thr, dev, a, b))
              for (dev, a, b), d in zip(groups, diffs)]
    dy_halos = (_halo_from_left(closed, n, dy_tail) if dy_mask
                else [None] * len(closed))

    # phase 4: dynamic mask, per-frame Hough of each device's frames
    # together, the packed buffer
    packed, dst = [], []
    for (dev, a, b), c, dy_halo in zip(groups, closed, dy_halos):
        p, d, _ = _m3_lines(
            c, dy_halo, t_offset + a * t_local, t_local,
            part(ema_vals, dev, a, b), part(thr_f, dev, a, b),
            part(thr, dev, a, b), n=n, dy_mask=dy_mask,
            mask_area=mask_area, hough_threshold=hough_threshold,
            min_len=min_len, max_gap=max_gap, max_points=max_points,
            max_peaks=max_peaks, sharded_fold=True)
        packed.append(p.reshape(t_local * (b - a), -1).to(dev0))
        dst.append(d.reshape(t_local * (b - a), h, w).to(dev0))
    packed, dst = torch.cat(packed), torch.cat(dst)
    if return_carry:
        return packed, dst, (ema_next, _tail_to_first(local, n, dev0),
                             _tail_to_first(closed, n, dev0),
                             t_offset + t_total)
    return packed, dst


def _m3_params(cfg, fps: float, mask: np.ndarray) -> dict:
    """temporal_m3_detect's detector arguments from a config."""
    bi = cfg.detector.cfg.binary
    adaptive = bool(bi.adaptive_bi_thre)
    coef_a, coef_b = (SENSITIVITY_COEF[bi.sensitivity] if adaptive
                      else (0.0, 0.0))
    init_thr = (ABS_SENSITIVITY[bi.sensitivity] if adaptive
                else bi.init_value)
    n = max(int(cfg.detector.window_sec * fps), 1)
    hough = cfg.detector.cfg.hough_line
    return dict(
        n=n, roi=select_subarea(mask, bi.area),
        dy_mask=bool(cfg.detector.cfg.dynamic.dy_mask),
        mask_area=int(np.sum(mask)), std_interval=bi.interval * n,
        momentum=1 - bi.interval / 60, warmup_speed=float(n),
        adaptive=adaptive, coef_a=coef_a, coef_b=coef_b,
        hough_threshold=int(hough.threshold), min_len=int(hough.min_len),
        max_gap=float(hough.max_gap), init_threshold=float(init_thr))


def _runtime(fps: float, h: int, w: int, rt_params):
    from ..structs import RuntimeParams
    if rt_params is not None:
        return rt_params
    return RuntimeParams(fps=fps, exp_frame=1, eq_fps=fps,
                         eq_int_fps=int(fps), exp_time=1 / fps,
                         runtime_size=[w, h], raw_size=[w, h],
                         positive_category_list=["METEOR"])


def detect_frames_temporal(frames: np.ndarray, cfg, fps: float,
                           mask: Optional[np.ndarray] = None,
                           mesh: Optional[DeviceMesh] = None,
                           axis_name: str = "time",
                           max_points: int = 8192, max_peaks: int = 64,
                           logger=None, rt_params=None,
                           device: str = "cuda"):
    """Batch-detect a whole in-memory clip with the time axis sharded over
    the mesh: one sharded step gives every frame's lines, then the host
    collector runs over them. frames: [T, H, W] uint8 runtime-size
    grayscale; T is truncated to a multiple of the mesh size.

    Returns (records, n_frames_used): the MDRF result records and how
    many leading frames were processed.
    """
    from ..log import BaseMetLog
    from ..track.collector import MeteorCollector
    from ..utils import get_num_class

    logger = logger or BaseMetLog()
    mesh = mesh if mesh is not None else build_mesh(axis_name=axis_name,
                                                    device=device)
    s = mesh.size
    t_total = frames.shape[0] // s * s
    frames = frames[:t_total]
    h, w = frames.shape[1:3]
    if mask is None:
        mask = np.ones((h, w), np.uint8)
    else:
        frames = frames * mask[None]
    packed, _dst = temporal_m3_detect(
        frames, **_m3_params(cfg, fps, mask), max_points=max_points,
        max_peaks=max_peaks, mesh=mesh)
    rt = _runtime(fps, h, w, rt_params)
    collector = MeteorCollector(cfg.collector, rt, video_loader=None,
                                logger=logger, device=mesh.devices[0])
    _feed_collector(collector, packed.cpu().numpy(), 0, rt,
                    get_num_class(), max_peaks)
    collector.clear()
    return collector.met_exporter.meteor_list, t_total


def _feed_collector(collector, packed: np.ndarray, t_start: int, rt,
                    num_cls: int, max_peaks: int) -> None:
    """Run the host collector over one gathered packed buffer, with frame
    indices offset by ``t_start`` merged frames."""
    from ..detectors.m3det import NUM_LINES_TOOMUCH, _unpack
    from ..utils import lineset_nms

    lines_all, valid_all, extras = _unpack(packed, max_peaks)
    eq_int_fps = max(int(rt.eq_int_fps), 1)
    e = max(int(rt.exp_frame), 1)
    for j in range(packed.shape[0]):
        t = t_start + j
        fl = lines_all[j][valid_all[j]]
        if extras[j, 2] > 0.5 or len(fl) > NUM_LINES_TOOMUCH:
            fl = np.zeros((0, 4), int)
        if len(fl):
            nms_lines, nonline = lineset_nms(fl)
            cls_pred = np.zeros((len(nms_lines), num_cls))
            cls_pred[:, -1] = nonline
            cls_pred[:, 0] = 1 - nonline
            collector.update(t * e, nms_lines, cls_pred)
        elif t % eq_int_fps == 0:
            collector.update(t * e, np.zeros((0, 4), int),
                             np.zeros((0, num_cls)))


def detect_frames_temporal_streaming(block_iter, cfg, fps: float,
                                     mask: Optional[np.ndarray] = None,
                                     mesh: Optional[DeviceMesh] = None,
                                     axis_name: str = "time",
                                     super_block_frames: int = 512,
                                     max_points: int = 8192,
                                     max_peaks: int = 64, logger=None,
                                     rt_params=None, device: str = "cuda"):
    """Streaming complement to :func:`detect_frames_temporal`: merged
    frames super-block by super-block, with the state carried on the
    device between sharded steps, so host memory is bounded by one
    super-block instead of the whole clip.

    ``block_iter`` yields [T_i, H, W] uint8 merged-frame chunks of any
    size (e.g. BlockVideoLoader.pop_block). Chunks are re-batched into
    ``super_block_frames``-frame super-blocks (rounded down to a multiple
    of the mesh size); each runs the whole-clip step with the previous
    super-block's tails and EMA state as carries. Equal to the whole-clip
    sharded run. Returns (records, n_frames_used).
    """
    from ..log import BaseMetLog
    from ..track.collector import MeteorCollector
    from ..utils import get_num_class

    logger = logger or BaseMetLog()
    mesh = mesh if mesh is not None else build_mesh(axis_name=axis_name,
                                                    device=device)
    s = mesh.size
    super_block_frames = max(super_block_frames // s * s, s)

    collector = None
    carry = None
    processed = 0
    pending: list[np.ndarray] = []
    n_pending = 0
    done = False
    it = iter(block_iter)
    while not done:
        # accumulate one super-block (or the final remainder)
        while n_pending < super_block_frames:
            chunk = next(it, None)
            if chunk is None:
                done = True
                break
            pending.append(np.asarray(chunk))
            n_pending += pending[-1].shape[0]
        take = super_block_frames if n_pending >= super_block_frames \
            else n_pending // s * s
        if take == 0:
            break
        buf = np.concatenate(pending, axis=0) if len(pending) > 1 \
            else pending[0]
        frames, rest = buf[:take], buf[take:]
        pending = [rest] if rest.size else []
        n_pending = rest.shape[0] if rest.size else 0

        h, w = frames.shape[1:3]
        if collector is None:
            if mask is None:
                mask = np.ones((h, w), np.uint8)
            params = _m3_params(cfg, fps, mask)
            num_cls = get_num_class()
            rt = _runtime(fps, h, w, rt_params)
            collector = MeteorCollector(cfg.collector, rt,
                                        video_loader=None, logger=logger,
                                        device=mesh.devices[0])
        if not np.all(mask == 1):
            frames = frames * mask[None]

        packed, _dst, carry = temporal_m3_detect(
            frames, **params, max_points=max_points, max_peaks=max_peaks,
            mesh=mesh, carry=carry, return_carry=True)
        _feed_collector(collector, packed.cpu().numpy(), processed, rt,
                        num_cls, max_peaks)
        processed += take
    if collector is None:
        return [], 0
    collector.clear()
    return collector.met_exporter.meteor_list, processed
