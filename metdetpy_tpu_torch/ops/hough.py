"""Deterministic, batched Hough line-segment extraction (PyTorch).

Counterpart of ``metdetpy_tpu/ops/hough.py`` (the replacement for
cv2.HoughLinesP, reference MetLib/Detector.py:282-287, :347-352):

1. **Compact** -- active pixels become a fixed-capacity point list by a
   prefix-sum compaction (``compact_indices``), with no host sync.
2. **Vote** -- per (point, theta) the rho bin is counted
   (``kernels.hough_vote``, a CUDA kernel on the card).
3. **Peak find** -- 3x3 local maxima above the threshold, with the
   crowd-guard ladder of the JAX package, compacted in (theta, rho) order
   (``kernels.peak_ladder`` tests and counts them on the card).
4. **Segment walk** -- each peak line is walked along its major axis over
   the bit-packed corner planes (``kernels.walk_pick`` picks one plane row
   per column), then the longest gap-tolerant run gives the segment
   (``walk_segments``: on the card the planes, the walk geometry and the
   run analysis are ``kernels.corner_planes``, ``walk_geom`` and
   ``walk_finish``).

The JAX package branches (``lax.cond``) on point and peak counts only for
speed; here every chunk is computed densely, which changes nothing but
the contents of INVALID line slots. Those are zeroed, so the result is
defined by ``valid``, ``lines[valid]``, ``npix`` and ``overflow``.

The f32 expressions of the walk reproduce the fused multiply-adds that
XLA's CPU backend forms (``f32.fma_f32``), measured against ``jnp``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .f32 import fma_f32, trig_tables
from .filters import dilate3x3

SCAN_ROW = 1024  # row length of compact_indices' two-level prefix sum
FRAME_CHUNK = 8  # frames compacted, voted and walked together


class HoughResult(NamedTuple):
    lines: torch.Tensor     # [T, K, 4] int32 (x1, y1, x2, y2)
    valid: torch.Tensor     # [T, K] bool
    npix: torch.Tensor      # [T] int32 active-pixel count per frame
    overflow: torch.Tensor  # [T] bool: active pixels exceeded capacity


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compact_indices(mask: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k nonzero entries of each row of [B, N].

    A prefix sum ranks every active element, and a binary search over the
    ranks finds the first element of each rank 1..k (the JAX package's
    search, ``_compact_indices``). The prefix sum runs in two levels
    (within rows of SCAN_ROW, then over the row totals): torch's scan over
    a few very long rows keeps the card mostly idle (measured 0.72 ms for
    [8, 518400] int32 on an H100). Of [B, N] only the mask's test, its
    padded i32 copy and the i32 ranks summed from it are made.
    Returns (idx [B, k] int64, -1 where invalid; valid [B, k] bool)."""
    b, n = mask.shape
    n_pad = _round_up(n, SCAN_ROW)
    act = torch.zeros((b, n_pad), dtype=torch.int32, device=mask.device)
    act[:, :n] = mask != 0
    rank = torch.cumsum(act.view(b, -1, SCAN_ROW), dim=2, dtype=torch.int32)
    del act
    row_tot = rank[:, :, -1]
    rank += (torch.cumsum(row_tot, dim=1, dtype=torch.int32)
             - row_tot)[:, :, None]
    rank = rank.view(b, n_pad)  # non-decreasing; the padding holds the total
    want = torch.arange(1, k + 1, dtype=torch.int32,
                        device=mask.device).expand(b, k).contiguous()
    idx = torch.searchsorted(rank, want)
    valid = want <= rank[:, -1:]
    return torch.where(valid, idx, -1), valid


_CUTS: dict = {}


def _peak_cuts(threshold: int, device: torch.device) -> torch.Tensor:
    """The crowd guard's static geometric ladder of vote cutoffs."""
    key = (threshold, str(device))
    if key not in _CUTS:
        cuts = np.unique(np.round(
            np.geomspace(threshold + 1, 8192, 24))).astype(np.int32)
        _CUTS[key] = torch.from_numpy(cuts).to(device)
    return _CUTS[key]


def find_peaks_plain(votes: torch.Tensor, threshold: int, max_peaks: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spec of ``find_peaks``, and its route off the card: the crowd
    guard's survivor counts as a [B, C, N] comparison and its sum."""
    b = votes.shape[0]
    is_peak = (votes >= dilate3x3(votes)) & (votes > threshold)
    cuts = _peak_cuts(threshold, votes.device)
    peak_votes = torch.where(is_peak, votes, -1).reshape(b, 1, -1)
    tails = (peak_votes >= cuts[None, :, None]).sum(dim=2)   # [B, C]
    return _ladder_pick(votes, is_peak, tails, cuts, max_peaks)


def _find_peaks_ladder(votes: torch.Tensor, threshold: int, max_peaks: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``find_peaks`` from ``kernels.peak_ladder``'s mask and rung counts:
    the survivors of cut c are the peaks of rungs c+1..C."""
    cuts = _peak_cuts(threshold, votes.device)
    is_peak, count = kernels.peak_ladder(votes, threshold, cuts)
    tails = torch.flip(torch.cumsum(torch.flip(count[:, 1:], [1]), dim=1),
                       [1])                                  # [B, C]
    return _ladder_pick(votes, is_peak.view(torch.bool).view(votes.shape),
                        tails, cuts, max_peaks)


def _ladder_pick(votes: torch.Tensor, is_peak: torch.Tensor,
                 tails: torch.Tensor, cuts: torch.Tensor, max_peaks: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lowest rung whose survivors fit (the last if none does), its
    survivors compacted in (theta, rho) order."""
    b, _, n_rho = votes.shape
    fits = tails <= max_peaks
    ci = torch.where(fits.any(dim=1),
                     torch.argmax(fits.to(torch.int32), dim=1),
                     len(cuts) - 1)
    is_peak = is_peak & (votes >= cuts[ci][:, None, None])
    idx, ok = compact_indices(is_peak.reshape(b, -1), max_peaks)
    idx = torch.where(ok, idx, 0)
    return idx // n_rho, idx % n_rho, ok


def find_peaks(votes: torch.Tensor, threshold: int, max_peaks: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3x3 local maxima above threshold over [B, n_theta, n_rho] votes.

    Crowd guard (``metdetpy_tpu/ops/hough.py`` ``_find_peaks``): when more
    than max_peaks peaks survive, the vote cutoff rises to the lowest rung
    of a static geometric ladder whose survivor count fits (the last rung
    if none does). On the card ``kernels.peak_ladder`` tests every bin and
    counts the peaks by rung in one pass; elsewhere ``find_peaks_plain``.
    Returns (theta_idx, rho_idx, ok), each [B, max_peaks].
    """
    if votes.device.type == "cuda":
        return _find_peaks_ladder(votes, threshold, max_peaks)
    return find_peaks_plain(votes, threshold, max_peaks)


def pack_corners(img01: torch.Tensor) -> torch.Tensor:
    """Bit-pack each unit cell's 4 corner pixels into one uint8 plane:
    ``pk[y0+1, x0+1] = img[y0,x0] | img[y0,x0+1]<<1 | img[y0+1,x0]<<2 |
    img[y0+1,x0+1]<<3`` with out-of-frame corners 0. [..., H, W] 0/1 uint8
    -> [..., H+1, W+1] uint8."""
    shape = list(img01.shape)
    shape[-2] += 2
    shape[-1] += 2
    ip = torch.zeros(shape, dtype=torch.uint8, device=img01.device)
    ip[..., 1:-1, 1:-1] = img01
    return (ip[..., :-1, :-1] + 2 * ip[..., :-1, 1:]
            + 4 * ip[..., 1:, :-1] + 8 * ip[..., 1:, 1:])


class WalkGeom(NamedTuple):
    """Per-peak walk geometry shared by the pick and finish stages."""
    t: torch.Tensor      # [B, K, S] f32 integer-valued walk step per column
    fx_: torch.Tensor    # [B, K, S] f32 bilinear x fraction
    fy_: torch.Tensor    # [B, K, S] f32 bilinear y fraction
    inp: torch.Tensor    # [B, K, S] bool in-image & in-walk-range
    xmaj: torch.Tensor   # [B, K] bool walk is x-major
    r: torch.Tensor      # [B, K, S] i32 plane row per column
    px: torch.Tensor     # [B, K] f32 walk center
    py: torch.Tensor
    vx: torch.Tensor     # [B, K] f32 unit L-inf direction
    vy: torch.Tensor
    dirn: torch.Tensor   # [B, K] f32 major-axis direction (exactly +-1)


def walk_geom(theta_idx: torch.Tensor, rho_idx: torch.Tensor,
              rho_offset: int, n_steps: int, h: int, w: int,
              s_dim: int) -> WalkGeom:
    """Column-indexed walk geometry of each peak line.

    The L-inf walk steps the major axis by exactly +-1, so step index and
    major-axis pixel column are a bijection: column u holds the sample at
    walk step t = (u - 1 - floor(a)) * dirn.

    The walk center reproduces XLA's CPU contractions of ``proj = (cx -
    fx)*(-s) + (cy - fy)*c`` and ``p = f + proj*v``; XLA forms px and py
    in separate fusions that contract ``cx - c*rho`` / ``cy - s*rho``
    differently, and both forms are kept as measured.
    """
    cos_t, sin_t = trig_tables(theta_idx.device)
    c, s = cos_t[theta_idx], sin_t[theta_idx]            # [B, K]
    rho = rho_idx.to(torch.float32) - float(rho_offset)
    vx, vy = -s, c
    m = torch.maximum(vx.abs(), vy.abs())
    vx, vy = vx / m, vy / m                              # major == +-1
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    fx, fy = c * rho, s * rho                     # foot of perpendicular
    proj_x = fma_f32(fma_f32(-s, rho, cy), c, (cx - fx) * (-s))
    proj_y = fma_f32(cy - fy, c, fma_f32(-c, rho, cx) * (-s))
    px = fma_f32(proj_x, -s, fx)
    py = fma_f32(proj_y, c, fy)

    xmaj = s.abs() >= c.abs()
    a = torch.where(xmaj, px, py)                        # major-axis base
    dirn = torch.where(xmaj, vx, vy)                     # exactly +-1
    u = torch.arange(s_dim, dtype=torch.float32, device=theta_idx.device)
    t = (u - 1.0 - torch.floor(a)[..., None]) * dirn[..., None]
    x = fma_f32(t, vx[..., None], px[..., None])
    y = fma_f32(t, vy[..., None], py[..., None])
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx_, fy_ = x - x0, y - y0
    xi = x0.to(torch.int32) + 1
    yi = y0.to(torch.int32) + 1
    inp = ((xi >= 0) & (xi <= w) & (yi >= 0) & (yi <= h)
           & (t >= -(n_steps / 2.0)) & (t < n_steps / 2.0))
    r = torch.where(xmaj[..., None], yi, xi)
    return WalkGeom(t, fx_, fy_, inp, xmaj, r, px, py, vx, vy, dirn)


def finish_segments(v: torch.Tensor, g: WalkGeom, peak_ok: torch.Tensor,
                    min_len: int, max_gap: torch.Tensor, h: int, w: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear acceptance + run analysis + endpoints from picked corners.

    v: [B, K, S] int32 picked corner bits; max_gap: [B] f32.
    Returns (lines [B, K, 4] int32, ok [B, K] bool)."""
    s_dim = v.shape[-1]
    v = v * g.inp
    xmaj = g.xmaj[..., None]
    # bilinear corner weights; the transposed plane (y-major) has bits 1
    # and 2 swapped, so swap their weight masks there
    wx0, wx1 = 1 - g.fx_, g.fx_
    wy0, wy1 = 1 - g.fy_, g.fy_
    w1 = torch.where(xmaj, wx1 * wy0, wx0 * wy1)
    w2 = torch.where(xmaj, wx0 * wy1, wx1 * wy0)
    p = ((v & 1) * (wx0 * wy0 > 0.05)
         | ((v >> 1) & 1) * (w1 > 0.05)
         | ((v >> 2) & 1) * (w2 > 0.05)
         | ((v >> 3) & 1) * (wx1 * wy1 > 0.05))
    p = p * peak_ok[..., None]

    # put samples in walk order (ascending t) so the run analysis and its
    # argmax tie-breaking (first index) follow the walk
    neg_dir = (g.dirn < 0)[..., None]
    p = torch.where(neg_dir, torch.flip(p, dims=[-1]), p)
    t_seq = torch.where(neg_dir, torch.flip(g.t, dims=[-1]), g.t)

    steps = torch.arange(s_dim, dtype=torch.int32, device=v.device)
    neg = -(10 ** 6)
    on = p == 1
    prev_inc = torch.cummax(torch.where(on, steps, neg), dim=-1).values
    prev_exc = torch.cat(
        [torch.full_like(prev_inc[..., :1], neg), prev_inc[..., :-1]],
        dim=-1)
    gap = (steps - prev_exc - 1).to(torch.float32)
    new_run = on & (gap > max_gap[:, None, None])
    run_start = torch.cummax(torch.where(new_run, steps, neg),
                             dim=-1).values
    length = torch.where(on, steps - run_start, -1)
    best = torch.argmax(length, dim=-1, keepdim=True)
    best_len = torch.gather(length, -1, best)[..., 0]
    start = torch.gather(run_start, -1, best)

    def endpoint(idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        tt = torch.gather(t_seq, -1, idx.clamp(0, s_dim - 1).long())[..., 0]
        ex = torch.round(fma_f32(tt, g.vx, g.px)).to(torch.int32)
        ey = torch.round(fma_f32(tt, g.vy, g.py)).to(torch.int32)
        return ex.clamp(0, w - 1), ey.clamp(0, h - 1)

    x1, y1 = endpoint(start)
    x2, y2 = endpoint(best)
    lines = torch.stack([x1, y1, x2, y2], dim=-1)
    ok = peak_ok & (best_len >= min_len)
    return lines, ok


def corner_planes(imgs: torch.Tensor, s_dim: int) -> torch.Tensor:
    """[B, 2, S, S] uint8: pack_corners(img) (x-major walks, rows=y) and
    pack_corners(img.T) (y-major walks, rows=x), zero-padded to S."""
    b, h, w = imgs.shape
    planes = torch.zeros((b, 2, s_dim, s_dim), dtype=torch.uint8,
                         device=imgs.device)
    planes[:, 0, :h + 1, :w + 1] = pack_corners(imgs)
    planes[:, 1, :w + 1, :h + 1] = pack_corners(imgs.transpose(1, 2))
    return planes


def walk_segments_plain(imgs01: torch.Tensor, theta_idx: torch.Tensor,
                        rho_idx: torch.Tensor, peak_ok: torch.Tensor,
                        gaps: torch.Tensor, *, rho_offset: int, n_steps: int,
                        s_dim: int, min_len: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spec of ``walk_segments``, and its route off the card:
    ``corner_planes``, ``walk_geom``, ``kernels.walk_pick`` and
    ``finish_segments``, the lines zeroed where not ok."""
    _, h, w = imgs01.shape
    planes = corner_planes(imgs01, s_dim)
    geom = walk_geom(theta_idx, rho_idx, rho_offset, n_steps, h, w, s_dim)
    v = kernels.walk_pick(planes, geom.r.contiguous(), geom.xmaj)
    lines, ok = finish_segments(v, geom, peak_ok, min_len, gaps, h, w)
    return torch.where(ok[..., None], lines, 0), ok


def walk_segments(imgs01: torch.Tensor, theta_idx: torch.Tensor,
                  rho_idx: torch.Tensor, peak_ok: torch.Tensor,
                  gaps: torch.Tensor, *, rho_offset: int, n_steps: int,
                  s_dim: int, min_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The segment walk of a chunk's [B, K] peaks over its [B, H, W] 0/1
    u8 frames, with each frame's max_gap ``gaps`` ([B] f32): (lines
    [B, K, 4] int32, 0 where not ok; ok [B, K] bool).

    On the card four launches: ``kernels.corner_planes``, ``walk_geom``,
    ``walk_pick`` and ``walk_finish``; elsewhere ``walk_segments_plain``.
    """
    if imgs01.device.type != "cuda":
        return walk_segments_plain(
            imgs01, theta_idx, rho_idx, peak_ok, gaps, rho_offset=rho_offset,
            n_steps=n_steps, s_dim=s_dim, min_len=min_len)
    _, h, w = imgs01.shape
    planes = kernels.corner_planes(imgs01, s_dim)
    r, xmaj = kernels.walk_geom(theta_idx, rho_idx, rho_offset, n_steps, h,
                                w, s_dim)
    v = kernels.walk_pick(planes, r, xmaj)
    return kernels.walk_finish(v, theta_idx, rho_idx, peak_ok, gaps,
                               rho_offset, n_steps, h, w, min_len)


def hough_lines_batch(dst: torch.Tensor, max_gap: torch.Tensor, *,
                      threshold: int, min_len: int, max_points: int = 8192,
                      max_peaks: int = 64) -> HoughResult:
    """Batched probabilistic-Hough-equivalent line extraction.

    Args:
      dst: [T, H, W] uint8 binary images (0 / 255).
      max_gap: [T] float32 per-frame maximum bridged gap.
      threshold: accumulator vote threshold (votes must be > threshold).
      min_len: minimum L-inf segment length (OpenCV semantics).
      max_points: fixed active-pixel capacity per frame; frames with more
        active pixels are dropped (``overflow``).
      max_peaks: max peak lines (and hence segments) per frame.

    Returns:
      HoughResult with [T, max_peaks, 4] segments; invalid slots are 0.
    """
    t_block, h, w = dst.shape
    n_rho = _round_up(2 * (w + h) + 1, 128)
    rho_offset = w + h  # OpenCV numrho centering (hough.cpp semantics)
    n_steps = _round_up(max(h, w) + 4, 128)
    s_dim = _round_up(max(h, w) + 1, 128)
    dst01 = (dst > 0).to(torch.uint8)
    fc = FRAME_CHUNK
    while t_block % fc != 0:
        fc //= 2

    out_lines, out_valid, out_npix, out_over = [], [], [], []
    for a in range(0, t_block, fc):
        imgs = dst01[a:a + fc]
        gaps = max_gap[a:a + fc]
        flats = imgs.reshape(fc, -1)
        npix = flats.sum(dim=1, dtype=torch.int32)
        overflow = npix > max_points
        # frames past the point capacity are dropped by contract: zero
        # their pixels so they compact to nothing
        flats = flats * (~overflow)[:, None]
        idx, valid = compact_indices(flats, max_points)
        idx = torch.where(valid, idx, 0)
        ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
        xs = (idx % w).to(torch.float32)
        votes = kernels.hough_vote(xs, ys, valid, n_rho, rho_offset)
        th_i, rh_i, pok = find_peaks(votes, threshold, max_peaks)
        pok = pok & ~overflow[:, None] & (npix > 0)[:, None]
        lines, ok = walk_segments(imgs, th_i, rh_i, pok, gaps,
                                  rho_offset=rho_offset, n_steps=n_steps,
                                  s_dim=s_dim, min_len=min_len)
        out_lines.append(lines)
        out_valid.append(ok)
        out_npix.append(npix)
        out_over.append(overflow)
    return HoughResult(torch.cat(out_lines), torch.cat(out_valid),
                       torch.cat(out_npix), torch.cat(out_over))


def hough_lines_single(dst: torch.Tensor, max_gap: float, *, threshold: int,
                       min_len: int, **kw) -> HoughResult:
    """Single-image convenience wrapper: [H, W] -> a HoughResult of one
    frame."""
    return hough_lines_batch(
        dst[None], torch.tensor([max_gap], dtype=torch.float32,
                                device=dst.device),
        threshold=threshold, min_len=min_len, **kw)
