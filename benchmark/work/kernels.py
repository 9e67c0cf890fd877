"""Bytes and operations of one launch of each of the M3 step's four CUDA
kernels, as functions of the launch's shape: each input byte read once and
each output byte written once, whatever a kernel reads again.

At 960x540, T = 64, n = 25 (the main path) they give 78.8 MB for
window_diff, 66 MB for median_binarize_close, 18.28 MB for hough_vote (8
frames of 8192 points, n_rho 3072) and 4.34 MB for walk_pick (8 frames, 64
peaks, S = 1024, with about 0.15 MB of plane bytes).
"""

from __future__ import annotations

from .peaks import least_seconds


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# the main path's launch shapes, given the analysed frame size: the block of
# 64 frames, the Hough's 8-frame chunks of 8192 point slots and 64 peaks
BLOCK_FRAMES = 64
CHUNK_FRAMES = 8
MAX_POINTS = 8192
MAX_PEAKS = 64


def window_diff(h: int, w: int, t: int = BLOCK_FRAMES, n: int = 25):
    """The n-1 history frames and t new ones read, t diff frames written;
    7 operations an output."""
    return (n - 1 + 2 * t) * h * w, 7 * t * h * w


def median_binarize_close(h: int, w: int, t: int = BLOCK_FRAMES):
    """One u8 frame read and one written; 14 operations a pixel."""
    return 2 * t * h * w, 14 * t * h * w


def n_rho(h: int, w: int) -> int:
    return _round_up(2 * (w + h) + 1, 128)


def hough_vote(h: int, w: int, t: int = CHUNK_FRAMES,
               points: int = MAX_POINTS, valid_points: int | None = None):
    """The point list read (x, y as f32 and a valid byte: 9 B a slot) and
    the [t, 180, n_rho] i32 votes written; 3 operations a valid point and
    theta (all slots when the valid count is not given)."""
    valid = t * points if valid_points is None else valid_points
    return t * points * 9 + t * 180 * n_rho(h, w) * 4, 3 * 180 * valid


def walk_side(h: int, w: int) -> int:
    return _round_up(max(h, w) + 1, 128)


def walk_pick(h: int, w: int, t: int = CHUNK_FRAMES, k: int = MAX_PEAKS,
              plane_bytes: int = 0):
    """r read and the picks written ([t, k, S] i32 each), xmaj read (a byte
    a row), and ``plane_bytes``, one plane byte a column in range, which
    depends on the data (0 where not known: the count is then a lower
    bound); no arithmetic."""
    s = walk_side(h, w)
    return 2 * t * k * s * 4 + t * k + plane_bytes, 0


# kernel name as the trace shows it -> (reckoning, launches a block of
# BLOCK_FRAMES frames)
KERNELS = {
    "window_diff": (window_diff, 1),
    "median_binarize_close": (median_binarize_close, 1),
    "hough_vote": (hough_vote, BLOCK_FRAMES // CHUNK_FRAMES),
    "walk_pick": (walk_pick, BLOCK_FRAMES // CHUNK_FRAMES),
}


def launch_least_seconds(name: str, h: int, w: int) -> float:
    """The least time of one launch of kernel ``name`` on an h x w frame."""
    fn, _ = KERNELS[name]
    return least_seconds(*fn(h, w))
