"""The least time of the M3 block step's work, reckoned from the frame
shapes and the points the reference binarized, never from the program's
list of kernels: so it reads the same work whatever implements it.

Bytes: each block's frames and carries read once and its per-frame outputs
written once. Operations: the Hough vote of the block's binarized points,
3 float operations a point and theta.
"""

from __future__ import annotations

from .peaks import least_seconds

PACKED_WORDS_PER_FRAME = 64 * 5 + 6  # 64 line slots and 6 extras, i32


def block_bytes(h: int, w: int, t: int, n: int) -> int:
    """Frames in, the two [n-1, H, W] u8 histories (gray and dynamic mask)
    read and written, the packed lines out; the sub-ROI history and the EMA
    state are left out, so the count is a lower bound."""
    frames = t * h * w
    carries = 2 * (n - 1) * h * w
    return frames + 2 * carries + t * PACKED_WORDS_PER_FRAME * 4


def least_seconds_clip(h: int, w: int, frames: int, n: int,
                       vote_points: int, t: int = 64) -> float:
    """The least time of the step over a clip of ``frames`` analysed frames
    (whole blocks of t) whose binarized points number ``vote_points``."""
    blocks = -(-frames // t)
    return least_seconds(blocks * block_bytes(h, w, t, n),
                         3 * 180 * vote_points)
