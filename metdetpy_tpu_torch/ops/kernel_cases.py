"""Ragged inputs that hold ``hough_vote`` and ``walk_pick`` against their
plain versions: odd sizes, empty and degenerate point lists, the largest
n_rho, rows outside the plane and storage that is not 16-byte aligned;
and the stream axis of ``window_diff``: one or several streams, blocks
shorter than the history, per-stream timers, and histories that are views
of the previous block's frames (streams T frames apart, not n-1).

``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` run the same lists
on a card; the inputs are made from a seed with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import MAX_VOTE_RHO

# (id, T, n, n_rho, fill, offset): fill is how the points are made --
# "prefix" (a different count of valid points per frame, none and all
# among them), "scattered" (valid points anywhere in the list), "invalid"
# (none valid), "equal" (every point the same, so one bin per theta takes
# every vote); the tensors start ``offset`` bytes into their storage.
VOTE_CASES = [
    ("n1", 3, 1, 3072, "prefix", 0),
    ("n100", 3, 100, 3072, "prefix", 0),
    ("n8191", 2, 8191, 3072, "prefix", 0),
    ("n32768", 2, 32768, 3072, "prefix", 0),
    ("n65536", 2, 65536, 3072, "prefix", 0),   # ClassicDetector's budget
    ("scattered", 3, 4096, 3072, "scattered", 0),
    ("invalid", 3, 512, 3072, "invalid", 0),
    ("equal", 2, 4096, 3072, "equal", 0),
    ("rho128", 3, 512, 128, "prefix", 0),
    ("rho3071", 2, 512, 3071, "prefix", 0),
    ("rho_max", 2, 2048, MAX_VOTE_RHO, "prefix", 0),
    ("t1", 1, 8192, 3072, "prefix", 0),
    ("t64", 64, 1024, 3072, "prefix", 0),
    ("offset4", 3, 8192, 3072, "prefix", 4),
]

# (id, T, K, S, fill, offset): fill "random" draws rows from [-S/4, 5S/4),
# "negative" and "beyond" put every row outside the plane.
PICK_CASES = [
    ("k1", 3, 1, 1024, "random", 0),
    ("k20", 3, 20, 1024, "random", 0),
    ("k64_s128", 3, 64, 128, "random", 0),
    ("s200", 2, 5, 200, "random", 0),
    ("t1", 1, 64, 1024, "random", 0),
    ("t64", 64, 20, 1024, "random", 0),
    ("negative", 2, 20, 1024, "negative", 0),
    ("beyond", 2, 20, 1024, "beyond", 0),
    ("offset4", 3, 20, 1024, "random", 4),
]


# (id, S, T, n, h, w, timer0, timer_step, history): history "own" is a
# contiguous [S, n-1, H, W] tensor, "view" the last n-1 frames of each
# stream of a longer previous block (as the detectors carry it).
WINDOW_DIFF_STREAM_CASES = [
    ("s1", 1, 64, 25, 540, 960, 0, 0, "own"),
    ("s3_short", 3, 16, 25, 37, 150, 5, 0, "own"),
    ("s3_view", 3, 64, 25, 37, 960, 10, 0, "view"),
    ("s2_view_ragged", 2, 10, 4, 3, 5, 0, 0, "view"),
    ("s4_steps", 4, 12, 9, 21, 40, 0, 12, "own"),
    ("s3_steps_view", 3, 30, 25, 37, 160, 3, 7, "view"),
    ("s3_n1", 3, 8, 1, 37, 150, 0, 0, "own"),
]


def window_diff_stream_case(case, dev, seed: int):
    """(history, frames, n, timer0, timer_step) of one of
    WINDOW_DIFF_STREAM_CASES."""
    _, s, t, n, h, w, timer0, step, hist = case
    rng = np.random.default_rng([seed, s, t, n, h, w])
    frames = rng.integers(0, 256, (s, t, h, w), dtype=np.uint8)
    if hist == "view":
        prev = torch.from_numpy(rng.integers(
            0, 256, (s, n - 1 + 7, h, w), dtype=np.uint8)).to(dev)
        history = prev[:, 7:]
    else:
        history = torch.from_numpy(rng.integers(
            0, 256, (s, n - 1, h, w), dtype=np.uint8)).to(dev)
    return history, torch.from_numpy(frames).to(dev), n, timer0, step


def _place(a: np.ndarray, dev, offset: int) -> torch.Tensor:
    """A contiguous tensor on ``dev`` holding ``a``, starting ``offset``
    bytes (a multiple of the item size) into its storage."""
    raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    flat = torch.empty(raw.size + offset, dtype=torch.uint8, device=dev)
    flat[offset:].copy_(torch.from_numpy(raw))
    dtype = torch.from_numpy(a[:0].reshape(-1)).dtype
    return flat[offset:].view(dtype).view(a.shape)


def vote_case(case, dev, seed: int):
    """(xs, ys, valid, n_rho, rho_offset) of one of VOTE_CASES."""
    _, t, n, n_rho, fill, offset = case
    rng = np.random.default_rng([seed, t, n, n_rho])
    w, h = 960, 540
    xs = rng.integers(0, w, (t, n)).astype(np.float32)
    ys = rng.integers(0, h, (t, n)).astype(np.float32)
    counts = rng.integers(0, n + 1, t)
    counts[0], counts[-1] = n, 0 if t > 1 else n
    valid = np.arange(n)[None, :] < counts[:, None]
    if fill == "scattered":
        valid = rng.random((t, n)) < 0.3
    elif fill == "invalid":
        valid[:] = False
    elif fill == "equal":
        xs[:], ys[:], valid[:] = 417.0, 233.0, True
    return (_place(xs, dev, offset), _place(ys, dev, offset),
            _place(valid, dev, offset), n_rho, w + h)


def pick_case(case, dev, seed: int):
    """(planes, r, xmaj) of one of PICK_CASES."""
    _, t, k, s, fill, offset = case
    rng = np.random.default_rng([seed, t, k, s])
    planes = rng.integers(0, 16, (t, 2, s, s), dtype=np.uint8)
    lo, hi = {"random": (-(s // 4), s + s // 4), "negative": (-s, 0),
              "beyond": (s, 3 * s)}[fill]
    r = rng.integers(lo, hi, (t, k, s)).astype(np.int32)
    xmaj = rng.random((t, k)) < 0.5
    return (_place(planes, dev, 0), _place(r, dev, offset),
            _place(xmaj, dev, 0))
