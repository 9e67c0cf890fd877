"""Ragged inputs that hold ``hough_vote``, ``walk_pick`` and ``peak_ladder``
against their plain versions: odd sizes, empty and degenerate point lists,
the largest n_rho, rows outside the plane, crafted vote planes (ties,
borders, the crowd guard's edges) and storage that is not 16-byte aligned;
and the stream axis of ``window_diff``: one or several streams, blocks
shorter than the history, per-stream timers, and histories that are views
of the previous block's frames (streams T frames apart, not n-1).

``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` run the same lists
on a card; the inputs are made from a seed with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .hough import _peak_cuts
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

# the crowd guard's threshold and peak budget on the peak cases (the
# profile's dense chunk and the main path's max_peaks)
PEAK_THRESHOLD = 10
PEAK_MAX = 64
# crafted planes: ties between neighbours; peaks on every border and
# corner; exactly PEAK_MAX and PEAK_MAX + 1 isolated peaks; votes equal to
# each cut and beside it; more than PEAK_MAX peaks on the last rung; no peak
PEAK_KINDS = ("plateau", "borders", "peaks64", "peaks65", "at_cuts",
              "last_rung", "none")
# (id, T, n_rho, fill, offset): fill a kind of PEAK_KINDS (every frame that
# kind) or "random" (each frame its own noise level and spikes over every
# rung); the votes start ``offset`` bytes into their storage (n_rho % 4 != 0
# and the offset take the kernel's one-column path).
PEAK_CASES = [
    *[(kind, 2, 3072, kind, 0) for kind in PEAK_KINDS],
    ("random", 8, 3072, "random", 0),
    ("t1", 1, 3072, "random", 0),
    ("t64", 64, 3072, "random", 0),
    ("rho128", 3, 128, "random", 0),
    ("rho3071", 2, 3071, "random", 0),
    ("rho_max", 2, MAX_VOTE_RHO, "random", 0),
    ("offset4", 3, 3072, "random", 4),
]


def _isolated(rng, n: int, n_theta: int, n_rho: int):
    """n distinct bins of a lattice 3 apart, so no two share a window."""
    lattice = [(th, rh) for th in range(1, n_theta - 1, 3)
               for rh in range(1, n_rho - 1, 3)]
    pick = rng.choice(len(lattice), n, replace=False)
    return tuple(np.array([lattice[i] for i in pick]).T)


def peak_plane(kind: str, n_theta: int, n_rho: int, rng) -> np.ndarray:
    """A [n_theta, n_rho] i32 vote plane of one of PEAK_KINDS or
    "random", for PEAK_THRESHOLD and PEAK_MAX; n_rho >= 64 (crafted)."""
    cuts = _peak_cuts(PEAK_THRESHOLD, "cpu").numpy()
    v = np.zeros((n_theta, n_rho), np.int32)
    mid_t, mid_r = n_theta // 2, n_rho // 2
    if kind == "random":
        v[:] = rng.integers(0, rng.choice([5, 15, 40, 200]), v.shape)
        n_spikes = int(rng.integers(0, 300))
        v[rng.integers(0, n_theta, n_spikes),
          rng.integers(0, n_rho, n_spikes)] = rng.integers(
              PEAK_THRESHOLD + 1, 10_000, n_spikes)
    elif kind == "plateau":
        v[10:12, 10:12] = 50                    # a 2x2 plateau: four peaks
        v[40, 20:23] = 30                       # a row of three
        v[60, 40:42] = 77                       # two equal neighbours
        v[100:103, 50:53] = 20                  # 3x3, all nine peaks
        v[120, 30], v[121, 31] = 40, 41         # a higher neighbour
        v[140, 5:8] = PEAK_THRESHOLD            # a plateau at the threshold
        v[150, 60], v[151, 60] = PEAK_THRESHOLD + 1, PEAK_THRESHOLD + 1
    elif kind == "borders":
        for th in (0, mid_t, n_theta - 1):
            for rh in (0, mid_r, n_rho - 1):
                v[th, rh] = 100 + th + rh
        v[0, 3:6] = 60                          # a plateau on the top edge
        v[mid_t + 3, n_rho - 2:] = 70           # and one at the right edge
    elif kind in ("peaks64", "peaks65"):
        n = PEAK_MAX + (kind == "peaks65")
        v[_isolated(rng, n, n_theta, n_rho)] = rng.integers(
            PEAK_THRESHOLD + 1, 9_000, n)
    elif kind == "at_cuts":
        votes = np.concatenate([cuts - 1, cuts, cuts + 1])
        v[_isolated(rng, len(votes), n_theta, n_rho)] = votes
    elif kind == "last_rung":
        n = PEAK_MAX + 6
        v[_isolated(rng, n + 20, n_theta, n_rho)] = np.concatenate(
            [rng.integers(cuts[-1], cuts[-1] + 900, n),
             rng.integers(PEAK_THRESHOLD + 1, cuts[-1], 20)])
    elif kind == "none":
        v[:] = rng.integers(0, PEAK_THRESHOLD + 1, v.shape)
    else:
        raise ValueError(f"unknown peak plane {kind!r}")
    return v


def peak_case(case, dev, seed: int):
    """(votes, threshold, cuts) of one of PEAK_CASES."""
    _, t, n_rho, fill, offset = case
    rng = np.random.default_rng([seed, t, n_rho, offset])
    votes = np.stack([peak_plane(fill, 180, n_rho, rng) for _ in range(t)])
    return (_place(votes, dev, offset), PEAK_THRESHOLD,
            _peak_cuts(PEAK_THRESHOLD, dev))


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
