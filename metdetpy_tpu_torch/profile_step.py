"""Stage profiles of the M3 block step: where one block's time goes, as the
card's own device time, on a quiet and on an active sky.

    python -m metdetpy_tpu_torch.profile_step {block,dense,split}
        [--device cuda|cpu] [--h 540 --w 960 --t 64] [--quick]

Counterpart of the JAX side's ``tools/profile_block.py`` (``block``: the
quiet-sky step and four of its stages), ``tools/profile_dense.py``
(``dense``: ``hough_lines_batch`` on a clustered-salt binarized block and
its stages: compaction, vote, peak find, segment walk) and
``tools/profile_worstcase_split.py`` (``split``: the active-sky step
against ``chain_only``, everything of the step before the Hough stage),
at the same inputs, under the JAX tools' labels. Each stage prints one
JSON line, beside the card's name and power limit (``"device"``):

- ``slope_ms``: the JAX tools' own reading, the slope of chains of calls
  (their counts and repetitions) each ended by one ``.item()``. A chain
  reads whichever is slower, the host's enqueue or the device. The
  ``step`` stages chain the detector's own dispatch, one replay of the
  step's CUDA graph a block on a card (``detectors.step_graph``); the
  other stages chain eager calls, whose enqueue of many small launches
  may be the slower.
- ``device_ms``: device time of one call, the sum of its kernels' (and
  device copies') time as ``torch.profiler`` records them over
  ``device_calls`` eager calls. It does not depend on the host's pace.
- ``graph_ms``: the stage captured once in a ``torch.cuda.CUDAGraph``
  after two eager warm-ups, then replayed between CUDA events behind a
  device sleep, each replay after a device copy of the next of 4-5 input
  blocks into the graph's static input (the copies timed alone and taken
  off). The replayed outputs must equal the eager calls' bit for bit. The
  step's stages take fixed carries (a copy of the detector's, timer
  included), so every call and replay computes the same block phase: the
  line states its ``timer0`` and the frames whose EMA updates.
- ``launches``: device records (kernels, copies, fills) of one eager call,
  from the profiler; ``kernel_launches`` the five CUDA kernels' own.

Derived lines: ``rest`` (``block``: the step less its four timed stages)
and ``hough`` (``split``: the step less ``chain_only``). On ``--device
cpu`` only ``slope_ms`` is taken (the CPU's time); the device readings are
``null`` and the line says "not measured". ``cuda``, the default, raises
without a card. A capture that fails raises with the stage and the
failing operation named; nothing falls back to eager numbers. ``--quick``
cuts the counts (the smoke test runs it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import bench, resolve_device
from .detectors import m3det
from .ops import hough, kernels, windows

TOOLS = ("block", "dense", "split")
# the JAX tools' slope counts and repetitions
SLOPES = {"block": ((8, 72), 3), "dense": ((4, 36), 4),
          "split": ((16, 128), 3)}
QUICK_SLOPE = ((2, 6), 1)
PROFILED_CALLS, QUICK_PROFILED_CALLS = 8, 2
GRAPH_ROUNDS, QUICK_GRAPH_ROUNDS = 5, 1
PAD_KERNELS = 64
PAD_CYCLES = 20_000  # ~10 us of device clock a pad
WINDOW_WAIT_S = 0.02  # host wait after a window opens and before it closes
SLEEP_CYCLES = 100_000_000  # ~0.06 s of device clock: the host runs ahead
# the dense tool's Hough settings (profile_dense.py)
DENSE_THRESHOLD, DENSE_MIN_LEN, DENSE_GAP = 10, 10, 10.0
NOT_MEASURED = "device_ms, graph_ms and launches not measured: no card"
GRAPH_NOTE = ("the stage's carries are fixed (timer0 and the EMA state "
              "included), so each replay computes the same block phase "
              "(timer0 and the EMA's update frames)")


@dataclasses.dataclass
class Stage:
    """One timed stage: ``fn(*args)`` on device tensors returns device
    tensors. ``inputs`` holds 4-5 argument tuples, which differ in the
    rotated input tensors only. ``chain(i)`` is the slope's i-th call
    (default: ``fn`` on the inputs in turn)."""
    name: str
    label: str
    fn: Callable
    inputs: list
    chain: Optional[Callable] = None
    info: dict = dataclasses.field(default_factory=dict)


# -- inputs ------------------------------------------------------------------

def quiet_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Quiet-sky noise, uniform in [0, 24) (``profile_block.py:34``)."""
    return np.random.default_rng(seed).integers(0, 24, (n, h, w), np.uint8)


def dense_dst(t: int, h: int, w: int, n_blobs: int = 680,
              seed: int = 7) -> np.ndarray:
    """A binarized block fed straight to the Hough stage
    (``profile_dense.py:27-38``): ``n_blobs`` 3x3 blobs of 255 a frame,
    about 9 active pixels each."""
    rng = np.random.default_rng(seed)
    dst = np.zeros((t, h, w), np.uint8)
    ys = rng.integers(1, h - 1, (t, n_blobs))
    xs = rng.integers(1, w - 1, (t, n_blobs))
    for i in range(t):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                dst[i, ys[i] + dy, xs[i] + dx] = 255
    return dst


def _blocks(frames: np.ndarray, t: int, dev: torch.device) -> list:
    return [torch.from_numpy(np.ascontiguousarray(
        frames[i * t:(i + 1) * t])).to(dev)
        for i in range(frames.shape[0] // t)]


# -- the step's parts, composed from the port's own functions ----------------

def chain_only(gray_hist, sub_hist, dy_hist, ema_state, frames, timer0, *,
               n, roi, dy_mask, mask_area, std_interval, momentum,
               warmup_speed, adaptive, coef_a, coef_b, sharded_fold=False,
               **_hough_kwargs):
    """Everything of ``m3det._m3_block_step`` before ``hough_lines_batch``
    (``profile_worstcase_split.py:74-98``), in the step's order: window
    diff, sub-ROI noise std, EMA scan, median/binarize/close, dynamic mask
    and diff area. Takes the step's arguments (its Hough keywords are
    ignored). Returns (diff area, dst, new gray, sub and dy histories, new
    EMA state), each equal to the step's own."""
    r1, c1, r2, c2 = roi
    diff, new_gray = kernels.window_diff(gray_hist, frames, n, timer0)
    stds, new_sub = windows.window_noise_std(
        sub_hist, frames[..., r1:r2, c1:c2], n, timer0)
    thr, _, _, new_ema = m3det._ema_threshold_scan(
        stds, timer0, ema_state, n=n, std_interval=std_interval,
        momentum=momentum, warmup_speed=warmup_speed, adaptive=adaptive,
        coef_a=coef_a, coef_b=coef_b)
    closed = m3det.median_binarize_close_blocks(diff, thr)
    dst, _, dst_sum, new_dy = m3det._dst_and_area(
        closed, dy_hist, timer0, 0, n=n, dy_mask=dy_mask,
        mask_area=mask_area, sharded_fold=sharded_fold)
    return dst_sum, dst, new_gray, new_sub, new_dy, new_ema


def _hough_sizes(h: int, w: int) -> tuple[int, int, int, int]:
    """(n_rho, rho_offset, n_steps, s_dim) as hough_lines_batch sets them."""
    r = hough._round_up
    return r(2 * (w + h) + 1, 128), w + h, r(max(h, w) + 4, 128), \
        r(max(h, w) + 1, 128)


def points_of(idx: torch.Tensor, valid: torch.Tensor, w: int):
    """(xs, ys) f32 of compacted flat indices, 0 where invalid."""
    idx = torch.where(valid, idx, 0)
    return ((idx % w).to(torch.float32),
            torch.div(idx, w, rounding_mode="floor").to(torch.float32))


def walk_chunks(imgs01, theta_idx, rho_idx, peak_ok, gaps, *, min_len):
    """The segment walk of every frame's peaks, in hough_lines_batch's
    frame chunks: corner planes, walk geometry, ``kernels.walk_pick`` and
    ``finish_segments``. Returns (lines, ok)."""
    t, h, w = imgs01.shape
    _, off, n_steps, s_dim = _hough_sizes(h, w)
    fc = hough.FRAME_CHUNK
    while t % fc != 0:
        fc //= 2
    lines, oks = [], []
    for a in range(0, t, fc):
        sl = slice(a, a + fc)
        planes = hough.corner_planes(imgs01[sl], s_dim)
        geom = hough.walk_geom(theta_idx[sl], rho_idx[sl], off, n_steps, h,
                               w, s_dim)
        v = kernels.walk_pick(planes, geom.r.contiguous(), geom.xmaj)
        seg, ok = hough.finish_segments(v, geom, peak_ok[sl], min_len,
                                        gaps[sl], h, w)
        lines.append(seg)
        oks.append(ok)
    return torch.cat(lines), torch.cat(oks)


def hough_by_stages(dst, max_gap, *, threshold, min_len, max_points=8192,
                    max_peaks=64) -> hough.HoughResult:
    """``hough_lines_batch`` as the dense tool splits it: compaction, vote
    and peak find over the whole block at once, then the walk in frame
    chunks. Equal to ``hough_lines_batch``."""
    t, h, w = dst.shape
    n_rho, off, _, _ = _hough_sizes(h, w)
    imgs01 = (dst > 0).to(torch.uint8)
    flat = imgs01.reshape(t, -1)
    npix = flat.sum(dim=1, dtype=torch.int32)
    overflow = npix > max_points
    idx, valid = hough.compact_indices(flat * (~overflow)[:, None],
                                       max_points)
    xs, ys = points_of(idx, valid, w)
    votes = kernels.hough_vote(xs, ys, valid, n_rho, off)
    th, rh, ok = hough.find_peaks(votes, threshold, max_peaks)
    ok = ok & ~overflow[:, None] & (npix > 0)[:, None]
    lines, ok = walk_chunks(imgs01, th, rh, ok, max_gap, min_len=min_len)
    return hough.HoughResult(torch.where(ok[..., None], lines, 0), ok, npix,
                             overflow)


# -- the stages of each tool -------------------------------------------------

def _rotation(*args) -> list:
    """4 argument tuples: ``args`` and 3 device copies of it."""
    return [args] + [tuple(a.clone() for a in args) for _ in range(3)]


def _steady_detector(cfg, blocks: list, dev):
    """An M3 detector run over ``blocks`` (past its warm-up) and its step
    keywords."""
    h, w = blocks[0].shape[1:]
    det = bench._m3_detector(cfg, h, w, dev)
    for b in blocks:
        det.process_block_async(b)
    return det, det._step_static_kwargs()


def _scan_info(timer0: int, t: int, kw: dict) -> dict:
    return {"timer0": timer0, "ema_update_frames": m3det.ema_update_frames(
        timer0, t, kw["n"], kw["std_interval"])}


def _step_stage(name, label, fn, det, kw, blocks, chain=None) -> Stage:
    """A stage of ``fn`` on a copy of the detector's carries as they stand
    (the detector's own advance in place as ``chain`` runs it)."""
    carries = (det._gray_hist.clone(), det._sub_hist.clone(),
               det._dy_hist.clone(), det._ema.clone())
    timer = det._timer_dev.clone()
    return Stage(name, label, lambda *a: fn(*a, **kw),
                 [(*carries, b, timer) for b in blocks], chain,
                 _scan_info(det.timer, blocks[0].shape[0], kw))


def block_stages(dev, h: int, w: int, t: int) -> list:
    """``profile_block.py``: the quiet step, window_diff,
    median/binarize/close, the dy rolling sum and the sub-ROI noise std."""
    blocks = _blocks(quiet_frames(5 * t, h, w), t, dev)
    det, kw = _steady_detector(bench._preset("m3det_normal"), blocks, dev)
    n = kw["n"]
    r1, c1, r2, c2 = kw["roi"]
    timer0 = 10 * n  # steady state: warm-up lengths saturated

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device=dev)
    hist = zeros(n - 1, h, w)
    diffs = [kernels.window_diff(hist, b, n, timer0)[0] for b in blocks]
    thr = torch.full((t,), 7, dtype=torch.uint8, device=dev)
    closed = [m3det.median_binarize_close_blocks(d, thr) for d in diffs]
    sub_hist = zeros(n - 1, r2 - r1, c2 - c1)
    at = {"timer0": timer0}
    return [
        _step_stage("step", "FULL quiet block step", m3det._m3_block_step,
                    det, kw, blocks,
                    lambda i: det.process_block_async(blocks[i % 5])[0]),
        Stage("window_diff", "window_diff (max/mean/diff)",
              lambda hh, f: kernels.window_diff(hh, f, n, timer0),
              [(hist, b) for b in blocks], info=at),
        Stage("median_binarize_close", "fused median/binarize/close",
              m3det.median_binarize_close_blocks,
              [(d, thr) for d in diffs]),
        Stage("rolling_sum_u32", "dy rolling_sum_u32",
              lambda hh, c: windows.rolling_sum_u32(hh, c, n),
              [(hist, c) for c in closed]),
        Stage("window_noise_std", "window_noise_std (sub-ROI)",
              lambda hh, f: windows.window_noise_std(
                  hh, f[:, r1:r2, c1:c2], n, timer0),
              [(sub_hist, b) for b in blocks], info=at),
    ]


def dense_stages(dev, h: int, w: int, t: int) -> list:
    """``profile_dense.py``: hough_lines_batch on ``dense_dst``, then
    compaction at 8192 points, the vote on the compacted points, the peak
    find and the segment walk in frame chunks, each on the previous
    stage's output. The one block's stage inputs rotate through 4 device
    copies."""
    dst = torch.from_numpy(dense_dst(t, h, w)).to(dev)
    gaps = torch.full((t,), DENSE_GAP, dtype=torch.float32, device=dev)
    n_rho, off, _, _ = _hough_sizes(h, w)
    imgs01 = (dst > 0).to(torch.uint8)
    flat = imgs01.reshape(t, -1)
    idx, valid = hough.compact_indices(flat, 8192)
    xs, ys = points_of(idx, valid, w)
    votes = kernels.hough_vote(xs, ys, valid, n_rho, off)
    th, rh, ok = hough.find_peaks(votes, DENSE_THRESHOLD, 64)
    npix = flat.sum(dim=1, dtype=torch.int32)
    return [
        Stage("hough_lines_batch", "FULL hough_lines_batch (dense)",
              lambda d, g: hough.hough_lines_batch(
                  d, g, threshold=DENSE_THRESHOLD, min_len=DENSE_MIN_LEN),
              _rotation(dst, gaps),
              info={"npix_per_frame_max": int(npix.max())}),
        Stage("compaction", "compaction (8192)",
              lambda f: hough.compact_indices(f, 8192), _rotation(flat)),
        Stage("hough_vote", f"hough_vote ({t}x8192)",
              lambda x, y, v: kernels.hough_vote(x, y, v, n_rho, off),
              _rotation(xs, ys, valid)),
        Stage("find_peaks", "peak find (3x3 NMS + compact)",
              lambda v: hough.find_peaks(v, DENSE_THRESHOLD, 64),
              _rotation(votes),
              info={"max_peaks_per_frame": int(ok.sum(dim=1).max())}),
        Stage("segment_walk", "segment walk K=64 (incl pack)",
              lambda im, a, b, o, g: walk_chunks(im, a, b, o, g,
                                                 min_len=DENSE_MIN_LEN),
              _rotation(imgs01, th, rh, ok, gaps)),
    ]


def split_stages(dev, h: int, w: int, t: int) -> list:
    """``profile_worstcase_split.py``: ``chain_only`` and the full step on
    the active sky (``bench.worstcase_frames``, 4 blocks), the binary
    threshold pinned at 30 (``bench.worstcase_cfg``)."""
    blocks = _blocks(bench.worstcase_frames(4 * t, h, w), t, dev)
    det, kw = _steady_detector(bench.worstcase_cfg(), blocks, dev)
    return [
        _step_stage("chain_only", "chain-only (no hough)", chain_only, det,
                    kw, blocks),
        _step_stage("step", "FULL dense step", m3det._m3_block_step, det,
                    kw, blocks,
                    lambda i: det.process_block_async(blocks[i % 4])[0]),
    ]


STAGES = {"block": block_stages, "dense": dense_stages,
          "split": split_stages}
SKY = {"block": "quiet", "dense": "dense binarized block",
       "split": "active"}


# -- the readings ------------------------------------------------------------

def _leaves(x) -> list:
    """The tensors of a stage's output, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return x.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])
    return x


def _same_bits(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        a.shape == b.shape and a.dtype == b.dtype
        and torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def slope_ms(stage: Stage, counts: tuple, reps: int) -> float:
    """The JAX tools' reading: ms per call as the slope of chains of
    calls, each chain ended by one ``.item()``."""
    call = stage.chain or (
        lambda i: stage.fn(*stage.inputs[i % len(stage.inputs)]))

    def run_n(k):
        t0 = time.perf_counter()
        out = None
        for i in range(k):
            out = call(i)
        _leaves(out)[0].reshape(-1)[0].item()
        return time.perf_counter() - t0

    run_n(2)
    return bench._chained_slope(run_n, counts, reps)[0] * 1e3


def device_rows(prof):
    """[(self device us, name, calls)] of the profile's device kernels,
    largest first, and their sum (``tools/torch_profile_block.py``). The
    device-side spans of user annotations (a scheduled profile's
    ``ProfilerStep#N``, which spans the whole step) are left out."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        self_dev = getattr(ev, "self_device_time_total", dev_us)
        if getattr(ev, "is_user_annotation", False) or \
                ev.key.startswith("ProfilerStep"):
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA and self_dev:
            rows.append((self_dev, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows)


def _pad(dev) -> None:
    """PAD_KERNELS device sleeps of PAD_CYCLES (``spin_kernel``), waited
    for. They are told apart from a stage's kernels by name."""
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize(dev)


def open_window(dev):
    """A started ``torch.profiler`` of the card's activity, recording.

    CUPTI may lose the first kernel records of a window: a warm-up step of
    pads, whose records are discarded, then a host wait and as many pads
    again at the head of the recorded step take that loss. Launched at
    once after the window opened, 64 one-cycle pads lost records in 7 of
    300 windows on an H100, in two all 64 and then 133 and 400 kernels
    after them; with the host wait, none of 300
    (``tools/torch_profile_pad_check.py``).
    ``close_window`` ends it."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
    prof.start()
    _pad(dev)
    prof.step()
    time.sleep(WINDOW_WAIT_S)
    _pad(dev)
    return prof


def close_window(prof, dev) -> None:
    """Waits for the card, then a host wait, then stops ``prof``."""
    torch.cuda.synchronize(dev)
    time.sleep(WINDOW_WAIT_S)
    prof.stop()


def device_reading(stage: Stage, dev, calls: int) -> dict:
    """``device_ms``, ``launches`` and ``kernel_launches`` of one eager
    call, from ``torch.profiler`` over ``calls`` calls, and the head's
    ``pads_recorded``. Raises if the profile lacks a record of a kernel
    launch or of every pad."""
    prof = open_window(dev)
    before = dict(kernels.LAUNCHES)
    for i in range(calls):
        stage.fn(*stage.inputs[i % len(stage.inputs)])
    torch.cuda.synchronize(dev)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    close_window(prof, dev)
    rows, _ = device_rows(prof)
    pads = sum(r[2] for r in rows if "spin_kernel" in r[1])
    rows = [r for r in rows if "spin_kernel" not in r[1]]
    if not pads:
        raise RuntimeError(f"profile of {stage.name}: no record of the "
                           f"padding kernels; device records: "
                           f"{[r[1][:60] for r in rows[:10]]}")
    recorded = {k: sum(c for _, key, c in rows if f"{k}_kernel" in key)
                for k in kernels.SOURCES}
    if recorded != launched:
        raise RuntimeError(f"profile of {stage.name}: kernel records "
                           f"{recorded} against launches {launched}")
    return {"device_ms": sum(r[0] for r in rows) / calls / 1e3,
            "device_calls": calls,
            "launches": sum(r[2] for r in rows) / calls,
            "kernel_launches": {k: v / calls for k, v in launched.items()},
            "pads_recorded": pads}


def _events_ms(enqueue, n: int) -> float:
    """Device ms of ``enqueue(0..n-1)``, CUDA events around it behind a
    device sleep (so the host runs ahead of the device)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(n):
        enqueue(r)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def graph_reading(stage: Stage, dev, rounds: int) -> dict:
    """``graph_ms`` of the stage captured in a CUDA graph, replayed
    ``rounds`` times over its rotation of inputs; every replay of the
    first round held to the eager call on the same inputs, bit for bit.
    Raises where capture fails or a replay differs."""
    first = stage.inputs[0]
    rotated = [j for j, a in enumerate(first)
               if isinstance(a, torch.Tensor) and any(
                   inp[j].data_ptr() != a.data_ptr()
                   for inp in stage.inputs[1:])]
    static = list(first)
    for j in rotated:
        static[j] = first[j].clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            stage.fn(*static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = _leaves(stage.fn(*static))
    except Exception as e:
        raise RuntimeError(f"CUDA graph capture of stage {stage.name} "
                           f"failed: {e}") from e

    def load(r):
        for j in rotated:
            static[j].copy_(stage.inputs[r % len(stage.inputs)][j])

    for r, inp in enumerate(stage.inputs):
        load(r)
        graph.replay()
        if not _same_bits(out, _leaves(stage.fn(*inp))):
            raise RuntimeError(f"stage {stage.name}: graph replay on input "
                               f"{r} differs from the eager call")
    n = rounds * len(stage.inputs)

    def replay(r):
        load(r)
        graph.replay()
    total = _events_ms(replay, n)
    copies = _events_ms(load, n)
    del graph, out
    return {"graph_ms": (total - copies) / n, "graph_replays": n,
            "graph_copy_ms": copies / n, "graph_equal": True}


def measure(tool: str, dev, h: int, w: int, t: int,
            quick: bool = False) -> list:
    """One record a stage of ``tool`` (and its derived line)."""
    counts, reps = QUICK_SLOPE if quick else SLOPES[tool]
    card = bench.device_info(dev)
    on_card = dev.type == "cuda"
    records = []
    for stage in STAGES[tool](dev, h, w, t):
        rec = {"tool": tool, "stage": stage.name, "label": stage.label,
               "sky": SKY[tool], "shape": [t, h, w], "device": card,
               "slope_ms": slope_ms(stage, counts, reps),
               "slope_counts": list(counts), "slope_reps": reps,
               "slope_reads": ("the slower of the host's enqueue and the "
                               "device" if on_card else "the CPU"),
               **stage.info}
        if on_card:
            rec.update(device_reading(
                stage, dev, QUICK_PROFILED_CALLS if quick
                else PROFILED_CALLS))
            rec.update(graph_reading(
                stage, dev, QUICK_GRAPH_ROUNDS if quick else GRAPH_ROUNDS))
            if "ema_update_frames" in stage.info:
                rec["graph_note"] = GRAPH_NOTE
        else:
            rec.update(device_ms=None, graph_ms=None, launches=None,
                       note=NOT_MEASURED)
        records.append(rec)
        if on_card:
            torch.cuda.empty_cache()
    derived = {"block": ("rest", "rest (hough+EMA+pack+dispatch)", "step",
                         ("window_diff", "median_binarize_close",
                          "rolling_sum_u32", "window_noise_std")),
               "split": ("hough", "hough only (FULL less chain-only)",
                         "step", ("chain_only",))}.get(tool)
    if derived:
        name, label, whole, parts = derived
        by = {r["stage"]: r for r in records}
        rec = {"tool": tool, "stage": name, "label": label,
               "sky": SKY[tool], "shape": [t, h, w], "device": card,
               "derived": f"{whole} less {' + '.join(parts)}"}
        for key in ("slope_ms", "device_ms", "graph_ms", "launches"):
            vals = [by[whole][key]] + [by[p][key] for p in parts]
            rec[key] = (None if None in vals
                        else vals[0] - sum(vals[1:]))
        if not on_card:
            rec["note"] = NOT_MEASURED
        records.append(rec)
    return records


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m metdetpy_tpu_torch.profile_step",
        description=__doc__.split("\n")[0])
    ap.add_argument("tool", choices=TOOLS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--h", type=int, default=540)
    ap.add_argument("--w", type=int, default=960)
    ap.add_argument("--t", type=int, default=64, help="frames a block")
    ap.add_argument("--quick", action="store_true",
                    help="cut the slope, profiler and replay counts")
    return ap


def main(argv=None) -> list:
    """Print one JSON line a stage; returns the records."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    records = measure(args.tool, dev, args.h, args.w, args.t, args.quick)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
