"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. Build: print the card's name and power limit, build the four CUDA
   kernels from ``metdetpy_tpu_torch/csrc`` and print what ``ptxas``
   reports for each (registers, shared memory, spills).
2. Kernels: call each kernel's wrapper on the card at the shapes the main
   path gives it (960x540 frames, 64-frame blocks, window n=25, 8-frame
   Hough chunks of 8192 points and 64 peaks), inputs made from a seed, and
   require exact equality with its plain PyTorch version on the same
   inputs (the outputs are integers). Times both with CUDA events: the
   kernel warm (the same inputs each launch, so they may stay in the L2
   cache) and cold (launches rotate through copies of the inputs whose
   bytes exceed twice the L2, so each launch reads device memory). The
   vote is also held and timed on a raster-ordered point list (a streak
   and salt noise, compacted as the main path compacts them), where
   neighbours in the list share rho bins; the pick is timed beside an
   empty kernel of its grid. Then the ragged cases of
   ``metdetpy_tpu_torch.ops.kernel_cases`` for both, exact, untimed.
3. End to end: a 960x540, 25 fps, 12 s synthetic colour clip with one
   meteor through ``metdetpy_tpu_torch.api.detect_video(..., device="cuda")``
   with the m3det_normal preset as shipped, recheck on (only the frame
   source is the in-memory wrapper and the exposure is real-time). Requires
   a METEOR near the streak that carries a recheck score, every kernel
   launched by that run, at least one forward of the recheck model, no
   block dropped by the loop's failure recovery, and as many forwards of
   the network as the warm-up plus two pyramid levels a recheck (a level
   that raises is not counted, and ends the run).
4. Card against CPU: the MDRF of a small clip on the card equals the one
   the port gives on the CPU (recheck off, so the comparison is exact).
5. Model: YOLOv5s with the shipped weights on the card in bfloat16 on 128
   crops of 320x320; the heads of 4 crops against the port's own float32
   run on the CPU (99% of the values within 5% of the head's standard
   deviation, none beyond 50%); ``_nms_batch`` and ``_compact_kept_device``
   on the card equal to the CPU (exact) and ``_orient_from_packed`` (``ok``
   exact, sums rtol 1e-4 with atol 1e-4 of the weight total); device ms of
   the forward, the NMS and the orientation per block.
6. dldet: ``detect_video`` with ``config/dldet.json`` as shipped (in-memory
   frame source) on a 960x544 colour synthetic clip played over and over:
   2 blocks first (start-up), then 12 blocks (1536 and 9216 raw frames),
   frames per second of each, the same health checks as in phase 3; and
   on a small clip the card's records against the CPU's (category and
   frames equal, points within 2 px, scores within 0.03).
7. Classic: ``ClassicDetector`` through ``detect_video`` at 960x540 (its
   point budget there is 64,800) with ``hough_vote`` and ``walk_pick``
   launched, and on a small clip the card's MDRF equal to the CPU's.
8. Device feed at camera size: ``m3det_normal`` (recheck off) on a gray
   1920x1080, 25 fps clip of 256 frames with one meteor, detected at
   960x540: once with the preprocess on the device (forced: raw blocks
   uploaded, the exact 2:1 downscale run by the uploader), once with the
   loader's upload off (host preprocess, the detector uploads), once
   placed by the loader's probe; the MDRFs equal and equal to the CPU's,
   the placement as asked, bytes uploaded by the loader, all four kernels
   launched in each run.
9. Loaders: ``m3det_normal`` (recheck on) at 960x540 through the Vanilla,
   Thread and Process loaders against the Block loader's MDRF of the same
   clip: equal for the Process loader; for the per-frame loaders, whose
   recheck re-reads each clip through a second loader (its exact range
   where the block loader stacks whole 16-frame chunks), everything but
   the scores equal and the scores within 0.03.
10. Checkpoint: the first block with a checkpoint, then a resume on the
   whole clip, gives the uninterrupted run's METEOR (start time and box);
   once more from a checkpoint written by a CPU run.
11. Photo: ``python -m metdetpy_tpu_torch.photo``'s entry on a folder of
   64 colour 1920x1080 JPEGs (batches of 32; a streak in every fourth, a
   long one of 15-25% of the width in every 16th), on one of them alone
   and on a 64-frame 960x540 timelapse AVI, on the card, with images per
   second; the bfloat16 records agree with the CPU's: per image, both
   ways, each box above the objectness threshold's band (score above
   sqrt(0.25) + 0.03) overlaps a box of the same class on the other side,
   and the top scores of each class agree within 0.03 (bfloat16 on the
   card and on the CPU shifts boxes by a few pixels and keeps other links
   of a streak's chain of boxes, as a float32 run of the model does too).
12. Denoise and clip export: device MFNR of 64 colour 1920x1080 frames
   (a synthetic sky, one meteor, in memory through the port's
   ``ThreadVideoLoader``) with each background (``mean``, ``median``,
   ``sigma-clipping``, ``med-of-med``, full upload; ``mean`` also
   host-reduced with the foreground window), the placement asked for,
   frames per second and the stage seconds and bytes; the same at 960x540
   held within +/-1 gray level in under 2% of pixels of the host path;
   ``stack_median`` forced to the card on the 1080p stack, equal to the
   host median, both timed; ``python -m metdetpy_tpu_torch.clip`` on a
   960x540 MJPG AVI with two requests on the card and on the CPU: max
   stack and simple denoise equal, mfnr-mix within +/-1 in under 2%,
   video with bboxes of the requested frame counts.

Phases 3 and 6 run the presets as ``detect_video`` sets them up: the
loader uploads each block from pinned memory in its uploader thread; they
require bytes uploaded by it, and phase 6 also times a 12-block dldet run
with that upload off, in the same call.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. It imports nothing
of JAX or of the JAX package, and exits non-zero without a card.
"""

import contextlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
REPO = os.path.dirname(os.path.abspath(__file__))
# files the smoke writes (checkpoints, photos, a timelapse); git-ignored,
# removed by the last phase
FILES = os.path.join(REPO, ".smoke_files")
W, H, FPS = 960, 540, 25.0
N_WIN, T_BLOCK, FRAME_CHUNK = 25, 64, 8
MAX_POINTS, MAX_PEAKS = 8192, 64
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
PALLAS = "metdetpy_tpu/ops/pallas_kernels.py"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"{torch.cuda.get_device_name(0)}, power limit not read")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device ms per call: CUDA events around ``iters`` calls, enqueued
    behind a device-side sleep so that the host runs ahead and the events
    time back-to-back device work, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device clock cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, args: tuple) -> float:
    """Device ms per call of ``fn(*args_i)``, rotating through copies of
    ``args`` whose tensors together hold more than twice the L2 cache, so
    no launch finds its inputs in the L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n_bytes = sum(a.numel() * a.element_size() for a in args
                  if isinstance(a, torch.Tensor))
    n_copies = max(2, -(-2 * l2 // n_bytes) + 1)
    copies = [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args) for _ in range(n_copies)]
    rotation = itertools.cycle(copies)
    ms = cuda_ms(lambda: fn(*next(rotation)), max(20, n_copies))
    del copies, rotation
    torch.cuda.empty_cache()
    return ms


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(dev: torch.device):
    """Main-path inputs of each kernel, made from SEED."""
    from metdetpy_tpu_torch.ops import hough
    from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
    rng = np.random.default_rng(SEED)
    sky = generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=(N_WIN - 1 + T_BLOCK) / FPS,
        meteors=[SynthMeteor(start_sec=1.0, end_sec=2.5, pt1=(430, 130),
                             pt2=(290, 300))], n_stars=150, noise_sigma=4.0,
        seed=SEED)
    seq = torch.from_numpy(sky).to(dev)
    wd = (seq[:N_WIN - 1].contiguous(), seq[N_WIN - 1:].contiguous())
    diff = torch.from_numpy(rng.integers(0, 24, (T_BLOCK, H, W),
                                         dtype=np.uint8)).to(dev)
    thr = torch.from_numpy(rng.integers(3, 12, T_BLOCK,
                                        dtype=np.uint8)).to(dev)
    # Hough chunk: dense points of random frames, a different count each
    n_rho = hough._round_up(2 * (W + H) + 1, 128)
    counts = rng.integers(MAX_POINTS // 4, MAX_POINTS + 1, FRAME_CHUNK)
    valid = np.arange(MAX_POINTS)[None, :] < counts[:, None]
    xs = np.where(valid, rng.integers(0, W, (FRAME_CHUNK, MAX_POINTS)), 0)
    ys = np.where(valid, rng.integers(0, H, (FRAME_CHUNK, MAX_POINTS)), 0)
    vote = (torch.from_numpy(xs.astype(np.float32)).to(dev),
            torch.from_numpy(ys.astype(np.float32)).to(dev),
            torch.from_numpy(valid).to(dev), n_rho, W + H)
    # walk pick: corner planes of sparse random frames, walks of random
    # peaks through them
    s_dim = hough._round_up(max(H, W) + 1, 128)
    n_steps = hough._round_up(max(H, W) + 4, 128)
    imgs = torch.from_numpy(
        (rng.random((FRAME_CHUNK, H, W)) < 0.02).astype(np.uint8)).to(dev)
    planes = hough.corner_planes(imgs, s_dim)
    th_i = torch.from_numpy(rng.integers(0, 180, (FRAME_CHUNK, MAX_PEAKS))
                            ).to(dev)
    rh_i = torch.from_numpy(rng.integers(0, n_rho, (FRAME_CHUNK, MAX_PEAKS))
                            ).to(dev)
    geom = hough.walk_geom(th_i, rh_i, W + H, n_steps, H, W, s_dim)
    pick = (planes, geom.r.contiguous(), geom.xmaj)
    return wd, (diff, thr), vote, pick, counts, geom


def raster_vote_input(dev: torch.device):
    """A Hough chunk as the main path makes it: 960x540 binary frames with
    a dilated streak and about 1% salt noise each, compacted in raster
    order by ``hough.compact_indices`` (``hough_lines_batch`` does the
    same), so consecutive points are neighbours on a row or the streak."""
    from metdetpy_tpu_torch.ops import hough
    rng = np.random.default_rng(SEED + 1)
    mask = rng.random((FRAME_CHUNK, H, W)) < 0.01
    steps = np.linspace(0.0, 1.0, 400)
    for f in range(FRAME_CHUNK):
        x0, y0 = rng.integers(100, W - 100), rng.integers(100, H - 100)
        ang = rng.uniform(0, np.pi)
        px = np.clip(x0 + 250 * np.cos(ang) * (steps - 0.5), 1, W - 2)
        py = np.clip(y0 + 250 * np.sin(ang) * (steps - 0.5), 1, H - 2)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                mask[f, (py + dy).astype(int), (px + dx).astype(int)] = True
    flats = torch.from_numpy(mask.astype(np.uint8)).to(dev).reshape(
        FRAME_CHUNK, -1)
    idx, valid = hough.compact_indices(flats, MAX_POINTS)
    idx = torch.where(valid, idx, 0)
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)
    return (xs, ys, valid, hough._round_up(2 * (W + H) + 1, 128), W + H)


def kernel_cases(dev: torch.device) -> dict:
    """{name: (wrapper, plain version, main-path args, source, TPU kernel,
    (bound ms, bound by))} for each kernel."""
    from metdetpy_tpu_torch.ops import kernels as K
    wd, mbc, vote, pick, counts, geom = kernel_inputs(dev)
    hw = H * W
    n_valid = int(counts.sum())
    inside = (geom.r >= 0) & (geom.r < pick[0].shape[-1])
    n_pick = int(inside.sum())
    return {
        "window_diff": (
            K.window_diff, K.window_diff_plain, (*wd, N_WIN, 10),
            "metdetpy_tpu_torch/csrc/window_diff.cu", f"{PALLAS}:281",
            # read n-1+T frames, write T diff frames (the new history is
            # a view of the block where n-1 <= T, else n-1 more frames);
            # per output: van Herk max (3), running sum (2), floor mean
            # (1), subtract (1)
            bound((N_WIN - 1 + T_BLOCK) * hw + T_BLOCK * hw
                  + (N_WIN - 1 if N_WIN - 1 > T_BLOCK else 0) * hw,
                  7 * T_BLOCK * hw)),
        "median_binarize_close": (
            K.median_binarize_close, K.median_binarize_close_plain, mbc,
            "metdetpy_tpu_torch/csrc/median_binarize_close.cu",
            f"{PALLAS}:126",
            # one frame in, one out; per pixel: threshold (1), 3x3 count
            # of the pixels above it, separable (4), count >= 5 (1), close
            # as separable OR/AND (8)
            bound(2 * T_BLOCK * hw + T_BLOCK, T_BLOCK * hw * 14)),
        "hough_vote": (
            K.hough_vote, K.hough_vote_plain, vote,
            "metdetpy_tpu_torch/csrc/hough_vote.cu", f"{PALLAS}:505",
            # points in (x, y f32 + valid byte, 9 bytes each); 180 x n_rho
            # i32 out per frame; fma + mul + add per (valid point, theta)
            bound(FRAME_CHUNK * MAX_POINTS * 9
                  + FRAME_CHUNK * 180 * vote[3] * 4, n_valid * 180 * 3)),
        "walk_pick": (
            K.walk_pick, K.walk_pick_plain, pick,
            "metdetpy_tpu_torch/csrc/walk_pick.cu", f"{PALLAS}:402",
            # r in (i32) + xmaj (a byte per peak) + one plane byte per
            # column whose row lies in the plane; i32 out; no arithmetic
            bound(pick[1].numel() * 4 + pick[2].numel() + n_pick
                  + pick[1].numel() * 4, 0)),
    }


def check_exact(name: str, kern, plain, args) -> float:
    """Fail unless ``kern(*args)`` equals ``plain(*args)`` exactly; returns
    the largest absolute difference (0.0)."""
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}: kernel gives {g.dtype}{tuple(g.shape)}, plain "
                 f"{w.dtype}{tuple(w.shape)}")
        n_bad = int((g != w).sum())
        if n_bad:
            fail(f"{name}: {n_bad} elements differ from the plain "
                 "version (exact equality required)")
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in zip(got, want))


def raster_vote_times(dev: torch.device) -> dict:
    """The vote on the raster-ordered list: exact, then warm and cold ms."""
    from metdetpy_tpu_torch.ops import kernels as K
    args = raster_vote_input(dev)
    check_exact("hough_vote (raster-ordered)", K.hough_vote,
                K.hough_vote_plain, args)
    return {"raster_ms": cuda_ms(lambda: K.hough_vote(*args), 20),
            "raster_cold_ms": cold_ms(K.hough_vote, args),
            "raster_valid_points": int(args[2].sum())}


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version, exact, with times."""
    from metdetpy_tpu_torch.ops import kernels as K
    rows = {}
    for name, (kern, plain, args, src, tpu, (b_ms, b_by)) in kernel_cases(
            dev).items():
        err = check_exact(name, kern, plain, args)
        rows[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": None, "max_abs_err": err,
            "ms": cuda_ms(lambda: kern(*args), 20),
            "cold_ms": cold_ms(kern, args),
            "plain_ms": cuda_ms(lambda: plain(*args), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        print(f"kernel {name}: exact; {rows[name]['ms']:.4f} ms warm, "
              f"{rows[name]['cold_ms']:.4f} ms cold (plain "
              f"{rows[name]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
              f"{b_by})", flush=True)
        if name == "hough_vote":
            rows[name].update(raster_vote_times(dev))
            print(f"kernel {name}, raster-ordered list of "
                  f"{rows[name]['raster_valid_points']} points: exact; "
                  f"{rows[name]['raster_ms']:.4f} ms warm, "
                  f"{rows[name]['raster_cold_ms']:.4f} ms cold", flush=True)
        if name == "walk_pick":
            rows[name]["floor_ms"] = cuda_ms(
                lambda: K.walk_pick_floor(*args), 20)
            print(f"kernel {name}: an empty kernel of its grid takes "
                  f"{rows[name]['floor_ms']:.4f} ms (bound {b_ms:.4f} ms)",
                  flush=True)
    return rows


def phase_ragged(dev: torch.device) -> None:
    """hough_vote and walk_pick against their plain versions on the ragged
    cases, exact."""
    from metdetpy_tpu_torch.ops import kernel_cases as C
    from metdetpy_tpu_torch.ops import kernels as K
    for case in C.VOTE_CASES:
        check_exact(f"hough_vote case {case[0]}", K.hough_vote,
                    K.hough_vote_plain, C.vote_case(case, dev, SEED))
    for case in C.PICK_CASES:
        check_exact(f"walk_pick case {case[0]}", K.walk_pick,
                    K.walk_pick_plain, C.pick_case(case, dev, SEED))
    print(f"ragged cases: {len(C.VOTE_CASES)} of hough_vote and "
          f"{len(C.PICK_CASES)} of walk_pick exact", flush=True)


def preset_cfg(preset: str, resize="shipped", recheck=True, detector=None):
    """A shipped preset on an in-memory clip: the frame source becomes the
    numpy wrapper; the M3 presets' exposure becomes real-time (their "auto"
    estimates it from a video file). ``resize``, ``recheck=False`` and
    ``detector`` override the preset where a phase says so."""
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.utils import relative2abs_path
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path(f"./config/{preset}.json"))
    cfg.loader.wrapper = "NumpyVideoWrapper"
    if resize != "shipped":
        cfg.loader.resize = resize
    if cfg.loader.grayscale:
        cfg.loader.exp_time = "real-time"
    if not recheck:
        cfg.collector.recheck_cfg.switch = False
    if detector:
        cfg.detector.name = detector
    return cfg


def synth_clip(w: int, h: int, seconds: float, t0: float, t1: float,
               color: bool, n_stars: int = 150, seed: int = SEED):
    """(frames, pt1, pt2): a synthetic sky with one meteor from t0 to t1."""
    from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
    pt1, pt2 = (int(w * 0.45), int(h * 0.25)), (int(w * 0.30), int(h * 0.55))
    frames = generate_meteor_video(
        width=w, height=h, fps=FPS, duration_sec=seconds,
        meteors=[SynthMeteor(start_sec=t0, end_sec=t1, pt1=pt1, pt2=pt2)],
        n_stars=n_stars, noise_sigma=3.0, seed=seed, color=color)
    return frames, pt1, pt2


class CycledFrames:
    """A [T, H, W, C] clip played over and over for ``n_frames`` frames as
    an in-memory frame source, without the copies (``NumpyVideoWrapper`` reads ``dtype``,
    ``ndim``, ``shape`` and single frames or slices)."""

    def __init__(self, clip: np.ndarray, n_frames: int) -> None:
        self.clip = clip
        self.dtype, self.ndim = clip.dtype, clip.ndim
        self.shape = (n_frames, *clip.shape[1:])

    def __getitem__(self, i):
        n = self.clip.shape[0]
        if isinstance(i, slice):
            return np.stack([self.clip[j % n]
                             for j in range(*i.indices(self.shape[0]))])
        if not 0 <= i < self.shape[0]:
            raise IndexError(i)
        return self.clip[i % n]

    def __repr__(self) -> str:
        return f"CycledFrames[{'x'.join(map(str, self.shape))}]"


def check_healthy_run(name: str, mdrf, model_cfgs, levels_run: int) -> None:
    """Fail if the run dropped a block, or if the network's forwards are
    not the models' warm-ups plus every pyramid level that was asked for
    (``levels_run``): a level that raised is not counted by the model."""
    from metdetpy_tpu_torch.models import yolo
    dropped = mdrf.performance["recovered_blocks"]
    if dropped:
        fail(f"{name}: {dropped} block(s) were dropped by the loop's "
             "failure recovery")
    want = sum(int(m.warmup) for m in model_cfgs) + levels_run
    if yolo.CALLS["network"] != want:
        fail(f"{name}: {yolo.CALLS['network']} network forwards, expected "
             f"{want} (warm-ups plus {levels_run} pyramid levels)")


def phase_end_to_end(card: str) -> dict:
    """The main path at full width; returns the launch counts of its run."""
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.models import yolo
    from metdetpy_tpu_torch.ops import kernels as K
    from metdetpy_tpu_torch.utils import ts2frame
    frames, pt1, pt2 = synth_clip(W, H, 12.0, 5.0, 7.0, color=True)
    cfg = preset_cfg("m3det_normal")
    if not cfg.collector.recheck_cfg.switch:
        fail("m3det_normal as shipped has the recheck on; the preset read "
             "here has it off")
    K.reset_launch_counts()
    yolo.CALLS.clear()
    t0 = time.perf_counter()
    mdrf = detect_video(frames, None, cfg, work_mode="backend",
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    rechecks = yolo.CALLS["forward"]
    meteors = [t for rec in mdrf.results for t in rec.target
               if t.category == "METEOR"]
    if not meteors:
        fail(f"no METEOR found at {W}x{H} ({len(mdrf.results)} records)")
    best = max(meteors, key=lambda t: t.score)
    xs = sorted([best.pt1[0], best.pt2[0]])
    ys = sorted([best.pt1[1], best.pt2[1]])
    sf = ts2frame(best.start_time, FPS) / FPS
    if not (abs(xs[0] - pt2[0]) < 40 and abs(xs[1] - pt1[0]) < 40
            and abs(ys[0] - pt1[1]) < 40 and abs(ys[1] - pt2[1]) < 40
            and abs(sf - 5.0) < 1.5):
        fail(f"METEOR {best.pt1}->{best.pt2} at {best.start_time} is not "
             f"near the synthetic streak {pt1}->{pt2} at 5.0 s")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    if not mdrf.performance.get("loader_h2d_bytes"):
        fail("m3det_normal: the loader uploaded no block (device-put mode "
             "is off on the main path)")
    if rechecks < 1:
        fail("the recheck model was never called on the main path")
    if best.recheck_score is None:
        fail(f"the METEOR carries no recheck score: {best}")
    recheck_model = cfg.collector.recheck_cfg.model
    check_healthy_run("m3det_normal", mdrf, [recheck_model],
                      recheck_model.multiscale_pred * rechecks)
    n_frames = frames.shape[0]
    print(f"end to end (m3det_normal, recheck on): {n_frames} frames "
          f"{W}x{H} in {wall:.3f} s = {n_frames / wall:.2f} frames/s on "
          f"{card}; METEOR {best.pt1}->{best.pt2} score {best.score} "
          f"recheck {best.recheck_score}; launches {launches}; recheck "
          f"forwards {rechecks} ({yolo.CALLS['network']} network "
          f"forwards); perf {json.dumps(mdrf.performance)}", flush=True)
    return launches


def phase_card_vs_cpu() -> None:
    from metdetpy_tpu_torch.api import detect_video
    frames, _, _ = synth_clip(256, 144, 6.5, 2.4, 4.4, color=False,
                              n_stars=40, seed=7)
    got = {}
    for dev in ("cuda", "cpu"):
        mdrf = detect_video(frames, None,
                            preset_cfg("m3det_normal", None, recheck=False),
                            work_mode="backend", device=dev)
        got[dev] = [r.to_dict() for r in mdrf.results]
    if got["cuda"] != got["cpu"]:
        fail(f"MDRF on the card differs from the CPU: {got['cuda']} vs "
             f"{got['cpu']}")
    if not got["cuda"]:
        fail("no record found on the small clip")
    print(f"card vs cpu: {len(got['cuda'])} MDRF record(s) equal",
          flush=True)


def bf16_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The bfloat16 criterion: 99% of ``got`` within 5% of the standard
    deviation of ``want`` and none beyond 50%. Returns the largest
    absolute difference."""
    got, want = got.double().cpu(), want.double().cpu()
    rel = (got - want).abs() / max(float(want.abs().std()), 1e-3)
    q99 = float(torch.quantile(rel.flatten(), 0.99))
    if not (q99 < 0.05 and float(rel.max()) < 0.5):
        fail(f"{name}: bfloat16 on the card against float32 on the CPU: "
             f"99% quantile {q99:.4f} (limit 0.05), max "
             f"{float(rel.max()):.4f} (limit 0.5) of the standard deviation")
    return float((got - want).abs().max())


def phase_model(card: str) -> None:
    """YOLOv5s with the shipped weights on the card, and the device
    functions around it against the CPU."""
    from metdetpy_tpu_torch.detectors import mldet
    from metdetpy_tpu_torch.models import yolo, yolov5
    from metdetpy_tpu_torch.models.weights import params_from_flax
    from metdetpy_tpu_torch.utils import relative2abs_path
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    path = relative2abs_path("./weights/yolov5s_v5.flax.npz")
    ym = yolo.YOLOModel(weight_path=path, nms=True, input_hw=(320, 320),
                        device="cuda")
    n_params = sum(p.numel() for p in ym.model.state_dict().values())
    # 128 crops of 320x320: tiles of a synthetic sky, as dldet cuts them
    sky, _, _ = synth_clip(960, 544, 64 / FPS, 0.5, 2.0, color=True)
    _, (tiles,) = ym._plan_tiles(544, 960)
    with torch.inference_mode():
        stacks_dev = torch.from_numpy(sky).to(dev)
        x = yolo._unit_f32(stacks_dev)
        crops = torch.stack([x[:, y0:y0 + hs, x0:x0 + ws]
                             for (y0, x0, hs, ws) in tiles], dim=1)
        crops = yolo._resize_to(crops.reshape(-1, *crops.shape[2:]),
                                (320, 320))
        if tuple(crops.shape) != (128, 320, 320, 3):
            fail(f"dldet crops are {tuple(crops.shape)}, not 128x320x320x3")
        heads = ym.model(crops)
        with np.load(path) as data:
            sd = params_from_flax({k: data[k] for k in data.files})
        ref = yolov5.YOLOv5(nc=ym.nc, dtype=torch.float32).eval()
        ref.load_state_dict(sd, strict=True)
        pick = [0, 1, 63, 127]
        ref_heads = ref(crops[pick].cpu())
        errs = [bf16_close(f"head {i}", h[pick], r)
                for i, (h, r) in enumerate(zip(heads, ref_heads))]
        fwd_ms = cuda_ms(lambda: ym.model(crops), 10)
        prep_ms = cuda_ms(lambda: yolo._tiles_forward_topk(
            ym.model, stacks_dev, tuple(tiles), (320, 320), 256, 0.25),
            5) - fwd_ms
        # NMS and compaction: seeded candidates, card against CPU, exact
        sel = torch.from_numpy(np.concatenate([
            rng.uniform(0, 320, (64, 128, 2)), rng.uniform(2, 80,
                                                           (64, 128, 2)),
            np.round(rng.uniform(0, 1, (64, 128, 1)), 2),
            rng.uniform(0, 1, (64, 128, ym.nc))], axis=-1).astype(
                np.float32))
        sel_dev = sel.to(dev)
        got = yolo._sel_nms_device(sel_dev, pos_thre=0.25, nms_thre=0.45)
        want = yolo._sel_nms_device(sel, pos_thre=0.25, nms_thre=0.45)
        for g, w_, what in zip(got, want, ("order", "keep")):
            if not torch.equal(g.cpu(), w_):
                fail(f"_nms_batch {what} on the card differs from the CPU")
        got_c = yolo._compact_kept_device(sel_dev, *got, 512)
        want_c = yolo._compact_kept_device(sel, *want, 512)
        for g, w_, what in zip(got_c, want_c, ("packed", "counts", "total")):
            if not torch.equal(g.cpu(), w_):
                fail(f"_compact_kept_device {what} on the card differs "
                     "from the CPU")
        nms_ms = cuda_ms(lambda: yolo._sel_nms_device(
            sel_dev, pos_thre=0.25, nms_thre=0.45), 3, 1)
        # orientation of 64 packed rows on the 64 stacks
        packed = torch.zeros((64, 5 + ym.nc + 1), dtype=torch.float32)
        c = rng.uniform(20, 300, (64, 2))
        wh = rng.uniform(4, 30, (64, 2))
        packed[:, 0] = torch.from_numpy(rng.integers(0, 64, 64)).float()
        packed[:, 1:5] = torch.from_numpy(np.concatenate(
            [c - wh / 2, c + wh / 2], axis=1).astype(np.float32))
        packed[0, 1:5] = torch.tensor([0.0, 0.0, 320.0, 320.0])  # too large
        sw = float(np.float32(960 / 320))
        sh = float(np.float32(544 / 320))
        packed_dev = packed.to(dev)
        o_got = mldet._orient_from_packed(stacks_dev, packed_dev, sw, sh,
                                          96).cpu()
        o_want = mldet._orient_from_packed(torch.from_numpy(sky), packed,
                                           sw, sh, 96)
        if not torch.equal(o_got[:, 3], o_want[:, 3]):
            fail("_orient_from_packed ok flags on the card differ from "
                 "the CPU")
        okr = o_want[:, 3] > 0
        tol = 1e-4 * o_want[okr, :3].abs() + 1e-4 * o_want[okr, 2:3]
        o_err = (o_got[okr, :3] - o_want[okr, :3]).abs()
        if bool((o_err > tol).any()):
            fail(f"_orient_from_packed sums on the card differ from the "
                 f"CPU by up to {float(o_err.max())}")
        orient_ms = cuda_ms(lambda: mldet._orient_from_packed(
            stacks_dev, packed_dev, sw, sh, 96), 5)
    print(f"model: YOLOv5s {n_params} values, bfloat16, 128 crops 320x320 "
          f"on {card}: heads against float32 (no TF32) on the CPU max abs err "
          f"{[round(e, 4) for e in errs]} (bfloat16 criterion met); forward "
          f"{fwd_ms:.3f} ms, crops + cubic resize + decode + top-k "
          f"{prep_ms:.3f} ms, NMS [64 x 128] {nms_ms:.3f} ms (exact), "
          f"compaction exact, orientation of 64 rows {orient_ms:.3f} ms "
          f"(ok exact, {int(okr.sum())} rows, max err "
          f"{float(o_err.max()):.3g})", flush=True)


def _records(mdrf) -> list:
    return [t for rec in mdrf.results for t in rec.target]


def dldet_run(name: str, frames, card: str, device_put: bool = True):
    """config/dldet.json as shipped on 960x544 colour frames; prints the
    run and returns (raw frames per second, dispatch seconds). With
    ``device_put`` off the loader's upload is switched off
    (METDETPY_TPU_LOADER_DEVICE_PUT=0) and the detector uploads."""
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.models import yolo
    from metdetpy_tpu_torch.ops import kernels as K
    cfg = preset_cfg("dldet")
    yolo.CALLS.clear()
    K.reset_launch_counts()
    if not device_put:
        os.environ["METDETPY_TPU_LOADER_DEVICE_PUT"] = "0"
    try:
        t0 = time.perf_counter()
        mdrf = detect_video(frames, None, cfg, work_mode="backend",
                            device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("METDETPY_TPU_LOADER_DEVICE_PUT", None)
    uploaded = mdrf.performance.get("loader_h2d_bytes", 0)
    if bool(uploaded) != device_put:
        fail(f"dldet, {name}: the loader uploaded {uploaded} bytes with "
             f"device-put {'on' if device_put else 'off'}")
    recs = _records(mdrf)
    if not recs:
        fail(f"dldet found no record on the 960x544 clip ({name})")
    for t in recs:
        vals = [*t.pt1, *t.pt2, t.score]
        if not all(np.isfinite(v) for v in vals):
            fail(f"dldet record is not finite: {t}")
    n = frames.shape[0]
    merged = n // 12                      # 0.5 s of exposure at 25 fps
    blocks = -(-merged // 64)
    det_model, re_model = cfg.detector.cfg.model, \
        cfg.collector.recheck_cfg.model
    check_healthy_run(f"dldet, {name}", mdrf, [det_model, re_model],
                      blocks * max(det_model.multiscale_pred, 1)
                      + yolo.CALLS["forward"] * re_model.multiscale_pred)
    print(f"dldet as shipped, {name} (loader upload "
          f"{'on' if device_put else 'off'}): {n} raw frames 960x544 colour "
          f"({merged} merged, {blocks} blocks) in {wall:.3f} s "
          f"= {n / wall:.2f} frames/s on {card}; {len(recs)} target(s), "
          f"categories {sorted({t.category for t in recs})}; network "
          f"forwards {yolo.CALLS['network']}, recheck forwards "
          f"{yolo.CALLS['forward']}; kernel launches {dict(K.LAUNCHES)} "
          f"(the path holds none of the four); perf "
          f"{json.dumps(mdrf.performance)}", flush=True)
    return n / wall, mdrf.performance["dispatch_s"]


def phase_dldet(card: str) -> None:
    """config/dldet.json as shipped at 960x544: a two-block run (start-up:
    the loader's pool, the model's first shapes), then twelve blocks (the
    rate), and card against CPU."""
    from metdetpy_tpu_torch.api import detect_video
    # 12 s of sky with a meteor, played over and over; the preset's 0.5 s
    # exposure merges 12 raw frames into one, 64 merged frames make a block
    clip, _, _ = synth_clip(960, 544, 12.0, 5.0, 7.0, color=True)
    dldet_run("start-up run of 2 blocks", CycledFrames(clip, 2 * 64 * 12),
              card)
    on = dldet_run("12 blocks", CycledFrames(clip, 12 * 64 * 12), card)
    off = dldet_run("12 blocks", CycledFrames(clip, 12 * 64 * 12), card,
                    device_put=False)
    print(f"dldet 12 blocks on {card}: loader upload on {on[0]:.2f} raw "
          f"frames/s, dispatch {on[1]:.4f} s; off {off[0]:.2f} frames/s, "
          f"dispatch {off[1]:.4f} s (one call)", flush=True)
    del clip
    # card against CPU on a small clip at a 96x96 model input
    small, _, _ = synth_clip(256, 144, 6.5, 2.4, 4.4, color=True,
                             n_stars=40, seed=7)
    os.environ["METDETPY_TPU_YOLO_HW"] = "96x96"
    try:
        got = {dev: _records(detect_video(
            small.copy(), None, preset_cfg("dldet", None),
            work_mode="backend", device=dev)) for dev in ("cuda", "cpu")}
    finally:
        del os.environ["METDETPY_TPU_YOLO_HW"]
    if not got["cpu"] or len(got["cuda"]) != len(got["cpu"]):
        fail(f"dldet on the card gives {len(got['cuda'])} target(s), the "
             f"CPU {len(got['cpu'])}")
    for a, b in zip(got["cuda"], got["cpu"]):
        same = (a.category == b.category
                and a.start_frame == b.start_frame
                and a.last_activate_frame == b.last_activate_frame
                and max(abs(p - q) for p, q in zip(
                    [*a.pt1, *a.pt2], [*b.pt1, *b.pt2])) <= 2
                and abs(a.score - b.score) <= 0.03
                and abs((a.recheck_score or 0) - (b.recheck_score or 0))
                <= 0.03)
        if not same:
            fail(f"dldet on the card differs from the CPU: {a} vs {b}")
    print(f"dldet card vs cpu: {len(got['cpu'])} target(s) agree (category "
          "and frames equal, points within 2 px, scores within 0.03)",
          flush=True)


def phase_classic(card: str) -> None:
    """ClassicDetector through detect_video: on the card at 960x540, and
    the card's MDRF against the CPU's on a small clip."""
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.ops import kernels as K
    frames, _, _ = synth_clip(W, H, 128 / FPS, 1.5, 3.5, color=False)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    mdrf = detect_video(frames, None,
                        preset_cfg("m3det_normal", detector="ClassicDetector",
                                   recheck=False),
                        work_mode="backend", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if launches["hough_vote"] <= 0 or launches["walk_pick"] <= 0:
        fail(f"ClassicDetector did not launch the Hough kernels: {launches}")
    print(f"classic: {frames.shape[0]} frames {W}x{H} (point budget "
          f"{min(max(8192, W * H // 8), 1 << 16)}) in {wall:.3f} s on {card};"
          f" {len(mdrf.results)} record(s); launches {launches}", flush=True)
    small, _, _ = synth_clip(256, 144, 6.5, 2.4, 4.4, color=False,
                             n_stars=40, seed=7)
    got = {}
    for dev in ("cuda", "cpu"):
        mdrf = detect_video(small, None, preset_cfg(
            "m3det_normal", None, recheck=False, detector="ClassicDetector"),
            work_mode="backend", device=dev)
        got[dev] = [r.to_dict() for r in mdrf.results]
    if got["cuda"] != got["cpu"]:
        fail(f"ClassicDetector's MDRF on the card differs from the CPU: "
             f"{got['cuda']} vs {got['cpu']}")
    if not got["cuda"]:
        fail("ClassicDetector found no record on the small clip")
    print(f"classic card vs cpu: {len(got['cuda'])} MDRF record(s) equal",
          flush=True)


@contextlib.contextmanager
def env_set(env: dict):
    """Set environment variables for the block only."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_m3(frames, cfg, dev: str, env: dict = None, **kw):
    """detect_video with the launch counts set to 0 just before it; returns
    (mdrf, launches, wall seconds). ``env`` is set for the run only."""
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.ops import kernels as K
    with env_set(env or {}):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        mdrf = detect_video(frames, None, cfg, work_mode="backend",
                            device=dev, **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return mdrf, dict(K.LAUNCHES), wall


def _require_launches(name: str, launches: dict) -> None:
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"{name}: kernels not launched: {missing} ({launches})")


def _dicts(mdrf) -> list:
    return [r.to_dict() for r in mdrf.results]


def phase_feed_1080p(card: str) -> None:
    """m3det_normal at camera size: 1920x1080 gray decoded, 960x540
    detected, with the preprocess on the device, on the host, and where
    the loader's probe puts it."""
    fw, fh = 2 * W, 2 * H
    frames, _, _ = synth_clip(fw, fh, 256 / FPS, 4.0, 6.0, color=False)
    cfg = preset_cfg("m3det_normal", recheck=False)
    if cfg.loader.resize != W:
        fail(f"m3det_normal's runtime width is {cfg.loader.resize}, not {W}")
    runs = {}
    for name, env in (("device", {"METDETPY_TPU_DEVICE_PREPROC": "force"}),
                      ("host", {"METDETPY_TPU_LOADER_DEVICE_PUT": "0"}),
                      ("probed", {})):
        mdrf, launches, wall = _run_m3(frames, preset_cfg(
            "m3det_normal", recheck=False), "cuda", env)
        _require_launches(f"1080p feed ({name})", launches)
        perf = mdrf.performance
        want = {"device": "device", "host": "host"}.get(name)
        if want and perf.get("loader_placement") != want:
            fail(f"1080p feed ({name}): placement "
                 f"{perf.get('loader_placement')}, expected {want}")
        if name != "host" and not perf.get("loader_h2d_bytes"):
            fail(f"1080p feed ({name}): the loader uploaded nothing")
        runs[name] = (mdrf, launches, wall)
        print(f"1080p feed, preprocess {name}: {frames.shape[0]} frames "
              f"{fw}x{fh} -> {W}x{H} in {wall:.3f} s = "
              f"{frames.shape[0] / wall:.2f} frames/s on {card}; placement "
              f"{perf.get('loader_placement')}, loader_h2d_s "
              f"{perf.get('loader_h2d_s')}, loader_h2d_bytes "
              f"{perf.get('loader_h2d_bytes')}, probe "
              f"{json.dumps(perf.get('loader_preproc_probe'))}; launches "
              f"{launches}; perf {json.dumps(perf)}", flush=True)
    cpu, _, cpu_wall = _run_m3(frames, preset_cfg(
        "m3det_normal", recheck=False), "cpu")
    got = {k: _dicts(v[0]) for k, v in runs.items()}
    if not any(t["category"] == "METEOR" for r in got["device"]
               for t in r["target"]):
        fail(f"1080p feed: no METEOR found ({got['device']})")
    for k in ("host", "probed"):
        if got[k] != got["device"]:
            fail(f"1080p feed: the MDRF with the preprocess {k} differs "
                 f"from the device's: {got[k]} vs {got['device']}")
    if _dicts(cpu) != got["device"]:
        fail(f"1080p feed: the card's MDRF differs from the CPU's: "
             f"{got['device']} vs {_dicts(cpu)}")
    print(f"1080p feed: {len(got['device'])} MDRF record(s), equal with the "
          f"preprocess on the device, on the host, probed, and on the CPU "
          f"({cpu_wall:.1f} s)", flush=True)


def phase_loaders(card: str) -> None:
    """m3det_normal (recheck on) through every loader, against the Block
    loader's MDRF of the same clip."""
    frames, _, _ = synth_clip(W, H, 8.0, 3.0, 5.0, color=True)
    ref, launches, wall = _run_m3(frames, preset_cfg("m3det_normal"), "cuda")
    _require_launches("BlockVideoLoader", launches)
    want = _records(ref)
    if not any(t.category == "METEOR" and t.recheck_score is not None
               for t in want):
        fail(f"loaders: no rechecked METEOR with the Block loader ({want})")
    print(f"loaders: BlockVideoLoader {frames.shape[0]} frames {W}x{H} in "
          f"{wall:.3f} s on {card}, {len(want)} target(s)", flush=True)
    for name in ("ProcessVideoLoader", "VanillaVideoLoader",
                 "ThreadVideoLoader"):
        cfg = preset_cfg("m3det_normal")
        cfg.loader.name = name
        mdrf, launches, wall = _run_m3(frames, cfg, "cuda")
        _require_launches(name, launches)
        got = _records(mdrf)
        if name == "ProcessVideoLoader":
            if _dicts(mdrf) != _dicts(ref):
                fail(f"{name}: MDRF differs from the Block loader's: "
                     f"{_dicts(mdrf)} vs {_dicts(ref)}")
        else:
            def key(t):
                d = t.to_dict()
                return {k: v for k, v in d.items()
                        if k not in ("score", "recheck_score",
                                     "aesthetic_score",
                                     "relative_brightness")}
            if [key(t) for t in got] != [key(t) for t in want] or any(
                    abs(a.score - b.score) > 0.03
                    or abs((a.recheck_score or 0) - (b.recheck_score or 0))
                    > 0.03 for a, b in zip(got, want)):
                fail(f"{name}: targets differ from the Block loader's: "
                     f"{got} vs {want}")
        print(f"loaders: {name} in {wall:.3f} s on {card}: {len(got)} "
              f"target(s) agree with the Block loader's; scores "
              f"{[(t.score, t.recheck_score) for t in got]} vs "
              f"{[(t.score, t.recheck_score) for t in want]}; launches "
              f"{launches}", flush=True)


def phase_checkpoint(card: str) -> None:
    """Resume from a checkpoint of the first block (written on the card,
    then by a CPU run) and get the uninterrupted METEOR."""
    frames, _, _ = synth_clip(W, H, 8.0, 3.5, 5.5, color=False)
    cfg = lambda: preset_cfg("m3det_normal", recheck=False)   # noqa: E731

    def meteors(mdrf):
        return [(t.start_time, t.pt1, t.pt2) for t in _records(mdrf)
                if t.category == "METEOR"]

    full, launches, _ = _run_m3(frames, cfg(), "cuda")
    _require_launches("checkpoint (uninterrupted)", launches)
    if not meteors(full):
        fail("checkpoint: no METEOR in the uninterrupted run")
    os.makedirs(FILES, exist_ok=True)
    for writer in ("cuda", "cpu"):
        ckpt = os.path.join(FILES, f"state_{writer}.npz")
        _run_m3(frames[:T_BLOCK], cfg(), writer, checkpoint_path=ckpt,
                checkpoint_interval_sec=1e9)
        resumed, launches, wall = _run_m3(
            frames, cfg(), "cuda", checkpoint_path=ckpt, resume=True,
            checkpoint_interval_sec=1e9)
        _require_launches(f"checkpoint (resumed from {writer})", launches)
        if meteors(resumed) != meteors(full):
            fail(f"checkpoint written on {writer}: resumed METEOR "
                 f"{meteors(resumed)}, uninterrupted {meteors(full)}")
        os.remove(ckpt)
        print(f"checkpoint written on {writer}, resumed on {card} in "
              f"{wall:.3f} s: METEOR {meteors(resumed)} equals the "
              f"uninterrupted run's", flush=True)


def _photo_sky(rng, w: int, h: int, streak: bool,
               long: bool = False) -> np.ndarray:
    """A colour night-sky photo: noise, stars and, if asked, a streak:
    short (3-7% of the width), or ``long`` (15-25%, hundreds of pixels at
    1920x1080), which the tile pyramid returns as a chain of boxes with
    near-equal scores."""
    import cv2
    img = rng.normal(14, 3, (h, w)).astype(np.float32)
    for x, y, a in zip(rng.uniform(0, w, 300), rng.uniform(0, h, 300),
                       rng.uniform(30, 200, 300)):
        cv2.circle(img, (int(x), int(y)), 1, float(a), -1)
    if streak:
        x1, y1 = rng.uniform(0.05 * w, 0.6 * w), rng.uniform(0.05 * h,
                                                             0.5 * h)
        span = (0.15, 0.25) if long else (0.03, 0.07)
        length, ang = rng.uniform(span[0] * w, span[1] * w), rng.uniform(
            0.2, 0.9 if long else 1.3)
        x2, y2 = x1 + length * np.cos(ang), y1 + length * np.sin(ang)
        cv2.line(img, (int(x1), int(y1)), (int(x2), int(y2)), 220.0, 3)
        img = cv2.GaussianBlur(img, (5, 5), 1.2)
    u8 = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(u8[..., None], 3, -1)


def _photo_records(argv, dev: str) -> tuple[dict, float]:
    from metdetpy_tpu_torch import photo
    from metdetpy_tpu_torch.models import yolo
    out = os.path.join(FILES, f"photo_{dev}.json")
    yolo.CALLS.clear()
    t0 = time.perf_counter()
    photo.main([*argv, "--device", dev, "--save-path", out])
    wall = time.perf_counter() - t0
    with open(out, encoding="utf-8") as f:
        data = json.load(f)
    os.remove(out)
    return data, wall


def _photo_boxes(data) -> dict:
    """{image (or timelapse frame): [(box, class, score), ...]}."""
    out = {}
    for r in data["results"]:
        key = r.get("img_filename") or r.get("num_frame")
        out[key] = list(zip(r["boxes"], r["preds"], map(float, r["prob"])))
    return out


def _linked(boxes, others) -> bool:
    """Every box of ``boxes`` scoring above 0.53 overlaps a box of the
    same class in ``others``."""
    return all(any(p == pred and a1 <= x2 and x1 <= a2 and b1 <= y2
                   and y1 <= b2 for (a1, b1, a2, b2), p, _ in others)
               for (x1, y1, x2, y2), pred, prob in boxes if prob > 0.53)


def _top_scores_close(a, b) -> bool:
    """Per class, the top scores above 0.53 agree within 0.03 (a class
    above it on one side is above it on the other)."""
    def top(boxes):
        out = {}
        for _, pred, prob in boxes:
            out[pred] = max(out.get(pred, 0.0), prob)
        return {k: v for k, v in out.items() if v > 0.53}
    ta, tb = top(a), top(b)
    return set(ta) == set(tb) and all(abs(ta[k] - tb[k]) <= 0.03 + 1e-9
                                      for k in ta)


def _photo_close(name: str, got: dict, want: dict) -> None:
    """The entry point's bfloat16 records on the card against the CPU's,
    per image (or timelapse frame), both ways: each box scoring above
    sqrt(0.25) + 0.03 overlaps a box of the same class on the other side,
    and the top scores of each class agree within 0.03. The boxes are not
    paired one to one: bfloat16 on the card and on the CPU rounds the
    boxes apart by a few pixels and keeps other links of a streak's chain
    of boxes (a 6 px shift at an equal score; a link kept at 0.77 on the
    CPU where the card kept a neighbour at 0.52). A float32 run of the
    model keeps other links too (a middle link at 0.65 on the CPU only)."""
    g, w = _photo_boxes(got), _photo_boxes(want)
    bad = [k for k in set(g) | set(w)
           if not (_linked(g.get(k, []), w.get(k, []))
                   and _linked(w.get(k, []), g.get(k, []))
                   and _top_scores_close(g.get(k, []), w.get(k, [])))]
    if got["type"] != want["type"] or bad:
        fail(f"photo, {name}: records on the card differ from the CPU's "
             f"at {bad}: {got['results']} vs {want['results']}")


def phase_photo(card: str) -> None:
    """The photo entry point on the card against the CPU: a folder of 64
    colour 1920x1080 JPEGs, one of them alone, a 64-frame timelapse."""
    import cv2
    from metdetpy_tpu_torch.models import yolo
    from metdetpy_tpu_torch.synth import write_video
    rng = np.random.default_rng(SEED + 3)
    folder = os.path.join(FILES, "photos")
    os.makedirs(folder, exist_ok=True)
    for i in range(64):   # a streak in every fourth, long in every 16th
        cv2.imwrite(os.path.join(folder, f"sky_{i:02d}.jpg"),
                    _photo_sky(rng, 2 * W, 2 * H, i % 4 == 0,
                               long=i % 16 == 0),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    # timelapse frames are photos of their own, a short streak in every
    # fourth (a synthetic video's meteor leaves a glowing trail, the long
    # chain of near-equal boxes the photos avoid)
    video = os.path.join(FILES, "timelapse.avi")
    write_video(np.stack([_photo_sky(rng, W, H, i % 4 == 0)
                          for i in range(64)]), video, fps=FPS)
    single = os.path.join(folder, "sky_00.jpg")
    for name, target, n in ((f"folder of 64 JPEGs {2 * W}x{2 * H}", folder,
                             64),
                            (f"one JPEG {2 * W}x{2 * H}", single, 1),
                            (f"timelapse AVI of 64 frames {W}x{H}", video,
                             64)):
        got, wall = _photo_records([target], "cuda")
        nets = yolo.CALLS["network"]
        want, cpu_wall = _photo_records([target], "cpu")
        _photo_close(name, got, want)
        if name.startswith("folder") and not got["results"]:
            fail("photo: no detection in the folder")
        print(f"photo, {name}: {n / wall:.2f} images/s on {card} "
              f"({wall:.3f} s with the model's load, {nets} network "
              f"forwards); {len(got['results'])} record(s) agree with the "
              f"CPU's ({cpu_wall:.1f} s): linked boxes, top scores within "
              f"0.03", flush=True)


BG_ALGOS = ("mean", "median", "sigma-clipping", "med-of-med")


def _denoise_cfg(bg: str):
    """global/clip_cfg.json's denoise options, MFNR with background
    ``bg`` (connect_lines on, as shipped)."""
    from metdetpy_tpu_torch.structs import ClipCfg
    from metdetpy_tpu_torch.utils import relative2abs_path
    dn = ClipCfg.from_json_file(
        relative2abs_path("./global/clip_cfg.json")).image_denoise
    dn.algorithm = "mfnr-mix"
    dn.mfnr_param.bg_algorithm = bg
    return dn


def _mfnr(frames, bg: str, dev: str, env: dict) -> tuple:
    """mfnr_mix_stacker through the port's ThreadVideoLoader on an
    in-memory clip; returns (image, last_run_stats, wall seconds)."""
    from metdetpy_tpu_torch.io.videoloader import ThreadVideoLoader
    from metdetpy_tpu_torch.io.videowrapper import NumpyVideoWrapper
    from metdetpy_tpu_torch.ops import stack, stack_device
    loader = ThreadVideoLoader(NumpyVideoWrapper, frames,
                               exp_option="real-time", merge_func="max",
                               grayscale=False)
    stack_device.last_run_stats.clear()
    with env_set(env):
        t0 = time.perf_counter()
        out = stack.mfnr_mix_stacker(loader, _denoise_cfg(bg), device=dev)
        wall = time.perf_counter() - t0
    loader.release()
    if out is None or out.shape != frames.shape[1:] or out.dtype != np.uint8:
        fail(f"MFNR {bg} on {dev}: no image of the clip's shape")
    return out, dict(stack_device.last_run_stats), wall


def _within_one(name: str, got: np.ndarray, want: np.ndarray) -> str:
    """Fail unless ``got`` is within +/-1 of ``want`` in under 2% of the
    pixels (the JAX package's bar for its device MFNR against its host
    path)."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((d > 0).mean())
    if got.shape != want.shape or d.max() > 1 or share >= 0.02:
        fail(f"{name}: max |diff| {d.max()}, {share:.4%} of pixels differ")
    return f"max |diff| {d.max()}, {share:.4%} of pixels differ"


MFNR_RUNS = [(bg, "full-upload", {"METDETPY_TPU_MFNR_HOST_REDUCE": "0"}
              if bg == "mean" else {}) for bg in BG_ALGOS] + [
    ("mean", "host-reduced-upload", {"METDETPY_TPU_MFNR_HOST_REDUCE": "1"})]


def phase_denoise(card: str) -> None:
    """Denoise and clip export on the card: device MFNR of a 64-frame
    1920x1080 colour clip with every background (timed), the same held
    against the host path at 960x540, the device median against the host
    median, and ``python -m metdetpy_tpu_torch.clip`` on the card against
    the CPU."""
    from metdetpy_tpu_torch import clip
    from metdetpy_tpu_torch.ops import stack
    from metdetpy_tpu_torch.synth import write_video
    n = 64
    big, _, _ = synth_clip(2 * W, 2 * H, n / FPS, 0.8, 1.8, color=True,
                           n_stars=300)
    for bg, placement, env in MFNR_RUNS:
        for run in ("first", "second"):
            _, st, wall = _mfnr(big, bg, "cuda", {
                "METDETPY_TPU_DEVICE_DENOISE": "force", **env})
            if st.get("placement") != placement:
                fail(f"MFNR {bg}: placement {st.get('placement')}, asked "
                     f"for {placement}")
            print(f"denoise MFNR {bg}, {placement}, {run} run: {n} frames "
                  f"{2 * W}x{2 * H} colour in {wall:.3f} s = "
                  f"{n / wall:.2f} frames/s on {card}; decode_acc_s "
                  f"{st.get('decode_acc_s')}, upload_s "
                  f"{st.get('upload_s')}, device_math_fetch_s "
                  f"{st.get('device_math_fetch_s')}, h2d_bytes "
                  f"{st.get('h2d_bytes')}, window_px_frac "
                  f"{st.get('window_px_frac')}, host_stage_s "
                  f"{st.get('host_stage_s')}", flush=True)
    _time_mfnr_upload(card, big)
    small, _, _ = synth_clip(W, H, n / FPS, 0.8, 1.8, color=True)
    for bg, placement, env in MFNR_RUNS:
        got, st, wall = _mfnr(small, bg, "cuda",
                              {"METDETPY_TPU_DEVICE_DENOISE": "force",
                               **env})
        want, _, host_wall = _mfnr(small, bg, "cuda",
                                   {"METDETPY_TPU_DEVICE_DENOISE": "0"})
        if st.get("placement") != placement:
            fail(f"MFNR {bg} at {W}x{H}: placement {st.get('placement')}")
        print(f"denoise MFNR {bg}, {placement}, {W}x{H}: card {wall:.3f} s "
              f"vs the host path {host_wall:.3f} s: "
              f"{_within_one(f'MFNR {bg} {placement}', got, want)}",
              flush=True)

    frames = list(big)
    with env_set({"METDETPY_TPU_DEVICE_MEDIAN": "force"}):
        t0 = time.perf_counter()
        med = stack.stack_median(frames, device="cuda")
        dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = stack._host_median(frames)
    host_s = time.perf_counter() - t0
    if med.dtype != host.dtype or not np.array_equal(med, host):
        fail("stack_median on the card differs from the host median")
    print(f"stack_median of {n} frames {2 * W}x{2 * H} colour forced to "
          f"{card}: {dev_s:.3f} s (pinning, upload, sort, fetch) vs the host "
          f"median {host_s:.3f} s; equal", flush=True)

    os.makedirs(FILES, exist_ok=True)
    video = os.path.join(FILES, "clip_src.avi")
    src, _, _ = synth_clip(W, H, 5.0, 1.0, 2.4, color=True)
    write_video(src, video, fps=FPS)
    reqs = os.path.join(FILES, "requests.json")
    with open(reqs, "w", encoding="utf-8") as f:
        json.dump([{"time": ["00:00:00.800", "00:00:02.600"],
                    "target": [{"pt1": [int(W * .25), int(H * .2)],
                                "pt2": [int(W * .5), int(H * .6)],
                                "preds": "METEOR", "prob": "0.9"}]},
                   {"time": ["00:00:03.000", "00:00:04.000"]}], f)
    want_frames = [45, 25]
    for mode, extra in (("image", []), ("simple", ["--denoise", "simple"]),
                        ("mfnr-mix", ["--denoise", "mfnr-mix"]),
                        ("video", ["--with-bbox"])):
        outs, walls = {}, {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(FILES, f"clip_{mode}_{dev}")
            os.makedirs(out)
            t0 = time.perf_counter()
            clip.main([video, reqs, "--mode",
                       "video" if mode == "video" else "image", "--suffix",
                       "avi" if mode == "video" else "png", "--save-path",
                       out, "--device", dev, *extra])
            walls[dev] = time.perf_counter() - t0
            outs[dev] = [_read_clip_output(os.path.join(out, x))
                         for x in sorted(os.listdir(out))]
        if len(outs["cuda"]) != 2 or len(outs["cpu"]) != 2:
            fail(f"clip {mode}: {len(outs['cuda'])} / {len(outs['cpu'])} "
                 "outputs for 2 requests")
        for got, want, n_want in zip(outs["cuda"], outs["cpu"],
                                     want_frames):
            if mode == "mfnr-mix":
                note = _within_one("clip mfnr-mix", got, want)
            elif got.shape != want.shape or not np.array_equal(got, want):
                fail(f"clip {mode}: the card's output differs from the CPU's")
            else:
                note = "equal"
            if mode == "video" and got.shape[0] != n_want:
                fail(f"clip video: {got.shape[0]} frames, {n_want} asked")
        print(f"clip {mode}: 2 requests on {card} in {walls['cuda']:.3f} s, "
              f"on the CPU in {walls['cpu']:.3f} s; outputs "
              f"{[o.shape for o in outs['cuda']]} against the CPU's: {note}",
              flush=True)
    shutil.rmtree(FILES)


def _time_mfnr_upload(card: str, frames: np.ndarray) -> None:
    """The full-upload MFNR's transfer alone: the clip staged into pinned
    memory and copied in 16-frame blocks as ``mfnr_mix_device`` does, and
    the copy alone of the whole clip from pinned memory."""
    from metdetpy_tpu_torch.ops.stack_device import (DEVICE_BLOCK,
                                                     _BlockUploader)
    dev = torch.device("cuda")
    upload = _BlockUploader(dev)
    staged = []
    for _ in range(2):   # the second pass reuses the pinned buffers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(frames), DEVICE_BLOCK):
            upload(list(frames[i:i + DEVICE_BLOCK]))
        torch.cuda.synchronize()
        staged.append(time.perf_counter() - t0)
    pinned = torch.from_numpy(frames).pin_memory()
    dst = torch.empty(pinned.shape, dtype=torch.uint8, device=dev)
    dst.copy_(pinned, non_blocking=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.copy_(pinned, non_blocking=True)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    print(f"denoise MFNR upload of {frames.nbytes} B on {card}: staged and "
          f"copied in {DEVICE_BLOCK}-frame blocks {staged[0]:.4f} s (first "
          f"pass, pinning included) and {staged[1]:.4f} s; the copy alone "
          f"from pinned memory {copy_s:.4f} s = "
          f"{frames.nbytes / copy_s / 1e9:.2f} GB/s", flush=True)


def _read_clip_output(path: str) -> np.ndarray:
    """A PNG, or every frame of an AVI, decoded."""
    import cv2
    if path.endswith(".png"):
        return cv2.imread(path)
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a GPU")
    from metdetpy_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    K.build_kernels()
    print(f"built {len(K.SOURCES)} kernels in {time.perf_counter() - t0:.1f}"
          f" s into {K.BUILD_DIR}", flush=True)
    for name in K.SOURCES:
        log = os.path.splitext(K._lib_path(K.SOURCES[name][0]))[0] + ".log"
        if os.path.isfile(log):
            with open(log) as f:
                info = [ln.strip() for ln in f if "Used" in ln or
                        "spill" in ln]
            print(f"ptxas {name}: {' | '.join(info)}", flush=True)
            if any("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                   "loads" not in ln for ln in info):
                fail(f"{name}: ptxas reports register spills")
    rows = phase_kernels(dev)
    phase_ragged(dev)
    launches = phase_end_to_end(card)
    phase_card_vs_cpu()
    phase_model(card)
    phase_dldet(card)
    phase_classic(card)
    phase_feed_1080p(card)
    phase_loaders(card)
    phase_checkpoint(card)
    phase_photo(card)
    phase_denoise(card)
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
