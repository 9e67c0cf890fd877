"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. Build: print the card's name and power limit, build the five CUDA
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
   empty kernel of its grid; the peak ladder runs on the vote's output.
   Then the ragged cases of ``metdetpy_tpu_torch.ops.kernel_cases`` for
   the vote, the pick and the peak ladder (with ``find_peaks`` on each peak
   case), exact, untimed.
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
   launched and one capture of ``_classic_block_step``'s CUDA graph
   (``detectors/step_graph.py``); a detector that adopts that graph: a
   block's replay in device ms, the host ms a block of the replay and of
   the eager step; on a small clip the card's MDRF (through the graph)
   equal to the CPU's.
8. Device feed at camera size: ``m3det_normal`` (recheck off) on a gray
   1920x1080, 25 fps clip of 256 frames with one meteor, detected at
   960x540: once with the preprocess on the device (forced: raw blocks
   uploaded, the exact 2:1 downscale run by the uploader), once with the
   loader's upload off (host preprocess, the detector uploads), once
   placed by the loader's probe; the MDRFs equal and equal to the CPU's,
   the placement as asked, bytes uploaded by the loader, all five kernels
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

13. Multistream M3: ``parallel.multistream.detect_multi_stream`` with
   m3det_normal's detector as shipped (n = 25) over 8 gray 960x540 streams
   of 256 frames in 64-frame blocks (BASELINE.json configuration 5 at its
   analysis resolution; meteors in three streams at different times), the
   8 streams' shards laid on the one card (``shared_mesh``), each block one
   replay of the step's CUDA graph: one capture, launches of two warm-ups
   plus the replays (a replay: one window_diff and one
   median_binarize_close for all streams, 64 of each Hough kernel); a
   second run in the process adopts the graph (no capture, replays only,
   the same records); each stream's packed rows equal its own M3 step's
   bit for bit (the sharded programs' fold of the diff area) and its
   records its own M3Detector run's; aggregate frames/s of both runs, the
   capture's seconds and pool bytes, host ms a block, a replay's device
   ms, the idle share of a profiled block. With 2 or more cards, also
   ``build_mesh(k)`` (k = 2, 4 or 8), a graph a card, held to the shared
   mesh bit for bit.
14. Multistream dldet: dldet.json's detector over 4 colour 960x544
   streams, 2 blocks of 64 merged frames, against each stream's own
   MLDetector run (boxes within 2 px, scores within 0.03).
15. Temporal shards: ``temporal_m3_detect`` over 512 gray 960x540 frames
   on 4 shards of the card, bit for bit against ``_m3_block_step`` over
   the whole block, and in 4 super-blocks of 128 against the whole clip;
   ``detect_frames_temporal``'s records; ``python -m metdetpy_tpu_torch
   <200-frame 960x540 MJPG AVI> --temporal-shards 1 --temporal-super-block
   4`` against ``detect_video_temporal``'s whole-clip mode;
   ``detect_frames_temporal_dldet`` on 2 shards against MLDetector's
   records.
16. Data-parallel: ``BatchPipeline`` over a 2-shard mesh on the card (11
   images, padded to 12) against the unsharded pipeline, and
   ``python -m metdetpy_tpu_torch.photo --data-parallel 2`` on one card
   ending with "need 2 devices, have 1".
17. Train and evaluate: full-width YOLOv5s at ``fit_synthetic``'s
   defaults (320x320, batch 8, nc 8). (a) One step from the shipped
   weights in a float32 body on the card against the CPU (loss rtol 1e-5,
   every gradient rtol 2e-4 with atol 2e-4 x max|g|), then in the shipped
   bfloat16 body (loss within 1% of the float32 CPU loss, gradients
   finite). (b) 8 bfloat16 steps on a fixed batch from ``init_params``
   with Adam 3e-3: the last loss under 0.8x the first; a step's device
   time (CUDA events behind a device sleep), its host-paced time and the
   idle share of a profiled step. (c) ``python -m
   metdetpy_tpu_torch.train --steps 40 --device cuda``'s entry point
   (steps/s, host ``synth_batch`` seconds a step, peak device memory); the
   npz it writes loaded through ``YOLOModel`` gives the trained module's
   heads bit for bit. (d) ``python -m metdetpy_tpu_torch.evaluate
   --metric`` on the annotated 256x144 clip on the card and on the CPU:
   recall 1.0 and the same summary.

18. Bench: ``python -m metdetpy_tpu_torch.bench``'s entry (``main``)
   in-process for every mode at reduced depth through the mode's own
   arguments and knobs (1-6 s clips, one pass; the default mode at full
   width, a 1920x1080 clip detected at 960x540, with the launch counts set
   to 0 just before it and read just after): exactly one JSON line each,
   with the JAX harness's keys and the card's name; ``meteor_found`` true
   where a mode reports it, a meteor in every stream of the sharded modes
   and lines in every feed of the multistream mode; the active-sky worst
   case dense (``min_npix`` > 1024, ``overflow_rate`` <= 0.01). Before
   that, a quiet 960x540 block and two active-sky blocks
   (``bench.worstcase_frames``) through ``M3Detector.process_block_async``
   on the card and on the CPU: the packed buffers equal.
19. Frozen build and trace: (a) ``make_package_zipapp.py --package
   metdetpy_tpu_torch --tools MetDetPy`` into a temporary directory, the
   ``.pyz`` run on the 200-frame 960x540 MJPG AVI of phase 15 (m3det_normal
   as shipped, recheck on, real-time) with a fresh ``HOME`` from a working
   directory outside the repo on the default device: its MDRF ``results``
   equal the in-tree main entry's (``metdetpy_tpu_torch.__main__.main``,
   in-process, all five kernels launched), the fresh cache holds the five
   kernel libraries under the in-tree build's hashed names, cold and warm
   seconds, and a third run with ``METDETPY_TPU_TRACE_DIR`` set whose
   trace holds a device event for each launch of the five kernels. (b)
   ``detect_video`` on the same clip untraced and traced: records and
   launches equal, frames/s of both, the trace parses and holds a device
   event for each launch of each kernel, their summed device ms beside
   phase 2's per-launch ms times the run's launches. Each run in-process
   starts with no idle graph of the M3 step (``step_graph.clear_idle``),
   so that it captures as a fresh process does.

20. Dry run: ``metdetpy_tpu_torch.dryrun`` in-process, ``entry()``'s
   M3 step (216x384, T=16) and ``dryrun_multichip(8, shared=True)``'s six
   programs with the 8 shards on the card, the launch counts set to 0 just
   before and read just after: the step and programs 1-3 (the stream
   step with its cross-stream total, the temporal step, two carried
   super-blocks) equal to the same on the CPU bit for bit, program 5's 11
   results and program 6's carried tail (on a machine of 2 or more cards,
   also ``dryrun_multichip(n)`` with a card a shard, n = the cards up to
   8, held the same way); then ``python -m
   metdetpy_tpu_torch.dryrun 8 --shared`` in a subprocess: exit 0 and its
   seven lines.

21. Stage profiles: ``python -m metdetpy_tpu_torch.profile_step``'s
   entry (``main``) in-process for ``block``, ``dense`` and ``split`` with
   ``--quick`` at 960x540 and 64-frame blocks, the launch counts set to 0
   just before and read just after: each stage's line (slope, device time
   from the profiler, CUDA-graph time, launches) printed; it fails if a
   capture raises, a graph replay differs from its eager call or a
   profiler window lacks a record of a kernel launch.

22. The step as one program a block: (a) one ``M3Detector`` at 960x540
   runs 27 consecutive 64-frame blocks (the warm-up and all 25 phases of
   the EMA's interval against the block) through its CUDA graph
   (``detectors/step_graph.py``), the launch counts set to 0 just before
   and read just after; each block's packed buffer, dst, every carry and
   the timer equal the eager ``_m3_block_step`` chain on the card bit for
   bit, and blocks 0, 1, 13 and 26, run on the CPU from the same carries,
   give the same packed buffers; it prints the capture's seconds and pool
   bytes, a replay's device ms, the host ms a block of the graph and of
   the eager step and the host's CUDA runtime calls of one block of each;
   a second detector of the same shapes replays the first one's graph
   without a capture, and a third beside it captures its own, released
   when both are dropped. (b) ``detect_video`` with m3det_normal (recheck
   off) on (a)'s clip at 1920x1080 (each pixel 2x2), four times over (1024
   frames in memory), detected at 960x540 by a detector that adopts (a)'s
   graph: frames/s, ``dispatch_s``, host ms a block; then every capture
   of the process. Every earlier phase that runs an ``M3Detector`` on the
   card runs it through its graph too.

Phase 2 also times window_diff over 8 streams in one launch (frames
[8, 64, 540, 960], the history a view of the block before), exact against
its plain version; the ragged cases include window_diff's stream axis.

Phases 3 and 6 run the presets as ``detect_video`` sets them up: the
loader uploads each block from pinned memory in its uploader thread; they
require bytes uploaded by it, and phase 6 also times a 12-block dldet run
with that upload off, in the same call.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. It imports nothing
of JAX or of the JAX package, and exits non-zero without a card.
"""

import contextlib
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
HOUGH_THRESHOLD = 10        # config/m3det_normal.json hough_threshold
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
    from metdetpy_tpu_torch.ops import hough
    from metdetpy_tpu_torch.ops import kernels as K
    wd, mbc, vote, pick, counts, geom = kernel_inputs(dev)
    hw = H * W
    n_valid = int(counts.sum())
    inside = (geom.r >= 0) & (geom.r < pick[0].shape[-1])
    n_pick = int(inside.sum())
    # the vote kernel's chunk of votes, with the main path's threshold
    peaks = (K.hough_vote(*vote), HOUGH_THRESHOLD,
             hough._peak_cuts(HOUGH_THRESHOLD, dev))
    return {
        "window_diff": (
            K.window_diff, K.window_diff_plain,
            # the frame timer as the step carries it, on the card
            (*wd, N_WIN, torch.tensor(10, dtype=torch.int32, device=dev)),
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
        "peak_ladder": (
            K.peak_ladder, K.peak_ladder_plain, peaks,
            "metdetpy_tpu_torch/csrc/peak_ladder.cu",
            "metdetpy_tpu/ops/hough.py:220 (_find_peaks, plain XLA)",
            # the chunk's i32 votes in, a u8 mask out (and the tiny rung
            # count); per bin: the 3x3 max (8) and the test (2)
            bound(peaks[0].numel() * 5 + (len(peaks[2]) + 1)
                  * FRAME_CHUNK * 4, peaks[0].numel() * 10)),
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


def stream_window_diff_times(dev: torch.device) -> dict:
    """window_diff over 8 streams in one launch, the multistream block's
    shape: frames [8, 64, 540, 960] and, as the detector carries it, the
    history a view of each stream's last 24 frames of the block before
    (streams 64 frames apart). Exact against the plain version, then warm
    and cold ms beside the bound."""
    from metdetpy_tpu_torch.ops import kernels as K
    g = torch.Generator(device=dev).manual_seed(SEED)
    prev = torch.randint(0, 256, (N_STREAMS, T_BLOCK, H, W), generator=g,
                         device=dev, dtype=torch.uint8)
    frames = torch.randint(0, 256, (N_STREAMS, T_BLOCK, H, W), generator=g,
                           device=dev, dtype=torch.uint8)
    args = (prev[:, T_BLOCK - (N_WIN - 1):], frames, N_WIN,
            torch.tensor(10, dtype=torch.int32, device=dev))
    err = check_exact("window_diff, 8 streams", K.window_diff,
                      K.window_diff_plain, args)
    hw = H * W
    # per stream: read n-1+T frames, write T (the new history is a view)
    b_ms, b_by = bound(N_STREAMS * (N_WIN - 1 + 2 * T_BLOCK) * hw,
                       7 * N_STREAMS * T_BLOCK * hw)
    out = {"stream_shape": f"frames [{N_STREAMS}, {T_BLOCK}, {H}, {W}], "
                           f"history a view [{N_STREAMS}, {N_WIN - 1}, {H}, "
                           f"{W}]",
           "stream_max_abs_err": err,
           "stream_ms": cuda_ms(lambda: K.window_diff(*args), 20),
           "stream_cold_ms": cold_ms(K.window_diff, args),
           "stream_plain_ms": cuda_ms(lambda: K.window_diff_plain(*args), 3,
                                      1),
           "stream_bound_ms": b_ms, "stream_bound_by": b_by}
    print(f"kernel window_diff, {out['stream_shape']}: exact; "
          f"{out['stream_ms']:.4f} ms warm, {out['stream_cold_ms']:.4f} ms "
          f"cold (plain {out['stream_plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
          f"by {b_by})", flush=True)
    del prev, frames, args
    torch.cuda.empty_cache()
    return out


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
        if name == "window_diff":
            rows[name].update(stream_window_diff_times(dev))
        if name == "walk_pick":
            rows[name]["floor_ms"] = cuda_ms(
                lambda: K.walk_pick_floor(*args), 20)
            print(f"kernel {name}: an empty kernel of its grid takes "
                  f"{rows[name]['floor_ms']:.4f} ms (bound {b_ms:.4f} ms)",
                  flush=True)
    return rows


def phase_ragged(dev: torch.device) -> None:
    """hough_vote, walk_pick and peak_ladder against their plain versions
    on the ragged cases, exact; find_peaks on the card against its plain
    route on the peak cases."""
    from metdetpy_tpu_torch.ops import hough
    from metdetpy_tpu_torch.ops import kernel_cases as C
    from metdetpy_tpu_torch.ops import kernels as K
    for case in C.VOTE_CASES:
        check_exact(f"hough_vote case {case[0]}", K.hough_vote,
                    K.hough_vote_plain, C.vote_case(case, dev, SEED))
    for case in C.PICK_CASES:
        check_exact(f"walk_pick case {case[0]}", K.walk_pick,
                    K.walk_pick_plain, C.pick_case(case, dev, SEED))
    for case in C.PEAK_CASES:
        args = C.peak_case(case, dev, SEED)
        K.reset_launch_counts()
        check_exact(f"peak_ladder case {case[0]}", K.peak_ladder,
                    K.peak_ladder_plain, args)
        if K.LAUNCHES["peak_ladder"] != 1:
            fail(f"peak_ladder case {case[0]}: "
                 f"{K.LAUNCHES['peak_ladder']} launches, expected 1")
        check_exact(f"find_peaks case {case[0]}",
                    lambda v, t, _: hough.find_peaks(v, t, C.PEAK_MAX),
                    lambda v, t, _: hough.find_peaks_plain(v, t, C.PEAK_MAX),
                    args)
    for case in C.WINDOW_DIFF_STREAM_CASES:
        K.reset_launch_counts()
        check_exact(f"window_diff stream case {case[0]}", K.window_diff,
                    K.window_diff_plain,
                    C.window_diff_stream_case(case, dev, SEED))
        if K.LAUNCHES["window_diff"] != 1:
            fail(f"window_diff stream case {case[0]}: "
                 f"{K.LAUNCHES['window_diff']} launches, expected 1")
    print(f"ragged cases: {len(C.VOTE_CASES)} of hough_vote, "
          f"{len(C.PICK_CASES)} of walk_pick, {len(C.PEAK_CASES)} of "
          f"peak_ladder and find_peaks and "
          f"{len(C.WINDOW_DIFF_STREAM_CASES)} of window_diff's stream axis "
          f"(one launch each) exact", flush=True)


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
    """ClassicDetector through detect_video on the card at 960x540, each
    block one replay of ``_classic_block_step``'s CUDA graph; a replay's
    device ms and the host ms a block of the graph and of the eager step;
    the card's MDRF against the CPU's on a small clip."""
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.detectors import step_graph
    from metdetpy_tpu_torch.detectors.m3det import (ClassicDetector,
                                                    _classic_block_step)
    from metdetpy_tpu_torch.log import BaseMetLog
    from metdetpy_tpu_torch.ops import kernels as K
    from metdetpy_tpu_torch.utils import get_num_class
    frames, _, _ = synth_clip(W, H, 128 / FPS, 1.5, 3.5, color=False)
    cfg = preset_cfg("m3det_normal", detector="ClassicDetector",
                     recheck=False)
    step_graph.clear_idle()
    n_caps = len(step_graph.CAPTURES)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    mdrf = detect_video(frames, None, cfg, work_mode="backend",
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if launches["hough_vote"] <= 0 or launches["walk_pick"] <= 0:
        fail(f"ClassicDetector did not launch the Hough kernels: {launches}")
    caps = [c for c in step_graph.CAPTURES[n_caps:]
            if c["step"] == "_classic_block_step"]
    if len(caps) != 1:
        fail(f"ClassicDetector: {len(caps)} captures of its step")
    gc.collect()
    # a block on the card and on the host, by a detector that adopts the
    # run's graph; the eager step on the same carries beside it
    det = ClassicDetector(cfg.detector.window_sec, FPS,
                          np.ones((H, W), np.uint8), get_num_class(),
                          cfg.detector.cfg, BaseMetLog(), device="cuda")
    blk = torch.from_numpy(frames[:T_BLOCK]).cuda()
    det.process_block_async(blk)
    if len(step_graph.CAPTURES) != n_caps + 1:
        fail("ClassicDetector: a second detector did not adopt the graph")
    replay_ms = cuda_ms(lambda: det.process_block_async(blk), 5)
    graph_host_ms = _host_ms(lambda: det.process_block_async(blk), 10)
    eager_host_ms = _host_ms(lambda: _classic_block_step(
        det._gray_hist, det._sub_hist, det._classic_hist, det._ema, blk,
        det._timer_dev, **det._step_static_kwargs()), 5)
    del det, blk
    cap = caps[0]
    print(f"classic: {frames.shape[0]} frames {W}x{H} (point budget "
          f"{min(max(8192, W * H // 8), 1 << 16)}) in {wall:.3f} s on {card},"
          f" its step's capture {cap['seconds']:.3f} s after warm-ups of "
          f"{cap['warmup_seconds']:.3f} s, pool {cap['pool_bytes']} bytes, "
          f"launches a replay {cap['launches']}; {len(mdrf.results)} "
          f"record(s); launches {launches}; a block on the card "
          f"{replay_ms:.4f} ms (replay with its input copy and output "
          f"clones); host ms a block {graph_host_ms:.4f} (graph) against "
          f"{eager_host_ms:.4f} (eager step)", flush=True)
    small, _, _ = synth_clip(256, 144, 6.5, 2.4, 4.4, color=False,
                             n_stars=40, seed=7)
    got = {}
    n_caps = len(step_graph.CAPTURES)
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
    keys = [c["key"][1] for c in step_graph.CAPTURES[n_caps:]
            if c["step"] == "_classic_block_step"]
    if not keys:
        fail("ClassicDetector: the small clip's run captured no graph")
    print(f"classic card vs cpu: {len(got['cuda'])} MDRF record(s) equal; "
          f"the card's run through its step's graph (captured for blocks "
          f"{keys})", flush=True)
    step_graph.clear_idle()


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


# ---------------------------------------------------------------------------
# The parallel package: multistream M3 and dldet, temporal shards,
# data-parallel photo. The tests' and the smoke's meshes lay their shards on
# the one card (parallel.mesh.shared_mesh): shards that share a device are a
# batch axis of each call.

N_STREAMS, STREAM_FRAMES = 8, 256


def _rt(w: int, h: int, fps: float):
    from metdetpy_tpu_torch.structs import RuntimeParams
    return RuntimeParams(fps=fps, exp_frame=1, eq_fps=fps,
                         eq_int_fps=max(int(fps), 1), exp_time=1 / fps,
                         runtime_size=[w, h], raw_size=[w, h],
                         positive_category_list=["METEOR"])


def _gray_streams() -> tuple[np.ndarray, list]:
    """[8, 256, 540, 960] u8: a meteor in streams 1, 4 and 6 at different
    times (one synthetic clip rolled in time), the other five meteor-free
    (a 64-frame sky tiled over 256 frames, rolled and flipped)."""
    from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
    sky = generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=STREAM_FRAMES / FPS,
        meteors=[SynthMeteor(start_sec=1.0, end_sec=2.6,
                             pt1=(W * 2 // 3, H * 2 // 9),
                             pt2=(W * 2 // 5, H * 3 // 5))], n_stars=150,
        noise_sigma=3.0, seed=SEED + 5)
    quiet = np.tile(generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=64 / FPS, meteors=[],
        n_stars=150, noise_sigma=3.0, seed=SEED + 6),
        (STREAM_FRAMES // 64, 1, 1))
    out = np.empty((N_STREAMS, STREAM_FRAMES, H, W), np.uint8)
    meteor_streams = {1: 0, 4: 80, 6: 150}
    for s in range(N_STREAMS):
        if s in meteor_streams:
            out[s] = np.roll(sky, meteor_streams[s], axis=0)
        else:
            q = np.roll(quiet, 11 * s, axis=0)
            out[s] = q[:, ::-1] if s % 2 else q[:, :, ::-1]
    return out, sorted(meteor_streams)


def _m3_stream_reference(frames: np.ndarray, cfg, logger):
    """One stream through the port's M3Detector on the card, block by
    block as detect_multi_stream feeds its streams: its packed buffers
    (its step with the sharded programs' fold of the diff area,
    ``_m3_block_step(sharded_fold=True)``) and its records."""
    from metdetpy_tpu_torch.detectors.m3det import M3Detector, _m3_block_step
    from metdetpy_tpu_torch.track.collector import MeteorCollector
    from metdetpy_tpu_torch.utils import get_num_class
    rt = _rt(W, H, FPS)
    det = M3Detector(cfg.detector.window_sec, FPS, np.ones((H, W), np.uint8),
                     get_num_class(), cfg.detector.cfg, logger,
                     max_points=MAX_POINTS, max_peaks=MAX_PEAKS,
                     device="cuda")
    col = MeteorCollector(cfg.collector, rt, video_loader=None,
                          logger=logger, device="cuda")
    packed_all = []
    for pos in range(0, frames.shape[0] - T_BLOCK + 1, T_BLOCK):
        block = torch.from_numpy(frames[pos:pos + T_BLOCK]).cuda()
        (packed, dst, det._gray_hist, det._sub_hist, det._dy_hist,
         det._ema, det._timer_dev) = _m3_block_step(
            det._gray_hist, det._sub_hist, det._dy_hist, det._ema, block,
            det._timer_dev, **det._step_static_kwargs(), sharded_fold=True)
        buf = packed.cpu().numpy()
        packed_all.append(buf)
        for j, (lines, cates) in enumerate(
                det._collect_from_buf(buf, (packed, dst))):
            if len(lines) or (pos + j) % rt.eq_int_fps == 0:
                col.update(pos + j, lines, cates)
    col.clear()
    return np.concatenate(packed_all), col.met_exporter.meteor_list


def _device_busy(prof) -> tuple[float, list]:
    """The device kernels' summed self time in a profile (ms) and the five
    largest [name, ms]."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and t:
            rows.append((t / 1e3, ev.key[:60]))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), [[k, round(t, 3)] for t, k in rows[:5]]


def _multistream_packed(det, streams: np.ndarray) -> np.ndarray:
    """[S, frames, ...] packed rows of ``streams`` through ``det``, block by
    block."""
    packed = []
    for pos in range(0, streams.shape[1], T_BLOCK):
        handle = det.process_blocks_async(streams[:, pos:pos + T_BLOCK])
        packed.append(np.concatenate([p.cpu().numpy() for p in handle]))
    return np.concatenate(packed, axis=1)


def phase_multistream(card: str) -> dict:
    """m3det_normal's detector (n = 25) over 8 gray 960x540 streams of 256
    frames in 64-frame blocks, BASELINE.json configuration 5 at its
    analysis resolution, each block one replay of the step's CUDA graph a
    device group; returns the launch counts of the first run (two warm-ups
    and the replays)."""
    from metdetpy_tpu_torch.detectors import step_graph
    from metdetpy_tpu_torch.log import BaseMetLog
    from metdetpy_tpu_torch.ops import kernels as K
    from metdetpy_tpu_torch.parallel.mesh import build_mesh, shared_mesh
    from metdetpy_tpu_torch.parallel.multistream import (
        MultiStreamM3Detector, detect_multi_stream)
    from metdetpy_tpu_torch.utils import get_num_class
    streams, meteor_streams = _gray_streams()
    cfg = preset_cfg("m3det_normal", recheck=False)
    logger = BaseMetLog()
    n_blocks = STREAM_FRAMES // T_BLOCK
    chunks = N_STREAMS * T_BLOCK // FRAME_CHUNK
    mesh = shared_mesh(N_STREAMS, "cuda")
    step_graph.clear_idle()  # a fresh process holds no graph of the step
    n_caps = len(step_graph.CAPTURES)

    def run(dmesh):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = detect_multi_stream(list(streams), cfg, _rt(W, H, FPS),
                                      logger, mesh=dmesh,
                                      block_frames=T_BLOCK, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gc.collect()  # the detector gives its graphs back
        return ([[r.to_dict() for r in rs] for rs in records],
                dict(K.LAUNCHES), wall)

    records, launches, wall = run(mesh)
    caps = step_graph.CAPTURES[n_caps:]
    # the first run's launches: two eager warm-ups before the capture, then
    # one replay a block (each replay adds the launches it holds)
    want = {"window_diff": 2 + n_blocks, "median_binarize_close": 2 + n_blocks,
            "hough_vote": (2 + n_blocks) * chunks,
            "walk_pick": (2 + n_blocks) * chunks,
            "peak_ladder": (2 + n_blocks) * chunks}
    if len(caps) != 1 or launches != want:
        fail(f"multistream: {len(caps)} captures, launches {launches}, "
             f"expected one capture and {want} (one window_diff and one "
             "median_binarize_close a block for all streams)")
    # a second run in the process adopts the graph: no capture, replays only
    records2, launches2, wall2 = run(mesh)
    want2 = {k: v // (2 + n_blocks) * n_blocks for k, v in want.items()}
    if len(step_graph.CAPTURES) != n_caps + 1 or launches2 != want2 or \
            records2 != records:
        fail(f"multistream: a second detect_multi_stream made "
             f"{len(step_graph.CAPTURES) - n_caps - 1} captures, launches "
             f"{launches2} (expected {want2}), records equal: "
             f"{records2 == records}")

    # host time of the dispatch and wall time of a block, in a third run
    det = MultiStreamM3Detector(
        N_STREAMS, cfg.detector.window_sec, FPS, np.ones((H, W), np.uint8),
        get_num_class(), cfg.detector.cfg, logger, mesh=mesh,
        max_points=MAX_POINTS, max_peaks=MAX_PEAKS, device="cuda")
    packed, host_s, block_s = [], [], []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for pos in range(0, STREAM_FRAMES, T_BLOCK):
        blocks = np.ascontiguousarray(streams[:, pos:pos + T_BLOCK])
        last = pos + T_BLOCK == STREAM_FRAMES
        with (torch.profiler.profile(activities=acts) if last
              else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            handle = det.process_blocks_async(blocks)
            t2 = time.perf_counter()
            det.collect(handle)
            t3 = time.perf_counter()
        if not last:
            host_s.append(t2 - t1)
            block_s.append(t3 - t1)
        packed.append(np.concatenate([p.cpu().numpy() for p in handle]))
    packed = np.concatenate(packed, axis=1)
    busy_ms, top = _device_busy(prof)
    prof_ms = (t3 - t1) * 1e3
    upload = torch.from_numpy(blocks)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    upload.to("cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t1) * 1e3
    # a block on the card: the replay with its device-to-device input copy
    # and output clones
    on_card = upload.cuda()
    replay_ms = cuda_ms(lambda: det.process_blocks_async(on_card), 5)
    del det, on_card
    gc.collect()
    found = []
    for s in range(N_STREAMS):
        ref_packed, ref_records = _m3_stream_reference(streams[s], cfg,
                                                       logger)
        if not np.array_equal(packed[s], ref_packed):
            n_bad = int((packed[s] != ref_packed).sum())
            fail(f"multistream: stream {s}'s packed rows differ from its "
                 f"own M3 step's in {n_bad} values")
        if records[s] != [r.to_dict() for r in ref_records]:
            fail(f"multistream: stream {s}'s records differ from its own "
                 f"M3Detector run: {records[s]} vs "
                 f"{[r.to_dict() for r in ref_records]}")
        if any(t["category"] == "METEOR" for r in records[s]
               for t in r["target"]):
            found.append(s)
    if not set(meteor_streams) <= set(found):
        fail(f"multistream: METEORs in streams {found}, the meteors are in "
             f"{meteor_streams}")
    cards = ""
    if torch.cuda.device_count() >= 2:
        # a card a shard group: one graph a card, held to the shared mesh
        k = max(c for c in (2, 4, 8) if c <= torch.cuda.device_count())
        n_caps_k = len(step_graph.CAPTURES)
        det = MultiStreamM3Detector(
            N_STREAMS, cfg.detector.window_sec, FPS,
            np.ones((H, W), np.uint8), get_num_class(), cfg.detector.cfg,
            logger, mesh=build_mesh(k), max_points=MAX_POINTS,
            max_peaks=MAX_PEAKS, device="cuda")
        devs = [str(g.carries[-1].device) for g, _, _ in det._graphs]
        if devs != [f"cuda:{i}" for i in range(k)]:
            fail(f"multistream on {k} cards: graphs on {devs}")
        got = _multistream_packed(det, streams)
        del det
        gc.collect()
        keys = [c["key"][2] for c in step_graph.CAPTURES[n_caps_k:]]
        if sorted(keys) != devs or not np.array_equal(got, packed):
            fail(f"multistream on {k} cards: captures on {keys}, packed "
                 f"rows equal to the shared mesh: "
                 f"{np.array_equal(got, packed)}")
        records_k, _, wall_k = run(build_mesh(k))
        if records_k != records:
            fail(f"multistream on {k} cards: records differ from the "
                 "shared mesh")
        cards = (f"; on {k} cards (a graph each, captured on {keys}): "
                 f"packed rows and records equal to the shared mesh, "
                 f"{STREAM_FRAMES * N_STREAMS / wall_k:.2f} frames/s "
                 f"aggregate adopting the graphs")
    cap = caps[0]
    n = N_STREAMS * STREAM_FRAMES
    print(f"multistream M3 ({N_STREAMS} streams {W}x{H}, {STREAM_FRAMES} "
          f"frames each, {n_blocks} blocks of {T_BLOCK}, one graph replay a "
          f"block): {n / wall2:.2f} frames/s aggregate ({wall2:.3f} s) on "
          f"{card} in a second run that adopts the graph ({n / wall:.2f} "
          f"frames/s, {wall:.3f} s, in the first, whose capture took "
          f"{cap['seconds']:.3f} s after warm-ups of "
          f"{cap['warmup_seconds']:.3f} s, pool {cap['pool_bytes']} bytes, "
          f"launches a replay {cap['launches']}); dispatch "
          f"{1e3 * np.mean(host_s[1:]):.2f} host ms a block, "
          f"{1e3 * np.mean(block_s[1:]):.2f} ms a block with the collect "
          f"(first block {1e3 * block_s[0]:.2f} ms; the {upload.nbytes} B "
          f"block's pageable upload alone {upload_ms:.2f} ms); a replay on "
          f"the card {replay_ms:.2f} ms; profiled block: {prof_ms:.2f} ms "
          f"wall, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / prof_ms:.4f} (a replay against the mean block "
          f"with the collect: {1 - replay_ms / np.mean(block_s[1:]) / 1e3:.4f}"
          f"), top device ops {top}; launches "
          f"{launches} (second run {launches2}); METEOR in streams {found}; "
          f"every stream's packed rows and records equal its own M3Detector "
          f"run{cards}", flush=True)
    step_graph.clear_idle()  # the graph's pool, for the later phases
    return launches


def _dl_close(name: str, got: list, want: list) -> int:
    """Frame results within the card's model tolerance (boxes within 2 px,
    scores within 0.03; an unpaired box only at the objectness band).
    Returns the number of boxes paired."""
    if len(got) != len(want):
        fail(f"{name}: {len(got)} frames against {len(want)}")
    n = 0
    for (gp, gc), (wp, wc) in zip(got, want):
        left = list(range(len(wp)))
        for p, c in zip(gp, gc):
            near = [i for i in left if np.abs(wp[i] - p).max() <= 2]
            if not near:
                if c.max() > 0.53:
                    fail(f"{name}: box {p} ({c.max():.3f}) has no match")
                continue
            left.remove(near[0])
            if np.abs(c - wc[near[0]]).max() > 0.03:
                fail(f"{name}: scores of {p} differ by more than 0.03")
            n += 1
        if any(wc[i].max() > 0.53 for i in left):
            fail(f"{name}: boxes {[wp[i] for i in left]} have no match")
    return n


def _color_clip(frames: int) -> np.ndarray:
    """Merged colour frames of 960x544 (dldet's runtime size) with one
    meteor."""
    clip, _, _ = synth_clip(960, 544, frames / FPS, 0.8, 2.0, color=True,
                            seed=SEED + 7)
    return clip


def phase_multistream_dldet(card: str, clip: np.ndarray) -> None:
    """dldet.json's detector over 4 colour 960x544 streams, 2 blocks of 64
    merged frames, against each stream's own MLDetector run on the card."""
    from metdetpy_tpu_torch.detectors.mldet import MLDetector
    from metdetpy_tpu_torch.log import BaseMetLog
    from metdetpy_tpu_torch.parallel.mesh import shared_mesh
    from metdetpy_tpu_torch.parallel.multistream_dldet import \
        MultiStreamMLDetector
    from metdetpy_tpu_torch.utils import get_num_class
    cfg = preset_cfg("dldet")
    fps = FPS / 12                      # 0.5 s exposures of 25 fps video
    streams = np.stack([np.roll(clip, 32 * s, axis=0) for s in range(4)])
    mask = np.ones((544, 960, 3), np.uint8)
    logger = BaseMetLog()
    det = MultiStreamMLDetector(4, cfg.detector.window_sec, fps, mask,
                                get_num_class(), cfg.detector.cfg, logger,
                                mesh=shared_mesh(4, "cuda"), device="cuda")
    t0 = time.perf_counter()
    got = [det.process_blocks(np.ascontiguousarray(
        streams[:, b:b + T_BLOCK])) for b in (0, T_BLOCK)]
    wall = time.perf_counter() - t0
    n = 0
    for s in range(4):
        seq = MLDetector(cfg.detector.window_sec, fps, mask,
                         get_num_class(), cfg.detector.cfg, logger,
                         device="cuda")
        want = (seq.process_block(streams[s, :T_BLOCK])
                + seq.process_block(streams[s, T_BLOCK:]))
        n += _dl_close(f"multistream dldet, stream {s}",
                       got[0][s] + got[1][s], want)
    if n < 4:
        fail(f"multistream dldet: only {n} boxes found in 4 streams")
    print(f"multistream dldet (4 streams 960x544 colour, 2 blocks of "
          f"{T_BLOCK} merged frames): {4 * 2 * T_BLOCK / wall:.2f} merged "
          f"frames/s aggregate ({wall:.3f} s, the first blocks included) on "
          f"{card}; {n} boxes agree with each stream's MLDetector (2 px, "
          f"0.03)", flush=True)


def _ml_records(frames: np.ndarray, cfg, fps: float, logger) -> list:
    """MLDetector on the card, 64-frame blocks, the block loop's collector
    cadence: the sequential records of ``frames``."""
    from metdetpy_tpu_torch.detectors.mldet import MLDetector
    from metdetpy_tpu_torch.track.collector import MeteorCollector
    from metdetpy_tpu_torch.utils import get_num_class
    h, w = frames.shape[1:3]
    rt = _rt(w, h, fps)
    det = MLDetector(cfg.detector.window_sec, fps, np.ones((h, w, 3),
                                                            np.uint8),
                     get_num_class(), cfg.detector.cfg, logger,
                     device="cuda")
    col = MeteorCollector(cfg.collector, rt, video_loader=None,
                          logger=logger, device="cuda")
    for pos in range(0, frames.shape[0], T_BLOCK):
        for j, (lines, cates) in enumerate(
                det.process_block(frames[pos:pos + T_BLOCK])):
            if len(lines) or (pos + j) % rt.eq_int_fps == 0:
                col.update(pos + j, lines=lines, cates=cates)
    col.clear()
    return col.met_exporter.meteor_list


def _records_close(name: str, got: list, want: list) -> None:
    a_t = [t for r in got for t in r.target]
    b_t = [t for r in want for t in r.target]
    if len(a_t) != len(b_t) or not a_t:
        fail(f"{name}: {len(a_t)} target(s) against {len(b_t)}")
    for a, b in zip(a_t, b_t):
        if not ((a.category, a.start_frame, a.last_activate_frame)
                == (b.category, b.start_frame, b.last_activate_frame)
                and max(abs(p - q) for p, q in zip(
                    [*a.pt1, *a.pt2], [*b.pt1, *b.pt2])) <= 2
                and abs(a.score - b.score) <= 0.03):
            fail(f"{name}: {a} against {b}")


def phase_temporal(card: str, clip: np.ndarray) -> dict:
    """Temporal shards on the card: the M3 step over 512 gray 960x540
    frames on 4 shards (whole clip and 128-frame super-blocks) against the
    single-device step, the CLI's super-block mode against its whole-clip
    mode, and dldet on 2 shards against MLDetector. Returns the launch
    counts of the whole-clip run."""
    from metdetpy_tpu_torch.api import detect_video_temporal
    from metdetpy_tpu_torch.detectors.m3det import EmaState, _m3_block_step
    from metdetpy_tpu_torch.log import BaseMetLog
    from metdetpy_tpu_torch.ops import kernels as K
    from metdetpy_tpu_torch.parallel.mesh import shared_mesh
    from metdetpy_tpu_torch.parallel.temporal import (
        _m3_params, detect_frames_temporal, temporal_m3_detect)
    from metdetpy_tpu_torch.parallel.temporal_dldet import \
        detect_frames_temporal_dldet
    from metdetpy_tpu_torch.synth import write_video
    streams, _ = _gray_streams()
    frames = np.concatenate([streams[1], streams[0]])     # 512 frames
    del streams
    cfg = preset_cfg("m3det_normal", recheck=False)
    mask = np.ones((H, W), np.uint8)
    params = _m3_params(cfg, FPS, mask)
    init = params.pop("init_threshold")
    mesh = shared_mesh(4, "cuda")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    packed, dst = temporal_m3_detect(frames, **params, init_threshold=init,
                                     max_points=MAX_POINTS,
                                     max_peaks=MAX_PEAKS, mesh=mesh)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    n = params["n"]
    r1, c1, r2, c2 = params["roi"]
    z = lambda *s: torch.zeros(s, dtype=torch.uint8, device="cuda")  # noqa
    ref, ref_dst, *_ = _m3_block_step(
        z(n - 1, H, W), z(n - 1, r2 - r1, c2 - c1), z(n - 1, H, W),
        EmaState.init(params["momentum"], init, torch.device("cuda")),
        torch.from_numpy(frames).cuda(), 0, **params,
        max_points=MAX_POINTS, max_peaks=MAX_PEAKS, sharded_fold=True)
    if not (torch.equal(packed, ref) and torch.equal(dst, ref_dst)):
        fail("temporal: the 4-shard step differs from the single-device "
             f"step over the whole block ({int((packed != ref).sum())} "
             "packed values)")
    carry, parts = None, []
    for a in range(0, frames.shape[0], 128):
        p, _, carry = temporal_m3_detect(
            frames[a:a + 128], **params, init_threshold=init,
            max_points=MAX_POINTS, max_peaks=MAX_PEAKS, mesh=mesh,
            carry=carry, return_carry=True)
        parts.append(p)
    if not torch.equal(torch.cat(parts), packed):
        fail("temporal: 128-frame super-blocks differ from the whole clip")
    del ref, ref_dst, dst, parts
    t0 = time.perf_counter()
    records, used = detect_frames_temporal(frames, cfg, FPS, mesh=mesh,
                                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not any(t.category == "METEOR" for r in records for t in r.target):
        fail(f"temporal: no METEOR in {used} frames")
    print(f"temporal M3, 4 shards on {card}: {used} frames {W}x{H}, the "
          f"step {step_s:.3f} s, detect_frames_temporal "
          f"{used / wall:.2f} frames/s ({wall:.3f} s); the step equals the "
          f"single-device step bit for bit, 4 super-blocks of 128 equal the "
          f"whole clip; launches {launches}", flush=True)

    # the CLI: super-blocks of 4 s against the whole-clip mode, 1 shard
    os.makedirs(FILES, exist_ok=True)
    video = os.path.join(FILES, "temporal.avi")
    write_video(frames[:200], video, fps=FPS)
    out = os.path.join(FILES, "temporal.json")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "metdetpy_tpu_torch", video, "--mode",
         "backend", "--exp-time", "real-time", "--temporal-shards", "1",
         "--temporal-super-block", "4", "--save-path", out],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"temporal CLI exited {run.returncode}: {run.stderr[-2000:]}")
    with open(out, encoding="utf-8") as f:
        cli = json.load(f)["results"]
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.utils import relative2abs_path
    cfg_v = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg_v.loader.exp_time = "real-time"
    whole = detect_video_temporal(video, None, cfg_v, n_shards=1,
                                  device="cuda")
    if cli != _dicts(whole) or not cli:
        fail(f"temporal CLI: {cli} against the whole-clip mode's "
             f"{_dicts(whole)}")
    print(f"temporal CLI (--temporal-shards 1 --temporal-super-block 4, a "
          f"200-frame {W}x{H} MJPG AVI) in {cli_s:.1f} s: {len(cli)} "
          f"record(s), equal to the whole-clip mode's", flush=True)

    # dldet over 2 shards against MLDetector
    dl_cfg = preset_cfg("dldet")
    logger = BaseMetLog()
    t0 = time.perf_counter()
    got, used = detect_frames_temporal_dldet(
        clip, dl_cfg, FPS / 12, mesh=shared_mesh(2, "cuda"), logger=logger,
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _records_close("temporal dldet", got,
                   _ml_records(clip, dl_cfg, FPS / 12, logger))
    print(f"temporal dldet, 2 shards on {card}: {used} merged frames "
          f"960x544 in {wall:.3f} s = {used / wall:.2f} frames/s; "
          f"{sum(len(r.target) for r in got)} target(s) agree with "
          f"MLDetector's (frames equal, points within 2 px, scores within "
          f"0.03)", flush=True)
    return launches


def phase_data_parallel(card: str) -> None:
    """BatchPipeline over a 2-shard mesh on the card against the unsharded
    pipeline (11 images, padded to 12), and the photo entry point's
    refusal of --data-parallel 2 on one card."""
    from metdetpy_tpu_torch.models.pipeline import BatchPipeline
    from metdetpy_tpu_torch.models.yolo import YOLOModel
    from metdetpy_tpu_torch.parallel.mesh import shared_mesh
    from metdetpy_tpu_torch.utils import relative2abs_path
    rng = np.random.default_rng(SEED + 8)
    imgs = np.stack([_photo_sky(rng, W, H, True) for _ in range(11)])
    model = YOLOModel(relative2abs_path("./weights/yolov5s_v5.flax.npz"),
                      nms=True, warmup=True, multiscale_pred=2,
                      multiscale_partition=2, device="cuda")
    tags = list(range(11))
    sharded = BatchPipeline(model, inflight=0,
                            sharding=shared_mesh(2, "cuda")).submit(tags,
                                                                    imgs)
    plain = BatchPipeline(model, inflight=0).submit(tags, imgs)
    if [t for t, _ in sharded] != tags:
        fail(f"data-parallel: tags {[t for t, _ in sharded]}")
    n = _dl_close("data-parallel", [r for _, r in sharded],
                  [r for _, r in plain])
    exact = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for (_, a), (_, b) in zip(sharded, plain))
    if n < 5:
        fail(f"data-parallel: {n} boxes in 11 images with streaks")
    run = subprocess.run(
        [sys.executable, "-m", "metdetpy_tpu_torch.photo", FILES,
         "--data-parallel", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    want = f"need 2 devices, have {torch.cuda.device_count()}"
    if run.returncode == 0 or want not in run.stderr:
        fail(f"photo --data-parallel 2: exit {run.returncode}, expected the "
             f"error '{want}': {run.stderr[-1000:]}")
    print(f"data-parallel: 11 images {W}x{H} over 2 shards on {card}: "
          f"{n} boxes agree with the unsharded pipeline "
          f"({'equal' if exact else 'within 2 px and 0.03'}); photo "
          f"--data-parallel 2 exits {run.returncode} with '{want}'",
          flush=True)


TRAIN_HW, TRAIN_BATCH = (320, 320), 8   # fit_synthetic's defaults


def _train_grads(sd: dict, imgs, targets, dev: str, dtype):
    """Loss and gradients of one training forward/backward of YOLOv5s
    (nc 8) with the state dict ``sd`` on ``dev`` in ``dtype``."""
    from metdetpy_tpu_torch.models import train, yolov5
    net = yolov5.YOLOv5(nc=8, dtype=dtype)
    net.load_state_dict(sd, strict=True)
    net = net.to(dev)
    x, tg = train._place(imgs, targets, torch.device(dev))
    loss = train.yolo_loss(net(x), tg, 8)
    loss.backward()
    return float(loss), {k: p.grad.cpu() for k, p in net.named_parameters()}


def phase_train(card: str) -> None:
    """The training path on the card at fit_synthetic's defaults
    (full-width YOLOv5s, 320x320, batch 8, nc 8): (a) one step from the
    shipped weights, float32 on the card against the CPU, then the
    bfloat16 body; (b) 8 steps on a fixed batch; (c) ``python -m
    metdetpy_tpu_torch.train --steps 40``'s entry point and its npz
    through ``YOLOModel``; (d) ``python -m metdetpy_tpu_torch.evaluate``'s
    entry point on the annotated clip, card against CPU."""
    import copy
    import io
    from metdetpy_tpu_torch import evaluate
    from metdetpy_tpu_torch import train as train_cli
    from metdetpy_tpu_torch.models import train, yolov5
    from metdetpy_tpu_torch.models.weights import params_from_flax
    from metdetpy_tpu_torch.models.yolo import YOLOModel
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.synth import write_annotated_clip
    from metdetpy_tpu_torch.utils import relative2abs_path
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    with np.load(relative2abs_path("./weights/yolov5s_v5.flax.npz")) as d:
        sd = params_from_flax({k: d[k] for k in d.files})
    imgs, targets = train.synth_batch(np.random.default_rng(SEED + 9),
                                      TRAIN_BATCH, TRAIN_HW, 8)

    # (a) one step, the card against the CPU (TF32 off, as main sets it)
    want_loss, want = _train_grads(sd, imgs, targets, "cpu", torch.float32)
    loss, grads = _train_grads(sd, imgs, targets, "cuda", torch.float32)
    if abs(loss - want_loss) > 1e-5 * abs(want_loss):
        fail(f"train (a): float32 loss {loss} on the card, {want_loss} on "
             "the CPU (rtol 1e-5)")
    worst = 0.0
    for k, g in want.items():
        err = float((grads[k] - g).abs().max()) / max(float(g.abs().max()),
                                                      1e-30)
        worst = max(worst, err)
        if not torch.allclose(grads[k], g, rtol=2e-4,
                              atol=2e-4 * float(g.abs().max())):
            fail(f"train (a): float32 gradient {k} on the card differs from "
                 f"the CPU's (rtol 2e-4, atol 2e-4 x max|g|; {err:.3g})")
    bf16_loss, bf16_grads = _train_grads(sd, imgs, targets, "cuda",
                                         torch.bfloat16)
    if not (np.isfinite(bf16_loss)
            and abs(bf16_loss - want_loss) <= 0.01 * abs(want_loss)):
        fail(f"train (a): bfloat16 loss {bf16_loss} on the card against "
             f"{want_loss} float32 on the CPU (rtol 0.01)")
    if not all(torch.isfinite(g).all() for g in bf16_grads.values()):
        fail("train (a): a bfloat16 gradient on the card is not finite")
    print(f"train (a) on {card}: one step of YOLOv5s, {TRAIN_BATCH}x"
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, shipped weights: float32 loss "
          f"{loss:.9g} (CPU {want_loss:.9g}), {len(want)} gradients within "
          f"rtol 2e-4 / atol 2e-4 x max|g| (largest error {worst:.3g} of "
          f"max|g|); bfloat16 loss {bf16_loss:.9g} (rtol "
          f"{abs(bf16_loss - want_loss) / abs(want_loss):.3g})", flush=True)

    # (b) 8 steps on a fixed batch (tests/test_train.py's criterion), the
    # device time of a step and the idle share of a profiled one
    model = yolov5.init_params(nc=8, input_hw=TRAIN_HW, seed=0,
                               device="cuda")
    step = train.make_train_step(model, train.Adam(model.parameters(), 3e-3),
                                 8)
    x, tg = train._place(imgs, targets, dev)
    losses = [float(step(x, tg)) for _ in range(8)]
    if not losses[-1] < 0.8 * losses[0]:
        fail(f"train (b): the loss did not fall on a fixed batch: {losses}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step(x, tg)
    torch.cuda.synchronize()
    paced_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda._sleep(1_000_000_000)   # ~0.5 s: the host queues 10 steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        step(x, tg)
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / 10
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, tg)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = _device_busy(prof)
    print(f"train (b) on {card}: 8 bfloat16 steps on a fixed batch from "
          f"init_params(seed=0), Adam 3e-3: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; a step {device_ms:.3f} device ms (CUDA events, "
          f"10 steps queued behind a device sleep), {paced_ms:.3f} ms "
          f"host-paced; profiled step {prof_ms:.3f} ms wall, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / prof_ms:.4f} "
          f"(against the unprofiled host-paced step: "
          f"{1 - busy_ms / paced_ms:.4f}); largest {top}", flush=True)
    del model, step, x, tg

    # (c) the train entry point, its npz through YOLOModel's weight path
    os.makedirs(FILES, exist_ok=True)
    out = os.path.join(FILES, "train.flax.npz")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        trained = train_cli.main(["--steps", "40", "--device", "cuda",
                                  "--out", out])
    stats = json.loads(log.getvalue().strip().splitlines()[-1])
    loaded = YOLOModel(out, warmup=False, input_hw=TRAIN_HW, device="cuda")
    mine = copy.deepcopy(trained).eval().requires_grad_(False)
    mine = mine.to(memory_format=torch.channels_last).cast_body_weights_()
    with torch.inference_mode():
        xs = torch.from_numpy(imgs[:2]).to(dev)
        got, want_heads = loaded.model(xs), mine(xs)
    if not all(torch.equal(a, b) for a, b in zip(got, want_heads)):
        fail("train (c): the heads of the npz loaded through YOLOModel "
             "differ from the trained module's")
    print(f"train (c) on {card}: python -m metdetpy_tpu_torch.train --steps "
          f"40 --device cuda: {stats['steps_per_s']:.3f} steps/s "
          f"({stats['seconds']:.3f} s), host synth_batch "
          f"{stats['synth_batch_s_per_step']:.4f} s a step, the step to its "
          f"loss on the host {stats['step_s_per_step']:.4f} s a step; "
          f"device step {device_ms:.3f} ms and idle share "
          f"{1 - busy_ms / prof_ms:.4f} (b); max_memory_allocated "
          f"{stats['max_memory_allocated'] / 2**20:.1f} MiB; the saved "
          f"npz's heads through YOLOModel equal the trained module's bit for "
          f"bit; {card}", flush=True)

    # (d) the evaluate entry point on the annotated clip, card and CPU
    clip_dir = os.path.join(FILES, "evaluate")
    anno = write_annotated_clip(clip_dir)
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    cfg_path = os.path.join(clip_dir, "cfg.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(cfg.to_dict(), f)
    summaries = {}
    for name in ("cuda", "cpu"):
        run_dir = os.path.join(clip_dir, name)
        os.makedirs(run_dir)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(run_dir), contextlib.redirect_stdout(buf):
            evaluate.main([anno, "--cfg", cfg_path, "--metric", "--device",
                           name])
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        table = text.index("PRED\\BASE")
        summaries[name] = (text[text.rindex("{'", 0, table):table].strip(),
                           wall)
    if "'recall': 1.0" not in summaries["cuda"][0]:
        fail(f"evaluate on the card: recall is not 1.0: {summaries['cuda']}")
    if summaries["cuda"][0] != summaries["cpu"][0]:
        fail(f"evaluate: the card's summary {summaries['cuda'][0]} differs "
             f"from the CPU's {summaries['cpu'][0]}")
    prec = summaries["cuda"][0].split("'precision': ")[1].split(",")[0]
    print(f"train (d) on {card}: python -m metdetpy_tpu_torch.evaluate "
          f"--metric on the annotated 256x144 clip: recall 1.0, precision "
          f"{prec} on the card ({summaries['cuda'][1]:.1f} s) and on the CPU "
          f"({summaries['cpu'][1]:.1f} s), summaries equal; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# the JAX harness's keys of each mode's JSON line, and "device"
_BENCH_COMMON = {"metric", "value", "unit", "vs_baseline", "device"}
_BENCH_PASSES = {"protocol", "value_best", "passes_fps"}
_BENCH_SHARDED = _BENCH_COMMON | {"streams_with_meteor", "n_streams",
                                  "backend"}
BENCH_KEYS = {
    None: _BENCH_COMMON | _BENCH_PASSES | {
        "vs_baseline_best", "device_only_fps", "device_only_vs_baseline",
        "device_hbm", "device_worstcase_fps", "device_worstcase_occupancy",
        "device_with_readback_fps", "readback_mbps", "host_memcpy_gbps",
        "stages"},
    "probe": {"metric", "h2d_mbps", "d2h_mbps", "probe_wall_s", "device"},
    "multistream": _BENCH_COMMON | _BENCH_PASSES | {
        "input_resolution", "analysis_resolution",
        "streams_with_meteor_lines", "n_streams", "stages",
        "stages_all_passes"},
    "multistream_sharded": _BENCH_SHARDED,
    "dldet_sharded": _BENCH_SHARDED,
    "yolo": _BENCH_COMMON | {"batch"},
    "dldet": _BENCH_COMMON | _BENCH_PASSES | {"meteor_found", "detector",
                                              "note", "stages"},
    "high_mask": _BENCH_COMMON | _BENCH_PASSES | {"meteor_found", "config"},
    "photo": _BENCH_COMMON | {"protocol", "value_best", "n_images",
                              "result_records"},
    "denoise": _BENCH_COMMON | {
        "protocol", "value_best", "t_max_export_s", "t_mfnr_export_s",
        "t_max_passes_s", "t_mfnr_passes_s", "device_pixel_math", "stages",
        "clip"},
    "recheck": _BENCH_COMMON | _BENCH_PASSES | {
        "recheck_off_fps_best", "recheck_off_fps_median",
        "recheck_off_passes_fps", "recheck_overhead_pct_best",
        "recheck_overhead_pct_median", "meteor_found", "n_meteors",
        "n_rechecked_targets", "n_demoted_targets", "target_categories",
        "clip_events", "note"},
}
# (mode, environment, arguments of the mode's function): reduced depth
BENCH_RUNS = [
    (None, {"BENCH_SECONDS": "4", "BENCH_PASSES": "1"},
     {"n_blocks": (16, 16, 8)}),
    ("probe", {}, {}),
    ("multistream", {"BENCH_STREAMS": "4", "BENCH_SECONDS": "6",
                     "BENCH_PASSES": "1"}, {}),
    ("multistream_sharded", {"BENCH_SECONDS": "6"}, {}),
    ("dldet_sharded", {}, {}),
    ("yolo", {}, {"counts": (2, 6)}),
    ("dldet", {"BENCH_SECONDS": "5", "BENCH_PASSES": "1"}, {}),
    ("high_mask", {"BENCH_SECONDS": "5", "BENCH_PASSES": "1"}, {}),
    ("photo", {"BENCH_PHOTO_IMGS": "8", "BENCH_PASSES": "1"}, {}),
    ("denoise", {"BENCH_PASSES": "1"}, {}),
    ("recheck", {"BENCH_SECONDS": "5", "BENCH_PASSES": "1"}, {}),
]


def _bench_line(mode, env: dict, kwargs: dict) -> dict:
    """``python -m metdetpy_tpu_torch.bench``'s entry (``main``) in-process
    with BENCH_MODE and ``env`` set, the mode's function given ``kwargs``:
    fails unless stdout got exactly one JSON line; returns it."""
    import functools
    import io
    from metdetpy_tpu_torch import bench
    fn = bench.MODES[mode]
    bench.MODES[mode] = functools.partial(fn, **kwargs)
    os.environ.pop("BENCH_MODE", None)
    out = io.StringIO()
    try:
        with env_set({**env, **({"BENCH_MODE": mode} if mode else {})}), \
                contextlib.redirect_stdout(out):
            bench.main([])
    finally:
        bench.MODES[mode] = fn
    lines = out.getvalue().splitlines()
    if len(lines) != 1:
        fail(f"bench {mode}: {len(lines)} lines on stdout, expected one "
             f"JSON line: {lines[:5]}")
    return json.loads(lines[0])


def _bench_blocks_card_vs_cpu() -> dict:
    """A quiet sky block (the default mode's clip at its half size) and
    two active-sky blocks (``bench.worstcase_frames``, the second dense in
    steady state) through ``M3Detector.process_block_async`` on the card
    and on the CPU: the packed buffers equal. Returns the occupancy of the
    card's dense block."""
    from metdetpy_tpu_torch import bench
    quiet = bench._meteor_clip(W, H, T_BLOCK / FPS)
    worst = bench.worstcase_frames(2 * T_BLOCK)
    cases = (("quiet", bench._preset("m3det_normal"), quiet),
             ("worst case", bench.worstcase_cfg(), worst))
    occ = None
    for name, cfg, frames in cases:
        dets = {dev: bench._m3_detector(cfg, H, W, dev)
                for dev in ("cuda", "cpu")}
        for b in range(frames.shape[0] // T_BLOCK):
            block = frames[b * T_BLOCK:(b + 1) * T_BLOCK]
            bufs = {dev: det.process_block_async(block)[0].cpu().numpy()
                    for dev, det in dets.items()}
            if not np.array_equal(bufs["cuda"], bufs["cpu"]):
                n_bad = int((bufs["cuda"] != bufs["cpu"]).sum())
                fail(f"bench: the {name} block {b}'s packed buffer on the "
                     f"card differs from the CPU's in {n_bad} values")
        if name == "worst case":
            det = dets["cuda"]
            occ = bench.occupancy(bufs["cuda"], det.max_peaks,
                                  det.max_points)
    return occ


def phase_bench(card: str) -> dict:
    """Every mode of ``python -m metdetpy_tpu_torch.bench`` on the card at
    reduced depth (the default mode at full width); returns the launch
    counts of the default mode's run."""
    from metdetpy_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    occ = _bench_blocks_card_vs_cpu()
    if not (occ["min_npix"] > 1024 and occ["overflow_rate"] <= 0.01):
        fail(f"bench: the dense block on the card is not dense: {occ}")
    print(f"bench on {card}: a quiet and two active-sky 64-frame {W}x{H} "
          f"blocks through M3Detector.process_block_async, packed buffers "
          f"on the card equal the CPU's; dense block occupancy {occ} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = None
    for mode, env, kwargs in BENCH_RUNS:
        t0 = time.perf_counter()
        if mode is None:
            K.reset_launch_counts()
        rec = _bench_line(mode, env, kwargs)
        if mode is None:
            launches = dict(K.LAUNCHES)
            _require_launches("bench default mode", launches)
        if set(rec) != BENCH_KEYS[mode]:
            fail(f"bench {mode}: keys {sorted(rec)}, expected "
                 f"{sorted(BENCH_KEYS[mode])}")
        if not (isinstance(rec["device"], dict)
                and rec["device"]["name"] == torch.cuda.get_device_name(0)):
            fail(f"bench {mode}: device {rec['device']}")
        if rec.get("meteor_found") is False:
            fail(f"bench {mode}: no METEOR found: {rec}")
        if "streams_with_meteor" in rec and (
                rec["streams_with_meteor"] != rec["n_streams"]):
            fail(f"bench {mode}: meteors in {rec['streams_with_meteor']} "
                 f"of {rec['n_streams']} streams")
        if mode == "multistream" and (
                rec["streams_with_meteor_lines"] != rec["n_streams"]):
            fail(f"bench multistream: meteor lines in "
                 f"{rec['streams_with_meteor_lines']} of "
                 f"{rec['n_streams']} streams")
        if mode is None:
            occ = rec["device_worstcase_occupancy"]
            if not (occ["min_npix"] > 1024 and occ["overflow_rate"] <= 0.01):
                fail(f"bench: the worst case is not dense: {occ}")
        print(f"bench {mode or 'default'} ({env}, {kwargs}) on {card}, "
              f"{time.perf_counter() - t0:.1f} s: {json.dumps(rec)}",
              flush=True)
    print(f"bench: default mode launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _trace_kernels(what: str, trace_dir: str, launches: dict) -> dict:
    """{kernel: (device events, summed device ms)} of the one Chrome trace
    in ``trace_dir``: events of category ``kernel`` whose name holds the
    kernel's ``__global__`` name (``<name>_kernel``); fails unless each
    kernel has as many events as the traced run's ``launches``."""
    from metdetpy_tpu_torch.ops import kernels as K
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        fail(f"trace of {what}: {len(files)} trace files in {trace_dir}, "
             f"expected 1")
    with open(os.path.join(trace_dir, files[0]), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    found = {name: [0, 0.0] for name in K.SOURCES}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for name in K.SOURCES:
            if f"{name}_kernel" in e.get("name", ""):
                found[name][0] += 1
                found[name][1] += e["dur"] / 1e3
    events_n = {k: n for k, (n, _) in found.items()}
    if events_n != launches:
        n_kernels = sum(e.get("cat") == "kernel" for e in events)
        fail(f"trace of {what}: device events {events_n} against launches "
             f"{launches} ({n_kernels} kernel events, {len(events)} events)")
    return {k: tuple(v) for k, v in found.items()}


def phase_frozen_and_trace(card: str, rows: dict) -> dict:
    """(a) The frozen main entry on the card against the in-tree one, the
    kernels built from the archive's sources into an empty cache; (b)
    detect_video traced against untraced. Returns the launch counts of the
    in-tree main entry's run."""
    from metdetpy_tpu_torch.__main__ import main as cli_main
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.detectors import step_graph
    from metdetpy_tpu_torch.ops import kernels as K
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.utils import relative2abs_path
    video = os.path.join(FILES, "temporal.avi")
    if not os.path.isfile(video):
        fail(f"frozen: the clip of phase 15 is missing: {video}")
    args = [video, "--mode", "backend", "--exp-time", "real-time"]
    t_phase = time.perf_counter()

    # (a) the in-tree main entry, then the frozen one in a fresh HOME;
    # both capture the step's graph (a fresh process holds no idle one)
    tree_out = os.path.join(FILES, "frozen_tree.json")
    step_graph.clear_idle()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main([*args, "--save-path", tree_out])
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    _require_launches("the in-tree main entry", launches)
    with open(tree_out, encoding="utf-8") as f:
        tree = json.load(f)["results"]
    if not tree:
        fail("frozen: the in-tree main entry found nothing in the clip")
    want_libs = sorted(os.path.basename(K._lib_path(src))
                       for src in {s for s, _, _ in K.SOURCES.values()})
    with tempfile.TemporaryDirectory(prefix="metdetpy_frozen_") as tmp:
        dist, home, work = (os.path.join(tmp, d)
                            for d in ("dist", "home", "work"))
        os.makedirs(home)
        os.makedirs(work)
        t0 = time.perf_counter()
        build = subprocess.run(
            [sys.executable, os.path.join(REPO, "make_package_zipapp.py"),
             "--package", "metdetpy_tpu_torch", "--tools", "MetDetPy",
             "--out", dist], capture_output=True, text=True, timeout=300)
        if build.returncode != 0:
            fail(f"frozen: make_package_zipapp.py exited "
                 f"{build.returncode}: {build.stderr[-2000:]}")
        pyz = os.path.join(dist, "MetDetPy.pyz")
        pack_s = time.perf_counter() - t0
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "METDET_RESOURCE_DIR",
                            "METDETPY_TPU_TRACE_DIR")}
        env["HOME"] = home
        runs = {}
        for run in ("cold", "warm", "traced"):
            run_env = dict(env)
            if run == "traced":
                run_env["METDETPY_TPU_TRACE_DIR"] = os.path.join(tmp,
                                                                 "trace")
            out = os.path.join(work, f"{run}.json")
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, pyz, *args, "--save-path", out],
                cwd=work, env=run_env, capture_output=True, text=True,
                timeout=600)
            runs[run] = time.perf_counter() - t0
            if res.returncode != 0:
                fail(f"frozen: the {run} run of {pyz} exited "
                     f"{res.returncode}: {res.stderr[-3000:]}")
            with open(out, encoding="utf-8") as f:
                got = json.load(f)["results"]
            if got != tree:
                fail(f"frozen: the {run} run's results {got} differ from "
                     f"the in-tree main entry's {tree}")
            if run == "cold":
                cache = os.path.join(home, ".cache", "metdetpy_tpu_torch")
                bundles = os.listdir(cache)
                build_dir = os.path.join(cache, *bundles[:1],
                                         "metdetpy_tpu_torch", "csrc",
                                         "build")
                libs = sorted(f for f in os.listdir(build_dir)
                              if f.endswith(".so")) if len(
                                  bundles) == 1 else []
                if libs != want_libs:
                    fail(f"frozen: the fresh cache holds {bundles} with "
                         f"kernel libraries {libs}, expected {want_libs}")
        # the frozen run launches what the in-tree run launched
        frozen_trace = _trace_kernels("the frozen traced run",
                                      os.path.join(tmp, "trace"), launches)
    print(f"frozen (a) on {card}: MetDetPy.pyz built in {pack_s:.1f} s; "
          f"a 200-frame {W}x{H} MJPG AVI (m3det_normal as shipped, recheck "
          f"on): cold start {runs['cold']:.1f} s (extraction, nvcc of 4 "
          f"kernels into the empty cache, run), warm {runs['warm']:.1f} s, "
          f"traced {runs['traced']:.1f} s; the in-tree main entry "
          f"in-process {tree_s:.1f} s; {len(tree)} record(s), equal in all "
          f"three runs; the cache's libraries {want_libs} are the in-tree "
          f"build's names; the frozen trace's kernel events "
          f"{ {k: n for k, (n, _) in frozen_trace.items()} }; in-tree "
          f"launches {launches}", flush=True)

    # (b) detect_video untraced, then traced
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.exp_time = "real-time"
    n_frames = 200
    walls, results, run_launches = {}, {}, {}
    trace_dir = os.path.join(FILES, "trace")
    for run, env in (("untraced", {}),
                     ("traced", {"METDETPY_TPU_TRACE_DIR": trace_dir})):
        with env_set(env):
            step_graph.clear_idle()  # each run captures, as a fresh one
            K.reset_launch_counts()
            t0 = time.perf_counter()
            mdrf = detect_video(video, None, cfg, work_mode="backend",
                                device="cuda")
            torch.cuda.synchronize()
            walls[run] = time.perf_counter() - t0
            run_launches[run] = dict(K.LAUNCHES)
        _require_launches(f"detect_video {run}", run_launches[run])
        results[run] = _dicts(mdrf)
    if results["traced"] != results["untraced"] or not results["traced"]:
        fail(f"trace: the traced run's records {results['traced']} differ "
             f"from the untraced run's {results['untraced']}")
    if run_launches["traced"] != run_launches["untraced"]:
        fail(f"trace: launches {run_launches['traced']} traced against "
             f"{run_launches['untraced']} untraced")
    found = _trace_kernels("detect_video", trace_dir,
                           run_launches["traced"])
    shutil.rmtree(trace_dir)
    from metdetpy_tpu_torch.profiling import last_trace_stats as cost
    per_kernel = []
    for name, (n_ev, ms) in found.items():
        n = run_launches["traced"][name]
        rows[name]["trace_events"] = n_ev
        rows[name]["trace_device_ms"] = ms
        per_kernel.append(
            f"{name} {n_ev} events / {n} launches, {ms:.3f} ms in the trace "
            f"against {rows[name]['ms'] * n:.3f} ms warm and "
            f"{rows[name]['cold_ms'] * n:.3f} ms cold (phase 2 per launch "
            f"x launches)")
    print(f"trace (b) on {card}: detect_video on the 200-frame {W}x{H} "
          f"clip untraced {n_frames / walls['untraced']:.2f} frames/s "
          f"({walls['untraced']:.3f} s), traced "
          f"{n_frames / walls['traced']:.2f} frames/s ({walls['traced']:.3f}"
          f" s: the profiler's start {cost['start_s']:.3f} s, stop "
          f"{cost['stop_s']:.3f} s, export {cost['export_s']:.3f} s of "
          f"{cost['bytes'] / 2**20:.1f} MiB); records equal; "
          f"{'; '.join(per_kernel)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_dryrun(card: str) -> dict:
    """``metdetpy_tpu_torch.dryrun`` on the card: ``entry()``'s step and
    the six programs of ``dryrun_multichip(8)`` with the 8 shards on the
    card, the step and programs 1-3 held to the same on the CPU bit for
    bit; on a machine with 2 or more cards, once more with a card a shard
    (n = the cards, at most 8); the CLI in a subprocess. Returns the
    launch counts of the in-process run on one card (entry and the
    shared pass)."""
    from metdetpy_tpu_torch import dryrun
    from metdetpy_tpu_torch.ops import kernels as K
    from metdetpy_tpu_torch.parallel.mesh import build_mesh
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    fn, args = dryrun.entry("cuda")
    outs = fn(*args)
    runs = {"8 shards on one card": (8, dryrun.dryrun_multichip(
        8, device="cuda", shared=True))}
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    _require_launches("dryrun", launches)
    cfn, cargs = dryrun.entry("cpu")
    for i, (a, b) in enumerate(zip(outs[:5], cfn(*cargs)[:5])):
        if not torch.equal(a.cpu(), b):
            fail(f"dryrun entry: output {i} on the card differs from the "
                 f"CPU's ({int((a.cpu() != b).sum())} values)")
    n_cards = min(8, torch.cuda.device_count())
    if n_cards >= 2:
        runs[f"a card a shard, {n_cards} cards"] = (
            n_cards, dryrun.dryrun_multichip(n_cards, device="cuda"))
    for layout, (n, res) in runs.items():
        cpu = build_mesh(n, device="cpu")
        want = {"stream": dryrun.stream_step(cpu),
                "temporal": dryrun.temporal(cpu),
                "streaming": dryrun.streaming_temporal(cpu)[:2]}
        got = {"stream": (res["stream"]["packed"], res["stream"]["total"]),
               "temporal": (res["temporal"]["packed"],
                            res["temporal"]["dst"]),
               "streaming": (res["streaming"]["packed1"],
                             res["streaming"]["packed2"])}
        for prog, arrays in got.items():
            for a, b in zip(arrays, want[prog]):
                if not np.array_equal(a, b):
                    fail(f"dryrun {prog} ({layout}): the card's output "
                         f"differs from the CPU's")
        if len(res["data_parallel"]["results"]) != n + 3:
            fail(f"dryrun data-parallel ({layout}): "
                 f"{len(res['data_parallel']['results'])} results for "
                 f"{n + 3} images")
        tfr, stacks2 = (res["temporal_dldet"]["frames"],
                        res["temporal_dldet"]["stacks2"])
        if not np.array_equal(stacks2[0], np.max(tfr[[-2, -1, 0]], axis=0)):
            fail(f"dryrun temporal-dldet ({layout}): the carried tail is "
                 f"missing from shard 0")
    in_process_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "metdetpy_tpu_torch.dryrun", "8", "--shared"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    lines = run.stdout.strip().splitlines()
    if run.returncode != 0 or len(lines) != 7 or \
            not lines[0].startswith("entry OK"):
        fail(f"dryrun CLI exited {run.returncode} with {len(lines)} lines: "
             f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
    losses = ", ".join(f"{res['train']['loss']:.4f}"
                       for _, res in runs.values())
    print(f"dryrun on {card}: entry and 6 programs ({'; '.join(runs)}) "
          f"in {in_process_s:.1f} s, programs 1-3 and the entry step equal "
          f"to the CPU's bit for bit, train loss {losses}; launches "
          f"{launches}; python -m metdetpy_tpu_torch.dryrun 8 --shared in "
          f"{cli_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def phase_profile_step(card: str) -> dict:
    """``metdetpy_tpu_torch.profile_step`` on the card: the quiet step's
    stages, the dense Hough stages and the active-sky split, each stage
    with its three readings and its graph held to its eager call (the
    module raises where a capture fails, a replay differs or a profile
    lacks a kernel's records). Returns the launch counts of the three
    runs."""
    from metdetpy_tpu_torch import profile_step
    from metdetpy_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    seconds = {}
    K.reset_launch_counts()
    for tool in profile_step.TOOLS:
        t0 = time.perf_counter()
        records = profile_step.main([tool, "--quick", "--h", str(H), "--w",
                                     str(W), "--t", str(T_BLOCK)])
        seconds[tool] = round(time.perf_counter() - t0, 1)
        for rec in records:
            readings = [rec[k] for k in ("slope_ms", "device_ms",
                                         "graph_ms", "launches")]
            if None in readings or (not rec.get("derived")
                                    and rec["graph_equal"] is not True):
                fail(f"profile_step {tool} {rec['stage']}: {rec}")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    _require_launches("profile_step", launches)
    print(f"profile_step on {card}: block, dense and split --quick, every "
          f"graph replay equal to its eager call, launches {launches}; "
          f"seconds {seconds}; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches

STEP_GRAPH_BLOCKS = 27   # the warm-up block and all 25 EMA phases (and one)


def _carry_tensors(gray, sub, dy, ema, timer) -> list:
    return [gray, sub, dy, *ema.tensors(), timer]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _host_launches(fn) -> dict:
    """{CUDA runtime call: count} of the host's calls during ``fn()``
    (launches, graph launches, copies, fills), from ``torch.profiler``'s
    CPU activity, and the device records."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        fn()
        torch.cuda.synchronize()
    calls, device = {}, 0
    for ev in prof.key_averages():
        if ev.key.startswith("cuda") and ev.key[4:5].isupper() and any(
                w in ev.key for w in ("Launch", "Memcpy", "Memset")):
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
        elif ev.device_type == torch.autograd.DeviceType.CUDA and \
                getattr(ev, "self_device_time_total", 0):
            device += ev.count
    return {"runtime_calls": calls, "total": sum(calls.values()),
            "device_records": device}


def _host_ms(fn, n: int) -> float:
    """Median host ms of ``fn()`` over ``n`` calls, no wait for the card
    between them (the card drains the queue behind)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def phase_step_graph(card: str) -> dict:
    """The M3 step as one CUDA graph a block (``detectors.step_graph``):
    (a) one M3Detector at 960x540 runs 27 consecutive 64-frame blocks
    through its graph, the launch counts set to 0 just before and read just
    after; each block's packed buffer, dst, every carry and the timer equal
    the eager ``_m3_block_step`` chain on the card bit for bit, and blocks
    0, 1, 13 and 26 from the same carries equal the CPU's packed buffers;
    the replay's device ms, the host ms a block of the graph and of the
    eager step, and the host's runtime calls of one block each; the graph
    adopted by a second detector and a third's released; (b)
    ``detect_video`` with m3det_normal (recheck off) on (a)'s clip at
    1920x1080, 1024 frames, detected at 960x540: frames/s, ``dispatch_s``,
    host ms a block. Returns the launch counts of (a)."""
    from metdetpy_tpu_torch import bench
    from metdetpy_tpu_torch.detectors import step_graph
    from metdetpy_tpu_torch.detectors.m3det import (_m3_block_step,
                                                    load_state_numpy)
    from metdetpy_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    step_graph.clear_idle()  # earlier phases left graphs of this shape
    n_clip = 4
    frames, _, _ = synth_clip(W, H, n_clip * T_BLOCK / FPS, 2.0, 4.0,
                              color=False)
    blocks = [torch.from_numpy(frames[i * T_BLOCK:(i + 1) * T_BLOCK]).cuda()
              for i in range(n_clip)]
    cfg = preset_cfg("m3det_normal", recheck=False)
    det = bench._m3_detector(cfg, H, W, "cuda")
    kw = det._step_static_kwargs()
    n_captures = len(step_graph.CAPTURES)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    graph_out = []
    for b in range(STEP_GRAPH_BLOCKS):
        packed, dst = det.process_block_async(blocks[b % n_clip])
        graph_out.append((packed, dst, [x.clone() for x in _carry_tensors(
            det._gray_hist, det._sub_hist, det._dy_hist, det._ema,
            det._timer_dev)]))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    _require_launches("step graph", launches)
    captures = step_graph.CAPTURES[n_captures:]
    if len(captures) != 1:
        fail(f"step graph: {len(captures)} captures for one block shape")
    if det.timer != STEP_GRAPH_BLOCKS * T_BLOCK:
        fail(f"step graph: the host's timer reads {det.timer}")

    # the eager chain from the same start (a fresh detector's carries),
    # compared block by block
    ref = bench._m3_detector(cfg, H, W, "cuda")
    carry = [ref._gray_hist, ref._sub_hist, ref._dy_hist, ref._ema,
             ref._timer_dev]
    del ref
    n_lines = 0
    for b, (packed, dst, carries) in enumerate(graph_out):
        out = _m3_block_step(*carry[:4], blocks[b % n_clip], carry[4], **kw)
        carry = list(out[2:])
        want = _carry_tensors(*carry)
        names = ["gray", "sub", "dy", "ema.cur_value", "ema.t",
                 "ema.warmup_on", "ema.cur_momentum", "ema.bi_threshold",
                 "ema.bi_thr_float", "timer"]
        for name, got, exp in [("packed", packed, out[0]),
                               ("dst", dst, out[1]),
                               *zip(names, carries, want)]:
            if not _same_bits(got, exp):
                fail(f"step graph: block {b}'s {name} differs from the "
                     f"eager step's")
        n_lines += int((packed[:, MAX_PEAKS * 4:MAX_PEAKS * 5] > 0.5).sum())
    if int(carry[4]) != STEP_GRAPH_BLOCKS * T_BLOCK or n_lines == 0:
        fail(f"step graph: timer {int(carry[4])}, {n_lines} lines")

    # the CPU's step from the graph's carries before the block
    cpu_checked = []
    for b in (0, 1, 13, 26):
        cdet = bench._m3_detector(cfg, H, W, "cpu")
        if b:
            prev = [x.cpu().numpy() for x in graph_out[b - 1][2]]
            load_state_numpy(cdet, {"gray_hist": prev[0],
                                    "sub_hist": prev[1], "dy_hist": prev[2],
                                    "ema": prev[3:9], "timer": b * T_BLOCK})
        want, _ = cdet.process_block_async(blocks[b % n_clip].cpu())
        if not np.array_equal(graph_out[b][0].cpu().numpy(), want.numpy()):
            fail(f"step graph: block {b}'s packed buffer differs from the "
                 f"CPU's")
        cpu_checked.append(b)
    first_packed = graph_out[0][0]
    del graph_out

    # device ms of a replay, host ms a block, runtime calls of one block
    blk = blocks[0]
    replay_ms = cuda_ms(lambda: det.process_block_async(blk), 20)
    graph_host_ms = _host_ms(lambda: det.process_block_async(blk), 20)
    eager_host_ms = _host_ms(lambda: _m3_block_step(
        det._gray_hist, det._sub_hist, det._dy_hist, det._ema, blk,
        det._timer_dev, **kw), 10)
    graph_calls = _host_launches(lambda: det.process_block_async(blk))
    eager_calls = _host_launches(lambda: _m3_block_step(
        det._gray_hist, det._sub_hist, det._dy_hist, det._ema, blk,
        det._timer_dev, **kw))
    # the graph outlives its detector: the next detector of these carry
    # shapes adopts it (no capture, from its own fresh state); a second
    # graph of the same shapes goes with its detector, pool and all
    cap = captures[0]
    del det
    gc.collect()
    n_captures = len(step_graph.CAPTURES)
    det2 = bench._m3_detector(cfg, H, W, "cuda")
    again, _ = det2.process_block_async(blocks[0])
    if len(step_graph.CAPTURES) != n_captures or not torch.equal(
            again, first_packed):
        fail("step graph: a second detector did not replay the first "
             "one's graph from its own fresh state")
    det3 = bench._m3_detector(cfg, H, W, "cuda")
    det3.process_block_async(blocks[0])
    if len(step_graph.CAPTURES) != n_captures + 1:
        fail("step graph: a detector beside one that holds the graph did "
             "not capture its own")
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    del det2, det3, blocks
    gc.collect()
    torch.cuda.empty_cache()
    released = reserved - torch.cuda.memory_reserved()
    if released < cap["pool_bytes"] // 2:
        fail(f"step graph: dropping two detectors of one shape released "
             f"{released} bytes; a graph pool holds {cap['pool_bytes']}")
    print(f"step graph on {card}: {STEP_GRAPH_BLOCKS} blocks of "
          f"{T_BLOCK}x{H}x{W} through M3Detector's graph, packed, dst, every "
          f"carry and the timer equal to the eager step's bit for bit, "
          f"blocks {cpu_checked} equal to the CPU's; {n_lines} lines; "
          f"launches {launches}; capture {cap['seconds']:.3f} s after "
          f"warm-ups of {cap['warmup_seconds']:.3f} s, pool "
          f"{cap['pool_bytes']} bytes (the graph adopted by the next "
          f"detector, a second one's {released} bytes released with it), "
          f"kernel launches a replay "
          f"{cap['launches']}; a block on the card {replay_ms:.4f} ms "
          f"(replay with its input copy and output clones); host ms a block "
          f"{graph_host_ms:.4f} (graph) against {eager_host_ms:.4f} (eager "
          f"step); the host's runtime calls of one block: graph "
          f"{json.dumps(graph_calls)}, eager {json.dumps(eager_calls)}",
          flush=True)

    # (b) the main path at camera size
    fw, fh = 2 * W, 2 * H
    # (a)'s clip at camera size, each pixel 2x2 (the 2:1 preprocess gives
    # (a)'s frames back), four times over: 2.1 GB, read as views
    clip = np.concatenate([frames.repeat(2, axis=1).repeat(2, axis=2)] * 4)
    n_frames = clip.shape[0]
    n_captures = len(step_graph.CAPTURES)
    mdrf, run_launches, wall = _run_m3(
        clip, preset_cfg("m3det_normal", recheck=False), "cuda")
    del clip
    _require_launches("step graph detect_video", run_launches)
    perf = mdrf.performance
    if perf["recovered_blocks"] or not mdrf.results:
        fail(f"step graph detect_video: {perf['recovered_blocks']} blocks "
             f"dropped, {len(mdrf.results)} records")
    n_blocks = n_frames // T_BLOCK
    # the detector adopts the graph (a) left idle, so the run holds no
    # capture; where it does, the first block's dispatch holds it
    run_caps = step_graph.CAPTURES[n_captures:]
    first_s = sum(c["warmup_seconds"] + c["seconds"] for c in run_caps)
    print(f"step graph detect_video on {card}: m3det_normal (recheck off), "
          f"{n_frames} frames {fw}x{fh} -> {W}x{H} in {wall:.3f} s = "
          f"{n_frames / wall:.2f} frames/s; dispatch_s "
          f"{perf.get('dispatch_s')} for {n_blocks} blocks, of it "
          f"{first_s:.3f} s of {len(run_caps)} capture(s): "
          f"{1e3 * (perf['dispatch_s'] - first_s) / n_blocks:.3f} host ms "
          f"a block besides; perf {json.dumps(perf)}; launches "
          f"{run_launches}", flush=True)
    caps = [(c["key"][1], round(c["warmup_seconds"], 3),
             round(c["seconds"], 3), c["pool_bytes"])
            for c in step_graph.CAPTURES]
    print(f"step graph: the {len(caps)} captures of this process (block "
          f"shape, warm-up s, capture s, reserved-memory growth; the "
          f"growth also counts what other threads allocated meanwhile): "
          f"{caps}; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


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
    ms_launches = phase_multistream(card)
    clip = _color_clip(2 * T_BLOCK)
    phase_multistream_dldet(card, clip)
    temporal_launches = phase_temporal(card, clip)
    del clip
    phase_data_parallel(card)
    phase_train(card)
    bench_launches = phase_bench(card)
    frozen_launches = phase_frozen_and_trace(card, rows)
    dryrun_launches = phase_dryrun(card)
    profile_step_launches = phase_profile_step(card)
    step_graph_launches = phase_step_graph(card)
    shutil.rmtree(FILES)
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["multistream_launches"] = ms_launches[name]
        row["temporal_launches"] = temporal_launches[name]
        row["bench_launches"] = bench_launches[name]
        row["frozen_entry_launches"] = frozen_launches[name]
        row["dryrun_launches"] = dryrun_launches[name]
        row["profile_step_launches"] = profile_step_launches[name]
        row["step_graph_launches"] = step_graph_launches[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
