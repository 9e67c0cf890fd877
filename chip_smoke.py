"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. Build: print the card's name and power limit, build the four CUDA
   kernels of the M3 path from ``metdetpy_tpu_torch/csrc`` and print what
   ``ptxas`` reports for each (registers, shared memory, spills).
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
3. End to end: a 960x540, 25 fps, 12 s synthetic clip with one meteor
   through ``metdetpy_tpu_torch.api.detect_video(..., device="cuda")``
   with the m3det_normal preset (recheck off). Requires a METEOR near the
   streak and every kernel launched by that run.
4. Card against CPU: the MDRF of a small clip on the card equals the one
   the port gives on the CPU.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. It imports nothing
of JAX or of the JAX package, and exits non-zero without a card.
"""

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
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


def m3_cfg(resize):
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.utils import relative2abs_path
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = resize
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    return cfg


def phase_end_to_end(card: str) -> dict:
    """The main path at full width; returns the launch counts of its run."""
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.ops import kernels as K
    from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
    from metdetpy_tpu_torch.utils import ts2frame
    pt1, pt2 = (int(W * 0.45), int(H * 0.25)), (int(W * 0.30), int(H * 0.55))
    frames = generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=12.0,
        meteors=[SynthMeteor(start_sec=5.0, end_sec=7.0, pt1=pt1, pt2=pt2)],
        n_stars=150, noise_sigma=3.0, seed=SEED)
    cfg = m3_cfg(960)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    mdrf = detect_video(frames, None, cfg, work_mode="backend",
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
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
    n_frames = frames.shape[0]
    print(f"end to end: {n_frames} frames {W}x{H} in {wall:.3f} s = "
          f"{n_frames / wall:.2f} frames/s on {card}; METEOR "
          f"{best.pt1}->{best.pt2} score {best.score}; launches {launches}; "
          f"perf {json.dumps(mdrf.performance)}", flush=True)
    return launches


def phase_card_vs_cpu() -> None:
    from metdetpy_tpu_torch.api import detect_video
    from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
    w, h = 256, 144
    frames = generate_meteor_video(
        width=w, height=h, fps=FPS, duration_sec=6.5,
        meteors=[SynthMeteor(start_sec=2.4, end_sec=4.4,
                             pt1=(int(w * 0.45), int(h * 0.25)),
                             pt2=(int(w * 0.30), int(h * 0.55)))],
        n_stars=40, noise_sigma=3.0)
    got = {}
    for dev in ("cuda", "cpu"):
        mdrf = detect_video(frames, None, m3_cfg(None), work_mode="backend",
                            device=dev)
        got[dev] = [r.to_dict() for r in mdrf.results]
    if got["cuda"] != got["cpu"]:
        fail(f"MDRF on the card differs from the CPU: {got['cuda']} vs "
             f"{got['cpu']}")
    if not got["cuda"]:
        fail("no record found on the small clip")
    print(f"card vs cpu: {len(got['cuda'])} MDRF record(s) equal",
          flush=True)


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
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
