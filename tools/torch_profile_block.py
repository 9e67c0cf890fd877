"""Where the time of one M3 block goes in the PyTorch/CUDA port.

    python3 tools/torch_profile_block.py [--blocks 8] [--out DIR]

Runs the port's M3 block step (``M3Detector.process_block_async``) at the
main path's full width -- 960x540 frames, 64-frame blocks, a 25-frame
window, 8192 points, 64 peaks, dynamic mask -- on a synthetic sky with one
meteor, made from a seed, on one GPU. After two warm-up blocks it reports:

- device-resident blocks: host wall ms per block (all blocks enqueued, one
  synchronize at the end) and the frames per second that gives;
- the same with the host->device upload of each block from numpy (what
  ``detect_video`` does);
- under ``torch.profiler``: device time per kernel name, summed over the
  profiled blocks, the four hand-written kernels marked, the device-busy
  total and the idle share of the wall time;

as one JSON line, beside the card's name and power limit. The full
profiler table goes to ``DIR/profile_block.txt`` when ``--out`` is given.
It needs a card and exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

W, H, FPS, T_BLOCK = 960, 540, 25.0, 64
SEED = 20261016
KERNEL_SYMBOLS = {"window_diff_kernel": "window_diff",
                  "median_binarize_close_kernel": "median_binarize_close",
                  "hough_vote_kernel": "hough_vote",
                  "walk_pick_kernel": "walk_pick"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_block: needs a GPU")
    from metdetpy_tpu_torch.detectors.m3det import M3Detector
    from metdetpy_tpu_torch.log import get_default_logger
    from metdetpy_tpu_torch.ops import kernels
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
    from metdetpy_tpu_torch.utils import relative2abs_path

    n_blocks = args.blocks + 2
    frames = generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=n_blocks * T_BLOCK / FPS,
        meteors=[SynthMeteor(start_sec=4.0, end_sec=6.0, pt1=(432, 135),
                             pt2=(288, 297))], n_stars=150, noise_sigma=3.0,
        seed=SEED)
    blocks = [np.ascontiguousarray(frames[i * T_BLOCK:(i + 1) * T_BLOCK])
              for i in range(n_blocks)]
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json")).detector.cfg
    mask = np.ones((H, W), np.uint8)

    def detector():
        return M3Detector(1.0, FPS, mask, 4, cfg, get_default_logger(),
                          max_points=8192, max_peaks=64, device="cuda")

    dev_blocks = [torch.from_numpy(b).cuda() for b in blocks]
    torch.cuda.synchronize()

    def run(det, source, first, last):
        t0 = time.perf_counter()
        out = [det.process_block_async(source[i])[0]
               for i in range(first, last)]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (last - first), out

    det = detector()
    run(det, dev_blocks, 0, 2)                      # warm-up
    resident_ms, _ = run(det, dev_blocks, 2, n_blocks)
    det = detector()
    run(det, blocks, 0, 2)
    upload_ms, packed = run(det, blocks, 2, n_blocks)
    n_lines = int(sum(float(p[:, 64 * 4:64 * 5].sum()) for p in packed))

    det = detector()
    run(det, dev_blocks, 0, 2)
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall_ms, _ = run(det, dev_blocks, 2, n_blocks)
    launches = {k: v / args.blocks for k, v in kernels.LAUNCHES.items()}
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        self_dev = getattr(ev, "self_device_time_total", dev_us)
        if ev.device_type == torch.autograd.DeviceType.CUDA and self_dev:
            busy_us += self_dev
            rows.append((self_dev, ev.key, ev.count))
    rows.sort(reverse=True)
    per_block = args.blocks
    kernel_ms = {KERNEL_SYMBOLS[k]: round(t / per_block / 1e3, 5)
                 for t, name, _ in rows for k in KERNEL_SYMBOLS if k in name}
    top = [{"name": name[:80], "ms_per_block": round(t / per_block / 1e3, 5),
            "calls_per_block": c / per_block} for t, name, c in rows[:15]]
    device_ms = busy_us / per_block / 1e3
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_block.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))
    card = card_line()
    print(card)
    print(json.dumps({
        "card": card, "shape": [T_BLOCK, H, W], "blocks": args.blocks,
        "lines_found": n_lines,
        "resident_ms_per_block": round(resident_ms, 4),
        "resident_fps": round(T_BLOCK * 1e3 / resident_ms, 2),
        "upload_ms_per_block": round(upload_ms, 4),
        "upload_fps": round(T_BLOCK * 1e3 / upload_ms, 2),
        "profiled_wall_ms_per_block": round(prof_wall_ms, 4),
        "device_busy_ms_per_block": (round(device_ms, 4) if rows
                                     else "not measured"),
        "device_idle_share": (round(1 - device_ms / prof_wall_ms, 4)
                              if rows else "not measured"),
        "kernel_ms_per_block": kernel_ms,
        "launches_per_block": launches,
        "top_device_ops": top}))


if __name__ == "__main__":
    main()
