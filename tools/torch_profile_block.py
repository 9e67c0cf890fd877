"""Where the time of one block goes in the PyTorch/CUDA port.

    python3 tools/torch_profile_block.py [--path m3|dldet] [--blocks 8]
                                         [--out DIR]

``--path m3`` (the default) runs the port's M3 block step
(``M3Detector.process_block_async``) at the main path's full width -- 960x540 frames, 64-frame blocks, a 25-frame
window, 8192 points, 64 peaks, dynamic mask -- on a synthetic sky with one
meteor, made from a seed, on one GPU. After two warm-up blocks it reports:

- device-resident blocks: host wall ms per block (all blocks enqueued, one
  synchronize at the end) and the frames per second that gives;
- the same with the host->device upload of each block from numpy (what
  ``detect_video`` does);
- under ``torch.profiler``: device time per kernel name, summed over the
  profiled blocks, the hand-written kernels marked, the device-busy
  total and the idle share of the wall time;

as one JSON line, beside the card's name and power limit. The full
profiler table goes to ``DIR/profile_block.txt`` when ``--out`` is given.

``--path dldet`` does the same for the deep-learning path as
``config/dldet.json`` ships it: ``MLDetector`` on 960x544 colour blocks of
64 merged frames (window n=2, one pyramid level of two tiles, so 128 crops
of 320x320 a block, YOLOv5s in bfloat16). A block is dispatched with
``process_block_async`` and the run's blocks are collected with one
``collect_many``, as ``detect_video`` does. Besides the three reports above
(the profiler's table then goes to ``DIR/profile_block_dldet.txt``, and the
library kernels that carry the path are listed with their calls per block)
it times the parts of a block on their own with CUDA events: the window
max, normalise + crops + cubic resize, the network, decode + top-k, the
batched NMS of a block's candidates ([64, 128], as the collect runs it),
and the orientation of 64 kept rows (the single-scale path's; the shipped
path reads its ROIs back instead).

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
KERNEL_SYMBOLS = {f"{name}_kernel": name for name in (
    "window_diff", "median_binarize_close", "hough_vote", "walk_pick",
    "peak_ladder", "corner_planes", "walk_geom", "walk_finish")}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, iters: int = 5) -> float:
    """Device ms per call of ``fn``, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(prof):
    """[(self device us, name, calls)] of the profile's device kernels,
    largest first, and their sum."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        self_dev = getattr(ev, "self_device_time_total", dev_us)
        if ev.device_type == torch.autograd.DeviceType.CUDA and self_dev:
            rows.append((self_dev, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows)


def profile_dldet(args) -> None:
    from metdetpy_tpu_torch.detectors import mldet
    from metdetpy_tpu_torch.log import get_default_logger
    from metdetpy_tpu_torch.models import yolo
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
    from metdetpy_tpu_torch.utils import get_num_class, relative2abs_path

    w, h = 960, 544
    n_blocks = args.blocks + 2
    # 16 merged frames as the preset's 0.5 s exposure makes them (the max of
    # 12 raw frames each), a 2 s meteor in 4 of them; a block is these 16
    # four times over, and every block of the run is this one
    raw = generate_meteor_video(
        width=w, height=h, fps=FPS, duration_sec=16 * 12 / FPS,
        meteors=[SynthMeteor(start_sec=2.0, end_sec=4.0, pt1=(432, 135),
                             pt2=(288, 297))],
        n_stars=150, noise_sigma=3.0, seed=SEED, color=True)
    merged = raw[:16 * 12].reshape(16, 12, h, w, 3).max(axis=1)
    block = np.ascontiguousarray(np.tile(merged, (T_BLOCK // 16, 1, 1, 1)))
    blocks = [block] * n_blocks
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/dldet.json")).detector
    mask = np.ones((h, w, 3), np.uint8)

    def detector():
        return mldet.MLDetector(cfg.window_sec, 2.0, mask, get_num_class(),
                                cfg.cfg, get_default_logger(), device="cuda")

    dev_blocks = [torch.from_numpy(block).cuda()] * n_blocks
    torch.cuda.synchronize()

    def run(det, source, first, last):
        """(dispatch ms, collect ms) per block and the results."""
        t0 = time.perf_counter()
        handles = [det.process_block_async(source[i])
                   for i in range(first, last)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = det.collect_many(handles)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n = last - first
        return (t1 - t0) * 1e3 / n, (t2 - t1) * 1e3 / n, out

    det = detector()
    run(det, dev_blocks, 0, 2)                      # warm-up
    res_dispatch, res_collect, results = run(det, dev_blocks, 2, n_blocks)
    n_boxes = sum(len(p) for blk in results for p, _ in blk)
    det = detector()
    run(det, blocks, 0, 2)
    up_dispatch, up_collect, _ = run(det, blocks, 2, n_blocks)

    det = detector()
    run(det, dev_blocks, 0, 2)
    yolo.CALLS.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        p_dispatch, p_collect, _ = run(det, dev_blocks, 2, n_blocks)
    rows, busy_us = device_rows(prof)
    per_block = args.blocks
    prof_wall = p_dispatch + p_collect
    device_ms = busy_us / per_block / 1e3
    top = [{"name": name[:80], "ms_per_block": round(t / per_block / 1e3, 5),
            "calls_per_block": c / per_block} for t, name, c in rows[:20]]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_block_dldet.txt"),
                  "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=80))

    # the parts of one block, each alone
    model = det.model
    net = model.model
    k = model._k_budget()
    _, (tiles,) = model._plan_tiles(h, w)
    rng = np.random.default_rng(SEED)
    with torch.inference_mode():
        hist = torch.zeros((det.n - 1, h, w, 3), dtype=torch.uint8,
                           device="cuda")
        stacks = mldet._window_max_color(hist, dev_blocks[2], det.n)[0]

        def crops_of(x):
            x = yolo._unit_f32(x)
            c = torch.stack([x[:, y0:y0 + hs, x0:x0 + ws]
                             for (y0, x0, hs, ws) in tiles], dim=1)
            return c.reshape(-1, *c.shape[2:])
        raw_crops = crops_of(stacks)
        crops = yolo._resize_to(raw_crops, (model.h, model.w))
        heads = net(crops)
        from metdetpy_tpu_torch.models import yolov5
        preds = yolov5.decode_predictions(heads, net.nc)
        cand = torch.from_numpy(np.concatenate([
            rng.uniform(0, 900, (T_BLOCK, 128, 2)),
            rng.uniform(0, 900, (T_BLOCK, 128, 2)) + 40], axis=-1).astype(
                np.float32)).cuda()
        scores = torch.from_numpy(rng.uniform(0.3, 1, (T_BLOCK, 128)).astype(
            np.float32)).cuda()
        packed = torch.zeros((64, 6 + net.nc), device="cuda")
        c = torch.from_numpy(rng.uniform(20, 300, (64, 2)).astype(np.float32))
        packed[:, 0] = torch.arange(64)
        packed[:, 1:3] = (c - 12).cuda()
        packed[:, 3:5] = (c + 12).cuda()
        parts = {
            "window_max": events_ms(lambda: mldet._window_max_color(
                hist, dev_blocks[2], det.n)),
            "normalise_crops": events_ms(lambda: crops_of(stacks)),
            "cubic_resize": events_ms(lambda: yolo._resize_to(
                raw_crops, (model.h, model.w))),
            "network_forward": events_ms(lambda: net(crops)),
            "decode": events_ms(lambda: yolov5.decode_predictions(
                heads, net.nc)),
            "top_k": events_ms(lambda: yolo._topk_compact(preds, k, 0.25)),
            "nms_64x128": events_ms(lambda: yolo._nms_batch(
                cand, scores, 0.25, 0.1), 3),
            "orientation_64_rows": events_ms(
                lambda: mldet._orient_from_packed(
                    stacks, packed, w / model.w, h / model.h, 96)),
        }
    card = card_line()
    print(card)
    print(json.dumps({
        "card": card, "path": "dldet", "shape": [T_BLOCK, h, w, 3],
        "crops_per_block": int(crops.shape[0]), "blocks": args.blocks,
        "boxes_found": n_boxes,
        "resident_dispatch_ms_per_block": round(res_dispatch, 4),
        "resident_collect_ms_per_block": round(res_collect, 4),
        "resident_merged_fps": round(
            T_BLOCK * 1e3 / (res_dispatch + res_collect), 2),
        "upload_dispatch_ms_per_block": round(up_dispatch, 4),
        "upload_collect_ms_per_block": round(up_collect, 4),
        "upload_merged_fps": round(
            T_BLOCK * 1e3 / (up_dispatch + up_collect), 2),
        "profiled_wall_ms_per_block": round(prof_wall, 4),
        "device_busy_ms_per_block": (round(device_ms, 4) if rows
                                     else "not measured"),
        "device_idle_share": (round(1 - device_ms / prof_wall, 4)
                              if rows else "not measured"),
        "device_kernel_launches_per_block": (
            sum(r[2] for r in rows) / per_block if rows else "not measured"),
        "network_forwards_per_block": yolo.CALLS["network"] / per_block,
        "parts_ms": {k_: round(v, 4) for k_, v in parts.items()},
        "top_device_ops": top}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=["m3", "dldet"], default="m3")
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_block: needs a GPU")
    if args.path == "dldet":
        profile_dldet(args)
        return
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
    rows, busy_us = device_rows(prof)
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
