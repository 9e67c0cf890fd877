"""Host copy rates of one 1080p block into pinned memory, on a card's host.

    python3 tools/torch_stage_copy_rate.py [--frames 1500] [--block 64]
        [--reps 3]

Makes a clip-sized gray array in pageable memory (``--frames`` frames of
1920x1080, 3.11 GB at 1500) and one pinned slot of ``--block`` frames,
then copies the array's blocks into the slot in order, so each read is
cold (the array is many times the host's last-level cache), with:
``np.copyto`` on one thread; ``np.copyto`` over frame slices on 2, 4 and
8 threads (a thread pool, the lock released in the copy); and torch's CPU
``copy_`` with the intra-op pool at 1, 2, 4 and 8 threads. Each form
passes over the whole array ``--reps`` times; one JSON line a form gives
its median milliseconds a block and GB/s. Then the same slices at 4
threads while another thread uploads a second pinned slot to the card
without pause (the copy engine reads host memory too), and for reference
the card's upload of one block from pageable memory and from the pinned
slot (CUDA events). Prints the card's name and power limit first.
"""

import argparse
import json
import os
import statistics
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def sliced_copy(pool, threads: int, dst: np.ndarray, src: np.ndarray):
    n = src.shape[0]
    cuts = [n * i // threads for i in range(threads + 1)]
    futs = [pool.submit(np.copyto, dst[a:b], src[a:b])
            for a, b in zip(cuts, cuts[1:]) if b > a]
    for f in futs:
        f.result()


def time_form(name, copy, src, slot, reps, block):
    times = []
    for _ in range(reps):
        for a in range(0, src.shape[0] - block + 1, block):
            t0 = time.perf_counter()
            copy(slot, src[a:a + block])
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    line = {"form": name, "blocks": len(times),
            "ms_per_block": round(med * 1e3, 3),
            "ms_min": round(min(times) * 1e3, 3),
            "ms_max": round(max(times) * 1e3, 3),
            "gb_per_s": round(slot.nbytes / med / 1e9, 2)}
    print(json.dumps(line), flush=True)
    return line


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps({"card": card_line(), "cpus": os.cpu_count(),
                      "torch_threads": torch.get_num_threads(),
                      "torch": torch.__version__}), flush=True)
    h, w, bf = 1080, 1920, args.block
    t0 = time.perf_counter()
    src = np.empty((args.frames, h, w), np.uint8)
    src[...] = np.arange(w, dtype=np.uint8)  # faulted in
    alloc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slot_t = torch.empty((bf, h, w), dtype=torch.uint8, pin_memory=True)
    pin_s = time.perf_counter() - t0
    slot = slot_t.numpy()
    slot[...] = 0
    print(json.dumps({"array_gb": round(src.nbytes / 1e9, 3),
                      "array_fill_s": round(alloc_s, 3),
                      "block_mb": round(slot.nbytes / 1e6, 1),
                      "pin_s": round(pin_s, 4)}), flush=True)
    default_threads = torch.get_num_threads()
    time_form("np.copyto x1", np.copyto, src, slot, args.reps, bf)
    for n in (2, 4, 8):
        with ThreadPoolExecutor(n) as pool:
            time_form(f"np slices x{n}",
                      lambda d, s, p=pool, k=n: sliced_copy(p, k, d, s),
                      src, slot, args.reps, bf)
    for n in (1, 2, 4, 8):
        torch.set_num_threads(n)
        time_form(f"torch copy_ x{n}",
                  lambda d, s: torch.from_numpy(d).copy_(torch.from_numpy(s)),
                  src, slot, args.reps, bf)
    torch.set_num_threads(default_threads)
    # beside a copy engine that reads pinned host memory without pause
    dev_dst = torch.empty((bf, h, w), dtype=torch.uint8, device="cuda")
    other = torch.empty((bf, h, w), dtype=torch.uint8, pin_memory=True)
    stop = threading.Event()
    uploads = [0]

    def upload():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            while not stop.is_set():
                dev_dst.copy_(other, non_blocking=True)
                stream.synchronize()
                uploads[0] += 1

    th = threading.Thread(target=upload, daemon=True)
    th.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    n0 = uploads[0]
    with ThreadPoolExecutor(4) as pool:
        time_form("np slices x4 beside uploads",
                  lambda d, s: sliced_copy(pool, 4, d, s),
                  src, slot, args.reps, bf)
    up_rate = (uploads[0] - n0) * other.nbytes / (time.perf_counter() - t0)
    stop.set()
    th.join(timeout=30)
    print(json.dumps({"uploads_beside_gb_per_s": round(up_rate / 1e9, 2)}),
          flush=True)
    # the card's upload of one block (CUDA events, median of 5)
    for kind, host in (("pageable", torch.from_numpy(src[:bf])),
                       ("pinned", slot_t)):
        ts = []
        for i in range(6):
            host = (torch.from_numpy(src[(i + 1) * bf:(i + 2) * bf])
                    if kind == "pageable" else host)
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            torch.cuda.synchronize()
            a.record()
            dev_dst.copy_(host, non_blocking=True)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        med = statistics.median(ts[1:])
        print(json.dumps({"upload_from": kind, "ms": round(med, 3),
                          "gb_per_s": round(slot.nbytes / med / 1e6, 2)}),
              flush=True)


if __name__ == "__main__":
    main()
