"""Pad and kernel records a ``profile_step`` profiler window keeps, for two
forms of the window's head, on one GPU.

    python3 tools/torch_profile_pad_check.py [--rounds 100] [--kernels 400]
        [--out chiprun_out/pad_check.jsonl]

Each round opens one window of each form in turns, enqueues ``--kernels``
small kernels (``add_`` on one float) in it, waits for them and stops the
profiler; before each window a small CUDA graph is captured, replayed and
freed (as ``profile_step.graph_reading`` does before the next stage's
window). The forms: ``parent`` (a warm-up step of 64 one-cycle
``spin_kernel`` pads, then 64 more at the head of the recorded step,
launched at once) and ``shipped`` (``profile_step.open_window`` and
``close_window``: longer pads, and a host wait after the window opens and
before it closes). Each window writes one JSON line to ``--out``: its pad
records (of 64), its kernel records against ``--kernels``, and the
microseconds from the trace's start to its first device record. Prints the
card's name and power limit first and one summary line a form last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from metdetpy_tpu_torch import profile_step  # noqa: E402


def parent_open(dev):
    """The window's head before the repair: one-cycle pads, no waits."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
    prof.start()
    for _ in range(profile_step.PAD_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize(dev)
    prof.step()
    for _ in range(profile_step.PAD_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize(dev)
    return prof


def parent_close(prof, dev):
    torch.cuda.synchronize(dev)
    prof.stop()


FORMS = {"parent": (parent_open, parent_close),
         "shipped": (profile_step.open_window, profile_step.close_window)}


def graph_churn(dev):
    """Capture, replay and free a small graph, then empty the cache."""
    x = torch.zeros(1 << 16, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        (x * 2).sum()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = (x * 2).sum()
    g.replay()
    torch.cuda.synchronize(dev)
    del g, y
    torch.cuda.empty_cache()


def window(form, dev, n_kernels):
    opener, closer = FORMS[form]
    x = torch.zeros(1, device=dev)
    prof = opener(dev)
    for _ in range(n_kernels):
        x.add_(1)
    closer(prof, dev)
    res = prof.profiler.kineto_results
    dev_events = [e for e in res.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation()
                  and not e.name().startswith("ProfilerStep")]
    pads = sum("spin_kernel" in e.name() for e in dev_events)
    first = min((e.start_ns() for e in dev_events), default=None)
    return {"form": form, "pads": pads,
            "kernels": len(dev_events) - pads, "want_kernels": n_kernels,
            "first_record_us": (None if first is None
                                else (first - res.trace_start_ns()) / 1e3)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--kernels", type=int, default=400)
    ap.add_argument("--out", default="chiprun_out/pad_check.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no card: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    recs = []
    t0 = time.perf_counter()
    with open(args.out, "w") as f:
        for r in range(args.rounds):
            order = list(FORMS) if r % 2 == 0 else list(FORMS)[::-1]
            for form in order:
                graph_churn(dev)
                rec = {"round": r, **window(form, dev, args.kernels)}
                f.write(json.dumps(rec) + "\n")
                recs.append(rec)
    for form in FORMS:
        rs = [r for r in recs if r["form"] == form]
        firsts = [r["first_record_us"] for r in rs
                  if r["first_record_us"] is not None]
        print(json.dumps({
            "form": form, "windows": len(rs),
            "pad_loss_windows": sum(r["pads"] < profile_step.PAD_KERNELS
                                    for r in rs),
            "all_pads_lost_windows": sum(r["pads"] == 0 for r in rs),
            "kernel_loss_windows": sum(r["kernels"] != r["want_kernels"]
                                       for r in rs),
            "pads_min": min(r["pads"] for r in rs),
            "first_record_us_min": min(firsts, default=None),
            "first_record_us_median": (statistics.median(firsts)
                                       if firsts else None)}), flush=True)
    print(f"{len(recs)} windows in {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
