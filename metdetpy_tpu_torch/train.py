"""Produce YOLOv5s weights by training on synthetic meteor scenes, on the
port's device:

    python -m metdetpy_tpu_torch.train [--steps 1500] [--batch 8] [--hw 320]
        [--lr 1e-3] [--out PATH] [--seed 0] [--device cuda|cpu]

The arguments of ``tools/train_synth_weights.py`` plus ``--device``
(``cuda``, the default, raises without a card). Trains the YOLOv5s of
``models/yolov5.py`` with ``models.train.fit_synthetic`` and writes the
flattened flax tree (``models.weights.save_params``), the file the JAX
package writes, so the weights load in both packages through a config's
``model_path``; by default over ``weights/yolov5s_v5.flax.npz``. The last
line printed is a JSON object of the run's timings: steps, seconds, steps
per second, the host seconds of ``synth_batch`` and of a step per step,
and on a card the peak of allocated device memory.
"""

import argparse
import json
import time

import torch

from . import resolve_device
from .models import train
from .models.weights import save_params
from .profiling import StageTimer
from .utils import relative2abs_path


class _PrintLogger:
    def info(self, msg):
        print(msg, flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m metdetpy_tpu_torch.train",
        description="Train YOLOv5s on synthetic meteor scenes.")
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--hw", type=int, default=320)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on: cuda (default) or cpu.")
    return parser


def main(argv=None):
    """Run the entry point with ``argv``; returns the trained model."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out = args.out or relative2abs_path("./weights/yolov5s_v5.flax.npz")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timer = StageTimer()
    t0 = time.perf_counter()
    model = train.fit_synthetic(
        steps=args.steps, batch=args.batch, input_hw=(args.hw, args.hw),
        lr=args.lr, seed=args.seed, log_every=50, logger=_PrintLogger(),
        device=args.device, timer=timer)
    seconds = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {seconds:.0f}s", flush=True)
    save_params(model, out)
    print(f"saved weights to {out}", flush=True)
    t = timer.totals
    print(json.dumps({
        "steps": args.steps, "batch": args.batch, "hw": args.hw,
        "device": str(dev), "seconds": seconds,
        "steps_per_s": args.steps / seconds,
        "synth_batch_s_per_step": t["synth_batch"] / args.steps,
        "step_s_per_step": t["step"] / args.steps,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None)}),
        flush=True)
    return model


if __name__ == "__main__":
    main()
