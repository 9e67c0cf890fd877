"""Time build-time variants of the hough_vote and walk_pick CUDA kernels.

    python3 tools/torch_kernel_variants.py [--vote SPEC ...] [--pick SPEC ...]

A SPEC is a comma-separated list of the sizes a source takes as ``-D``
flags (``csrc/hough_vote.cu``: HV_THETAS, HV_THREADS, HV_POINTS, HV_DRAIN;
``csrc/walk_pick.cu``: WP_COLS), such as ``HV_THETAS=6,HV_DRAIN=2``;
``base`` is the kernel as the package builds it. Each variant is built
through ``metdetpy_tpu_torch.ops.kernels.variant``, held exactly against
the plain version and timed with ``chip_smoke.py``'s harness at the main
path's shapes (CUDA events behind a device sleep; warm repeats one input,
cold rotates through copies of more than twice the L2):

- ``--vote``: the random point lists and the raster-ordered ones of
  ``chip_smoke.py``, warm and cold; a sweep with the same number of valid
  points in all 8 frames (0, 2048, 4096, 8192: 0 is what zeroing and
  storing the histograms cost without a vote); 8192 points that are the
  first pixels of the frame in raster order, whose bins are neighbours at
  most thetas; and the build's ``ptxas`` report;
- ``--pick``: the main-path walks, warm and cold, the empty kernel of the
  variant's grid and the ``ptxas`` report.

The lists are run twice in one process, so the spread between
two readings of one variant shows beside the differences between variants.
Last come the time ``torch.Tensor.zero_`` takes on an array of the votes'
size (what the card needs to write that many bytes) and the card's name and
power limit. One JSON object per line. Needs a GPU.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from metdetpy_tpu_torch.ops import kernels as K  # noqa: E402


def defines(spec: str) -> list:
    return [] if spec == "base" else [f"-D{d}" for d in spec.split(",")]


def ptxas(name: str, flags: list) -> str:
    """Registers, shared memory and spills from the build's ptxas report."""
    lib = K._lib_path(K.SOURCES[name][0], tuple(flags))
    with open(os.path.splitext(lib)[0] + ".log") as f:
        return " | ".join(ln.strip() for ln in f
                          if "Used" in ln or "spill" in ln)


def ms(fn) -> float:
    return round(smoke.cuda_ms(fn, 20), 5)


def vote_sweep(vote, dev) -> dict:
    """Warm ms with ``count`` valid points in every frame, and on the
    first 8192 pixels of the frame."""
    shape, n_rho, off = tuple(vote[0].shape), vote[3], vote[4]
    rng = np.random.default_rng(smoke.SEED + 2)
    xs = torch.from_numpy(rng.integers(0, smoke.W, shape).astype(
        np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, smoke.H, shape).astype(
        np.float32)).to(dev)
    out = {}
    for count in (0, 2048, 4096, 8192):
        valid = (torch.arange(shape[1], device=dev) < count).expand(
            shape).contiguous()
        out[f"points_{count}_ms"] = ms(
            lambda: K.hough_vote(xs, ys, valid, n_rho, off))
    i = torch.arange(shape[1], device=dev).expand(shape)
    xs = (i % smoke.W).float().contiguous()
    ys = (i // smoke.W).float().contiguous()
    out["dense_rows_8192_ms"] = ms(
        lambda: K.hough_vote(xs, ys, valid, n_rho, off))
    return out


def time_vote(spec: str, inputs: dict, dev) -> dict:
    row = {"kernel": "hough_vote", "variant": spec}
    # the plan's thetas per pass follow the variant's HV_THETAS
    knobs = dict(d.split("=") for d in spec.split(",") if "=" in d)
    kept, K.VOTE_THETAS = K.VOTE_THETAS, int(knobs.get("HV_THETAS",
                                                       K.VOTE_THETAS))
    try:
        with K.variant("hough_vote", defines(spec)):
            for label, inp in inputs.items():
                smoke.check_exact(f"hough_vote {spec} ({label})",
                                  K.hough_vote, K.hough_vote_plain, inp)
                row[f"{label}_ms"] = ms(lambda: K.hough_vote(*inp))
                row[f"{label}_cold_ms"] = round(
                    smoke.cold_ms(K.hough_vote, inp), 5)
            row.update(vote_sweep(inputs["random"], dev))
    finally:
        K.VOTE_THETAS = kept
    row["ptxas"] = ptxas("hough_vote", defines(spec))
    return row


def time_pick(spec: str, pick) -> dict:
    with K.variant("walk_pick", defines(spec)):
        smoke.check_exact(f"walk_pick {spec}", K.walk_pick,
                          K.walk_pick_plain, pick)
        return {"kernel": "walk_pick", "variant": spec,
                "ms": ms(lambda: K.walk_pick(*pick)),
                "cold_ms": round(smoke.cold_ms(K.walk_pick, pick), 5),
                "floor_ms": ms(lambda: K.walk_pick_floor(*pick)),
                "ptxas": ptxas("walk_pick", defines(spec))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vote", nargs="*", default=["base"])
    ap.add_argument("--pick", nargs="*", default=["base"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_variants: needs a GPU")
    dev = torch.device("cuda")
    _, _, vote, pick, _, _ = smoke.kernel_inputs(dev)
    inputs = {"random": vote, "raster": smoke.raster_vote_input(dev)}
    for _ in range(2):
        for spec in args.vote:
            print(json.dumps(time_vote(spec, inputs, dev)), flush=True)
        for spec in args.pick:
            print(json.dumps(time_pick(spec, pick)), flush=True)
    votes = torch.empty((vote[0].shape[0], 180, vote[3]), dtype=torch.int32,
                        device=dev)
    print(json.dumps({"torch_zero_ms": [ms(votes.zero_) for _ in range(2)],
                      "bytes": votes.numel() * 4}), flush=True)
    print(smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
