#!/usr/bin/env python3
"""The benchmark of ``metdetpy_tpu_torch`` on an NVIDIA GPU: one run of one
cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload m3_1080p_quiet --seed 7 \
        --seconds 30 --trace 0

Run it from the root of a checkout. It makes the cell's inputs from the
seed, warms up, calls the cell's entry back to back for ``--seconds``,
judges every call against the plain reference and prints one JSON line
last on standard output (``--trace 1``: one call of the window under the
profiler, and the per-layer metrics). Without enough CUDA devices it
exits with 2 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    sys.path[0] = ROOT
    from benchmark import cell
    return cell.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
