"""Run phases of two checkouts' ``chip_smoke.py`` in turns on one card.

    python3 tools/torch_smoke_phase_ab.py OTHER_ROOT
        [--phases multistream,classic] [--order abba]

Each run is a fresh process whose working directory and ``PYTHONPATH`` are
one checkout's root (``a`` is OTHER_ROOT, e.g. an earlier revision unpacked
with ``git archive`` into a git-ignored directory; ``b`` is this
checkout), which imports that checkout's ``chip_smoke`` and calls
``phase_<name>(card_line())`` for each phase given, in order. The kernels
build in each checkout's own ``csrc/build``. Every line a run prints is
printed with its side and turn; a run that fails ends the script with its
exit code. Compare two versions only within one call: the card's clocks
and power limit differ from machine to machine.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout (side a)")
    ap.add_argument("--phases", default="multistream,classic",
                    help="comma-separated chip_smoke phase names, without "
                         "the phase_ prefix")
    ap.add_argument("--order", default="abba",
                    help="the turns, a string of a and b")
    args = ap.parse_args()
    roots = {"a": os.path.abspath(args.other), "b": HERE}
    calls = "; ".join(f"c.phase_{p}(card)" for p in args.phases.split(","))
    code = ("import chip_smoke as c; card = c.card_line(); print(card, "
            f"flush=True); {calls}")
    for turn, side in enumerate(args.order):
        root = roots[side]
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"[{turn} {side}] {line}", flush=True)
        print(f"[{turn} {side}] {root}: exit {proc.returncode} in "
              f"{wall:.1f} s", flush=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-8000:])
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
