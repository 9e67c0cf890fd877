#!/usr/bin/env python3
"""The readings that a cell's limits are set from, over many seeds in one
process: for each seed, the comparison's numbers (``judge.numbers``) of the
program's calls against the plain reference (``program``, the lower
readings: a warm-up call and one call as the window makes them) and of the
control against the reference (``control``, the upper readings: the
reference in the lower precision that the cell's workload file names),
with the records and per-frame outputs of each side. One JSON line a seed
on standard output.

    python3 benchmark/control.py --workload m3_1080p_quiet --seeds 1,2,3

The benchmark's own runs never run the control. ``--device cpu`` runs it
on the CPU (with ``--traffic`` overrides, as the tests do).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seed: int, device: str, traffic=None,
             program: bool = True, model_hw=None, control=None) -> dict:
    from benchmark import cell, judge
    run = cell.Run(workload, seed, 0, False, device, time.time(),
                   traffic=traffic, model_hw=model_hw)
    t0 = time.perf_counter()
    run._make_inputs()
    out = {"seed": seed, "make_s": time.perf_counter() - t0}
    calls = []
    if program:
        calls = [run._call(), run._call()]
        out["call_s"] = [c.seconds for c in calls]
        out["errors"] = [c.error for c in calls if c.error]
    t0 = time.perf_counter()
    run.reference()
    out["reference_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctl, _, ctl_rows = run.entry.reference(
        control=control or run.spec["control"])
    out["control_s"] = time.perf_counter() - t0
    ctl_t = judge.targets(ctl, run.entry.px_scale)
    ctl_f = judge.frame_outputs(ctl_rows)
    ctl_call = cell.Call(0.0, 0.0, records=ctl, outputs=ctl_rows)
    names = (["output_gap", "box_gap", "box_missing"]
             if run.entry.score_threshold else ["output_gap"])
    if calls:
        per = [run.gaps(c, names) for c in calls]
        out["program"] = {k: max(g[k] for g in per) for k in names}
    out["control"] = run.gaps(ctl_call, names)
    out["cell_numbers"] = list(run.spec["limits"])
    out["targets"] = len(run.ref_targets)
    out["frames_with_lines"] = len(run.ref_frames)
    out["vote_points"] = run.ref_stats.get("vote_points")
    out["records"] = {"reference": run.ref_targets, "control": ctl_t}
    if calls and not calls[-1].error:
        out["records"]["program"] = judge.targets(calls[-1].records,
                                                  run.entry.px_scale)

    def rows(frames):
        return [[f, [float(v) for v in line], [float(v) for v in probs]]
                for f, items in sorted(frames.items())
                for line, probs in items]
    out["frames"] = {"reference": rows(run.ref_frames),
                     "control": rows(ctl_f)}
    if calls and not calls[-1].error:
        out["frames"]["program"] = rows(
            judge.frame_outputs(calls[-1].outputs))
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--traffic", default="{}",
                   help="JSON object of traffic parameters to override")
    p.add_argument("--no-program", action="store_true")
    p.add_argument("--control", default=None,
                   help="another control than the workload file's")
    args = p.parse_args(argv)
    sys.path[0] = ROOT
    real = sys.stdout
    for s in args.seeds.split(","):
        sys.stdout = sys.stderr
        try:
            r = readings(args.workload, int(s), args.device,
                         json.loads(args.traffic), not args.no_program,
                         control=args.control)
        finally:
            sys.stdout = real
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
