"""Kernel records a ``METDETPY_TPU_TRACE_DIR`` trace keeps, for three
forms of the profiler's start, on one GPU.

    python3 tools/torch_trace_warmup_ab.py [--rounds 3] [--no-phases]
        [--bench] [--fresh 0]

Writes a 200-frame 960x540 clip with one meteor and runs
``detect_video`` (m3det_normal as shipped, real-time) on it: once untraced,
then traced with the first profiler session of the process. Then, unless
``--no-phases``, ``chip_smoke.py`` phases 13 and 17 (each profiles once,
after which the first kernel records of a session were seen to go
missing), with ``--bench`` also its bench phase, and ``--rounds`` rounds
of one traced run of each form in turns: ``plain`` (the profiler started
and recording at once), ``warmup`` (a warm-up step with 16 small kernels
before the recorded one) and ``padded`` (``profiling.maybe_torch_trace``:
a warm-up step with ``profiling._PAD_KERNELS`` small kernels, and as many
again at the head of the recorded one). ``--fresh N`` then runs N new
processes for each of ``warmup`` and ``padded``, each one traced run as
its first profiler session (as a frozen build's traced run is). Each
traced run prints one JSON line: its wall seconds, its kernel launches
(``cudaLaunchKernel`` events) without a kernel record, each such
launch's enclosing operator and microseconds after the recorded step's
start, and its kernel records of each kernel against their
launch counts. Prints the card's name and
power limit first, and a summary of each form last.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402
import metdetpy_tpu_torch.api as api  # noqa: E402
from metdetpy_tpu_torch import profiling  # noqa: E402
from metdetpy_tpu_torch.ops import kernels as K  # noqa: E402


@contextlib.contextmanager
def plain_trace(device):
    """The trace without the warm-up step: started and recording at once."""
    trace_dir = os.environ["METDETPY_TPU_TRACE_DIR"]
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(profiling._new_trace_path(trace_dir))


@contextlib.contextmanager
def warmup_trace(device):
    """The warm-up step alone (16 kernels), with nothing at the head of
    the recorded step."""
    trace_dir = os.environ["METDETPY_TPU_TRACE_DIR"]
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
    prof.start()
    x = torch.zeros(1, device=device)
    for _ in range(16):
        x.add_(1)
    torch.cuda.synchronize(device)
    prof.step()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(profiling._new_trace_path(trace_dir))


VARIANTS = {"plain": plain_trace, "warmup": warmup_trace,
            "padded": profiling.maybe_torch_trace}


def records(trace_dir: str) -> dict:
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = {e["args"].get("correlation") for e in kernels}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e["name"] == "cudaLaunchKernel"]
    steps = [e["ts"] for e in events
             if str(e.get("name", "")).startswith("ProfilerStep#")]
    t0 = min(steps) if steps else min(e["ts"] for e in launches)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    lost = []
    for e in launches:
        if e["args"].get("correlation") in seen:
            continue
        around = [o for o in ops
                  if o["ts"] <= e["ts"] <= o["ts"] + o.get("dur", 0)]
        op = min(around, key=lambda o: o.get("dur", 0))["name"] if (
            around) else None
        lost.append([op, round(e["ts"] - t0, 1)])
    return {
        "launches": len(launches),
        "lost": len(lost),
        "lost_at": lost,
        "records": {k: sum(f"{k}_kernel" in e["name"] for e in kernels)
                    for k in K.SOURCES}}


def run(video, cfg, tag: str, variant=None) -> dict:
    trace_dir = os.path.join(S.FILES, "trace")
    env = {"METDETPY_TPU_TRACE_DIR": trace_dir} if variant else {}
    api.maybe_torch_trace = VARIANTS[variant] if variant else (
        profiling.maybe_torch_trace)
    try:
        with S.env_set(env):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            api.detect_video(video, None, cfg, work_mode="backend",
                             device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        api.maybe_torch_trace = profiling.maybe_torch_trace
    out = {"run": tag, "variant": variant, "wall_s": wall,
           "kernel_launches": dict(K.LAUNCHES)}
    if variant:
        out.update(records(trace_dir))
        shutil.rmtree(trace_dir)
    print(json.dumps(out), flush=True)
    return out


def clip(cfg_only: bool = False):
    """The clip's path and the m3det_normal config (real-time)."""
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.synth import (SynthMeteor, generate_meteor_video,
                                          write_video)
    from metdetpy_tpu_torch.utils import relative2abs_path
    video = os.path.join(S.FILES, "clip.avi")
    if not cfg_only:
        os.makedirs(S.FILES, exist_ok=True)
        frames = generate_meteor_video(
            width=S.W, height=S.H, fps=S.FPS, duration_sec=8.0,
            meteors=[SynthMeteor(start_sec=3.0, end_sec=4.5, pt1=(430, 130),
                                 pt2=(290, 300))],
            n_stars=150, noise_sigma=4.0, seed=S.SEED)
        write_video(frames, video, fps=S.FPS)
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.exp_time = "real-time"
    return video, cfg


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--no-phases", action="store_true")
    parser.add_argument("--bench", action="store_true")
    parser.add_argument("--fresh", type=int, default=0)
    parser.add_argument("--child", choices=sorted(VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        S.fail("this measurement needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.build_kernels()
    if args.child:
        video, cfg = clip(cfg_only=True)
        run(video, cfg, "first traced run of a new process", args.child)
        return
    card = S.card_line()
    print(card, flush=True)
    video, cfg = clip()
    outs = [run(video, cfg, "untraced"),
            run(video, cfg, "first traced run of the process", "padded")]
    if not args.no_phases:
        S.phase_multistream(card)
        S.phase_train(card)
        if args.bench:
            S.phase_bench(card)
    order = list(VARIANTS)
    for i in range(args.rounds):
        for variant in order[i % 3:] + order[:i % 3]:
            outs.append(run(video, cfg, f"round {i}", variant))
    for i in range(args.fresh):
        for variant in ("warmup", "padded"):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 variant], capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                S.fail(f"fresh {variant} run exited {res.returncode}: "
                       f"{res.stderr[-3000:]}")
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            outs.append(json.loads(line))
    summary = {}
    for o in outs:
        if o["variant"]:
            v = summary.setdefault(o["variant"], {
                "runs": 0, "runs_losing_a_launch": 0,
                "runs_losing_a_port_kernel": 0})
            v["runs"] += 1
            v["runs_losing_a_launch"] += o["lost"] > 0
            v["runs_losing_a_port_kernel"] += (
                o["records"] != o["kernel_launches"])
    print(json.dumps({"summary": summary}), flush=True)
    shutil.rmtree(S.FILES)
    print(card, flush=True)


if __name__ == "__main__":
    main()
