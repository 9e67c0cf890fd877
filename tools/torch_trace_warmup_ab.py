"""Kernel records a ``METDETPY_TPU_TRACE_DIR`` trace keeps, with and
without the profiler's warm-up step, on one GPU.

    python3 tools/torch_trace_warmup_ab.py [--rounds 3] [--no-phases]

Writes the 200-frame 960x540 clip of ``chip_smoke.py`` phase 18 and runs
``detect_video`` (m3det_normal as shipped, real-time) on it: once untraced,
then traced with the first profiler session of the process. Then, unless
``--no-phases``, ``chip_smoke.py`` phases 13 and 17 (each profiles once,
after which the first kernel records of a session were seen to go
missing), and ``--rounds`` rounds of two traced runs in turns: ``plain``
(the profiler started and recording at once) and ``warmup``
(``profiling.maybe_torch_trace``: a warm-up step with a few kernels before
the recorded one). Each traced run prints one JSON line: its wall
seconds, its kernel launches (``cudaLaunchKernel`` events) without a
kernel record, and its kernel records of each of the four kernels against
their launch counts. Prints the card's name and power limit first.
"""

import argparse
import contextlib
import json
import os
import shutil
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


VARIANTS = {"plain": plain_trace, "warmup": profiling.maybe_torch_trace}


def records(trace_dir: str) -> dict:
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = {e["args"].get("correlation") for e in kernels}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e["name"] == "cudaLaunchKernel"]
    return {
        "launches": len(launches),
        "lost": sum(e["args"].get("correlation") not in seen
                    for e in launches),
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--no-phases", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        S.fail("this measurement needs a GPU")
    from metdetpy_tpu_torch.structs import MainDetectCfg
    from metdetpy_tpu_torch.synth import (SynthMeteor, generate_meteor_video,
                                          write_video)
    from metdetpy_tpu_torch.utils import relative2abs_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = S.card_line()
    print(card, flush=True)
    K.build_kernels()
    os.makedirs(S.FILES, exist_ok=True)
    frames = generate_meteor_video(
        width=S.W, height=S.H, fps=S.FPS, duration_sec=8.0,
        meteors=[SynthMeteor(start_sec=3.0, end_sec=4.5, pt1=(430, 130),
                             pt2=(290, 300))],
        n_stars=150, noise_sigma=4.0, seed=S.SEED)
    video = os.path.join(S.FILES, "clip.avi")
    write_video(frames, video, fps=S.FPS)
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.exp_time = "real-time"
    run(video, cfg, "untraced")
    run(video, cfg, "first traced run of the process", "warmup")
    if not args.no_phases:
        S.phase_multistream(card)
        S.phase_train(card)
    for i in range(args.rounds):
        for variant in (("plain", "warmup") if i % 2 == 0
                        else ("warmup", "plain")):
            run(video, cfg, f"round {i}", variant)
    shutil.rmtree(S.FILES)
    print(card, flush=True)


if __name__ == "__main__":
    main()
