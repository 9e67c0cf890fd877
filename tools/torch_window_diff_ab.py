"""Time the package's window_diff kernel against another build of it, in
turns, at the single-stream main-path shape.

    git show REV:metdetpy_tpu_torch/csrc/window_diff.cu > DIR/window_diff.cu
    cp metdetpy_tpu_torch/csrc/cp_async.cuh DIR/
    python3 tools/torch_window_diff_ab.py DIR/window_diff.cu

The other source must have the single-stream C entry point the kernel had
before its stream axis, ``mdt_window_diff(hist, frames, diff, new_hist,
hw, n, t_block, timer0, stream)``. Both are built with the package's nvcc flags, held exactly
against each other on ``chip_smoke.py``'s inputs (a 960x540 synthetic sky,
64 frames, n = 25, history n-1 frames) and timed with its harness (CUDA
events behind a device sleep; warm repeats one input, cold rotates through
copies of more than twice the L2) in the order other, package, package,
other. Prints each build's ``ptxas`` register line, then one JSON object
per reading and the card's name and power limit. Needs a GPU.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("source", help="the other window_diff.cu")
    args = parser.parse_args()
    import chip_smoke as S
    from metdetpy_tpu_torch.ops import kernels as K
    if not torch.cuda.is_available():
        sys.exit("torch_window_diff_ab: needs a GPU")
    dev = torch.device("cuda")
    K.build_kernels()
    lib = os.path.splitext(os.path.abspath(args.source))[0] + "_ab.so"
    built = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", lib,
                            args.source], capture_output=True, text=True)
    if built.returncode:
        sys.exit(f"nvcc failed:\n{built.stdout}{built.stderr}")
    log = os.path.splitext(K._lib_path(K.SOURCES["window_diff"][0]))[0]
    with open(log + ".log") as f:
        mine = [ln.strip() for ln in f if "Used" in ln]
    print(json.dumps({"ptxas_other": [ln.strip() for ln in (
        built.stdout + built.stderr).splitlines() if "Used" in ln],
        "ptxas_package": mine}), flush=True)
    other = ctypes.CDLL(lib).mdt_window_diff
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    other.argtypes = [p, p, p, p, ll, i, i, i, p]
    other.restype = ctypes.c_int
    (hist, frames), *_ = S.kernel_inputs(dev)
    n, timer0 = S.N_WIN, 10

    def run_other(hist, frames):
        diff = torch.empty_like(frames)
        t, h, w = frames.shape
        err = other(hist.data_ptr(), frames.data_ptr(), diff.data_ptr(), 0,
                    h * w, n, t, min(timer0, n),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"the other build failed to launch: cudaError {err}")
        return diff

    def run_package(hist, frames):
        return K.window_diff(hist, frames, n, timer0)[0]

    if not torch.equal(run_other(hist, frames), run_package(hist, frames)):
        sys.exit("the two builds differ")
    for name, fn in (("other", run_other), ("package", run_package),
                     ("package", run_package), ("other", run_other)):
        print(json.dumps({"build": name,
                          "warm_ms": S.cuda_ms(lambda: fn(hist, frames), 50),
                          "cold_ms": S.cold_ms(fn, (hist, frames))}),
              flush=True)
    print(S.card_line(), flush=True)


if __name__ == "__main__":
    main()
