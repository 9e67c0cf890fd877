"""Build a relocatable distribution of MetDetPy-TPU.

Role parity with reference make_package.py:209-244 (freeze the three CLI
tools + copy config/weights/resource/global trees). nuitka/pyinstaller are
not available in this environment, so the default target is a relocatable
directory bundle with launcher scripts plus the compiled native library;
``--sdist`` additionally produces a pip-installable source archive via
setuptools.

``--package metdetpy_tpu_torch`` bundles the PyTorch/CUDA port instead
(default ``dist/metdetpy-tpu-torch``): its package without build output
(the kernels compile from its CUDA sources at first use; into the user's
cache where the bundle is read-only), the data trees, and launchers
``MetDetPy``, ``MetDetPhoto``, ``ClipToolkit``, ``evaluate``, ``train`` and
``bench`` that run ``python3 -m
metdetpy_tpu_torch[.photo|.clip|.evaluate|.train|.bench]`` with the bundle
first on the path.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tarfile

from make_package_zipapp import PORT, PORT_IGNORE, PORT_TOOLS

HERE = os.path.dirname(os.path.abspath(__file__))
CLI_TOOLS = ["MetDetPy.py", "MetDetPhoto.py", "ClipToolkit.py",
             "evaluate.py", "bench.py"]
DATA_TREES = ["config", "global", "weights", "resource"]
LAUNCHER = """#!/bin/sh
# MetDetPy-TPU launcher
DIR="$(cd "$(dirname "$0")" && pwd)"
export METDET_RESOURCE_DIR="$DIR"
exec python3 "$DIR/{tool}" "$@"
"""
PORT_LAUNCHER = """#!/bin/sh
# MetDetPy-TPU launcher (PyTorch/CUDA port)
DIR="$(cd "$(dirname "$0")" && pwd)"
export METDET_RESOURCE_DIR="$DIR"
export PYTHONPATH="$DIR${{PYTHONPATH:+:$PYTHONPATH}}"
exec python3 -m {module} "$@"
"""


def build_native() -> None:
    native = os.path.join(HERE, "metdetpy_tpu", "native")
    ret = subprocess.run(["make", "-C", native], capture_output=True)
    if ret.returncode != 0:
        print("[make_package] native build failed (continuing; numpy "
              "fallbacks remain):", ret.stderr.decode()[-300:])


def _write_launcher(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, 0o755)


def build_dir_bundle(out_dir: str, package: str = "metdetpy_tpu") -> None:
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    if package == PORT:
        shutil.copytree(os.path.join(HERE, PORT), os.path.join(out_dir, PORT),
                        ignore=PORT_IGNORE)
        for name, module in PORT_TOOLS.items():
            _write_launcher(os.path.join(out_dir, name),
                            PORT_LAUNCHER.format(module=module))
    else:
        shutil.copytree(os.path.join(HERE, "metdetpy_tpu"),
                        os.path.join(out_dir, "metdetpy_tpu"),
                        ignore=shutil.ignore_patterns("__pycache__", "*.o"))
        for tool in CLI_TOOLS:
            shutil.copy(os.path.join(HERE, tool), out_dir)
            _write_launcher(os.path.join(out_dir, os.path.splitext(tool)[0]),
                            LAUNCHER.format(tool=tool))
    for tree in DATA_TREES:
        src = os.path.join(HERE, tree)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(out_dir, tree))
    for doc in ["README.md", "SURVEY.md"]:
        if os.path.isfile(os.path.join(HERE, doc)):
            shutil.copy(os.path.join(HERE, doc), out_dir)
    print(f"[make_package] bundle at {out_dir}")


def build_sdist(out_dir: str, version: str,
                stem: str = "metdetpy-tpu") -> None:
    archive = os.path.join(out_dir + ".tar.gz")
    with tarfile.open(archive, "w:gz") as tar:
        tar.add(out_dir, arcname=f"{stem}-{version}")
    print(f"[make_package] archive at {archive}")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", choices=["metdetpy_tpu", PORT],
                        default="metdetpy_tpu")
    parser.add_argument("--out", default=None,
                        help="default: dist/metdetpy-tpu (the port: "
                             "dist/metdetpy-tpu-torch)")
    parser.add_argument("--sdist", action="store_true",
                        help="also produce a .tar.gz archive")
    parser.add_argument("--skip-native", action="store_true",
                        help="the port's bundle never holds a native build")
    args = parser.parse_args()
    if args.package == PORT:
        from metdetpy_tpu_torch.version import VERSION
        out = args.out or os.path.join(HERE, "dist", "metdetpy-tpu-torch")
        build_dir_bundle(out, PORT)
        if args.sdist:
            build_sdist(out, VERSION, "metdetpy-tpu-torch")
        return
    from metdetpy_tpu.version import VERSION
    out = args.out or os.path.join(HERE, "dist", "metdetpy-tpu")
    if not args.skip_native:
        build_native()
    build_dir_bundle(out)
    if args.sdist:
        build_sdist(out, VERSION)


if __name__ == "__main__":
    main()
