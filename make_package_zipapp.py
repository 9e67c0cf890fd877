"""Freeze the CLI tools into single-file executables (zipapp).

Role parity with reference make_package_pyinstaller.py:1 (one-file
executables for MetDetPy / MetDetPhoto / ClipToolkit). PyInstaller/nuitka
are not available in this image, so the freeze target is PEP 441 zipapps:
each tool becomes a self-contained .pyz holding the package, the tool
script, and the config/global/resource data trees; on first run the data
trees are extracted to a per-build cache directory and
METDET_RESOURCE_DIR is pointed there (the one-file-extraction model
PyInstaller uses).

Usage: python make_package_zipapp.py [--out dist_pyz] [--tools ...]

``--package metdetpy_tpu_torch`` freezes the PyTorch/CUDA port's entry
points instead (``MetDetPy``, ``MetDetPhoto``, ``ClipToolkit``,
``evaluate``, ``train``, ``bench``: ``python -m metdetpy_tpu_torch`` and
its ``.photo``, ``.clip``, ``.evaluate``, ``.train``, ``.bench``) into
``dist_pyz/metdetpy_tpu_torch/``. Their archives hold the port's package
(its CUDA sources, no build output) and the data trees, nothing of
``metdetpy_tpu``; on first run the launcher extracts both into
``~/.cache/metdetpy_tpu_torch/bundle-<digest>`` and imports the package
from there, so the kernels compile at first use into that directory.
"""

import argparse
import hashlib
import os
import shutil
import sys
import zipapp

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_TOOLS = ["MetDetPy.py", "MetDetPhoto.py", "ClipToolkit.py",
                 "evaluate.py"]
DATA_TREES = ["config", "global", "resource", "weights"]
PORT = "metdetpy_tpu_torch"
# the port's tools: launcher name -> module run as __main__
PORT_TOOLS = {"MetDetPy": PORT, "MetDetPhoto": f"{PORT}.photo",
              "ClipToolkit": f"{PORT}.clip", "evaluate": f"{PORT}.evaluate",
              "train": f"{PORT}.train", "bench": f"{PORT}.bench"}
# build outputs (the kernels' csrc/build/, native/libmetring.so) stay out:
# a frozen port compiles them from its own sources at first use
PORT_IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", "*.o", "*.so",
                                     "build")

MAIN_TEMPLATE = '''\
"""zipapp entry: extract bundled data trees once, then run {tool}."""
import hashlib
import os
import runpy
import sys
import zipfile

ARCHIVE = os.path.dirname(os.path.abspath(__file__))  # the .pyz itself


def _extract_data() -> str:
    with open(ARCHIVE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(os.path.expanduser("~"), ".cache",
                         "metdetpy_tpu", "bundle-" + digest)
    stamp = os.path.join(cache, ".complete")
    if not os.path.exists(stamp):
        os.makedirs(cache, exist_ok=True)
        with zipfile.ZipFile(ARCHIVE) as z:
            for name in z.namelist():
                if name.split("/", 1)[0] in {data_trees!r}:
                    z.extract(name, cache)
        open(stamp, "w").close()
    return cache


def main():
    os.environ.setdefault("METDET_RESOURCE_DIR", _extract_data())
    sys.argv[0] = {tool!r}
    runpy.run_module({module!r}, run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
'''


PORT_MAIN_TEMPLATE = '''\
"""zipapp entry: extract the bundled package and data trees once, then
run python -m {module}."""
import hashlib
import os
import runpy
import shutil
import sys
import tempfile
import zipfile

ARCHIVE = os.path.dirname(os.path.abspath(__file__))  # the .pyz itself


def _extract() -> str:
    """The archive's package and data trees as files in the user's cache,
    keyed by the archive's digest; the kernels compile into it."""
    with open(ARCHIVE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    root = os.path.join(os.path.expanduser("~"), ".cache", {package!r})
    cache = os.path.join(root, "bundle-" + digest)
    if not os.path.isdir(cache):
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".extract-", dir=root)
        with zipfile.ZipFile(ARCHIVE) as z:
            for name in z.namelist():
                if name.split("/", 1)[0] in {trees!r}:
                    z.extract(name, tmp)
        try:
            os.rename(tmp, cache)
        except OSError:  # another process extracted it first
            shutil.rmtree(tmp)
    return cache


def main():
    cache = _extract()
    os.environ.setdefault("METDET_RESOURCE_DIR", cache)
    sys.path.insert(0, cache)
    sys.argv[0] = {tool!r}
    runpy.run_module({module!r}, run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
'''


def _archive(staging: str, out_dir: str, name: str) -> str:
    target = os.path.join(out_dir, name + ".pyz")
    zipapp.create_archive(staging, target,
                          interpreter="/usr/bin/env python3")
    shutil.rmtree(staging)
    os.chmod(target, 0o755)
    print(f"[make_package_zipapp] {target} "
          f"({os.path.getsize(target) // 1024} KiB)")
    return target


def _copy_data_trees(staging: str) -> None:
    for tree in DATA_TREES:
        src = os.path.join(HERE, tree)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(staging, tree))


def build_port_tool(name: str, out_dir: str) -> str:
    """``<out_dir>/<name>.pyz`` running the port's module of ``name``."""
    staging = os.path.join(out_dir, "_staging_" + name)
    if os.path.exists(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    shutil.copytree(os.path.join(HERE, PORT), os.path.join(staging, PORT),
                    ignore=PORT_IGNORE)
    _copy_data_trees(staging)
    with open(os.path.join(staging, "__main__.py"), "w") as f:
        f.write(PORT_MAIN_TEMPLATE.format(
            tool=name, module=PORT_TOOLS[name], package=PORT,
            trees=sorted({PORT, *DATA_TREES})))
    return _archive(staging, out_dir, name)


def build_tool(tool: str, out_dir: str) -> str:
    staging = os.path.join(out_dir, "_staging_" + tool)
    if os.path.exists(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    shutil.copytree(os.path.join(HERE, "metdetpy_tpu"),
                    os.path.join(staging, "metdetpy_tpu"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.o"))
    shutil.copy(os.path.join(HERE, tool), staging)
    _copy_data_trees(staging)
    module = os.path.splitext(tool)[0]
    with open(os.path.join(staging, "__main__.py"), "w") as f:
        f.write(MAIN_TEMPLATE.format(tool=tool, module=module,
                                     data_trees=set(DATA_TREES)))
    return _archive(staging, out_dir, module)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--package", choices=["metdetpy_tpu", PORT],
                        default="metdetpy_tpu")
    parser.add_argument("--out", default=None,
                        help="default: dist_pyz (the port: "
                             "dist_pyz/metdetpy_tpu_torch)")
    parser.add_argument("--tools", nargs="*", default=None,
                        help=f"default: {' '.join(DEFAULT_TOOLS)} (the "
                             f"port: {' '.join(PORT_TOOLS)})")
    args = parser.parse_args()
    port = args.package == PORT
    out = args.out or os.path.join(HERE, "dist_pyz", *[PORT] * port)
    tools = args.tools if args.tools is not None else list(
        PORT_TOOLS if port else DEFAULT_TOOLS)
    if port and not set(tools) <= set(PORT_TOOLS):
        parser.error(f"the port's tools are {', '.join(PORT_TOOLS)}")
    os.makedirs(out, exist_ok=True)
    for tool in tools:
        (build_port_tool if port else build_tool)(tool, out)


if __name__ == "__main__":
    main()
