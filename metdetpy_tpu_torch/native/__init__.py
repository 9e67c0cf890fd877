"""ctypes bindings for the native host runtime (libmetring.so).

Builds on demand with the bundled Makefile (beside it, or into the user's
cache where the package is read-only); every entry point has a
numpy/cv2 fallback so the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..utils import build_root

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(build_root(_HERE), "libmetring.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        ret = subprocess.run(["make", "-C", _HERE, f"TARGET={_LIB_PATH}"],
                             capture_output=True, timeout=120)
        return ret.returncode == 0
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.isfile(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.metring_resize_bgr2gray_assemble_u8  # reject stale builds
    except (OSError, AttributeError):
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
    lib.metring_u8_max_inplace.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                           ctypes.c_size_t]
    lib.metring_bgr2gray.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_char_p]
    lib.metring_resize_linear_u8.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.metring_resize_assemble_u8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p]
    lib.metring_resize_bgr2gray_assemble_u8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
    _lib = lib
    return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_char_p)


def u8_max_inplace(dst: np.ndarray, src: np.ndarray) -> None:
    """dst = max(dst, src) for contiguous uint8 arrays."""
    lib = get_lib()
    if lib is not None and dst.flags.c_contiguous and src.flags.c_contiguous:
        lib.metring_u8_max_inplace(_ptr(dst), _ptr(src), dst.size)
    else:
        np.maximum(dst, src, out=dst)


def bgr2gray(bgr: np.ndarray) -> np.ndarray:
    """cv2-compatible BT.601 BGR->gray for contiguous uint8 HxWx3."""
    lib = get_lib()
    if lib is not None and bgr.flags.c_contiguous:
        out = np.empty(bgr.shape[:2], dtype=np.uint8)
        lib.metring_bgr2gray(_ptr(bgr), bgr.shape[0] * bgr.shape[1],
                             _ptr(out))
        return out
    import cv2
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)


def resize_linear_u8(src: np.ndarray, dsize: tuple[int, int],
                     dst: Optional[np.ndarray] = None) -> np.ndarray:
    """u8 grayscale bilinear resize, bit-exact with cv2.resize
    INTER_LINEAR (fixed-point 11-bit path). dsize is (w, h) like cv2.
    Falls back to cv2 when the native library is unavailable."""
    w, h = dsize
    lib = get_lib()
    if dst is None:
        dst = np.empty((h, w), np.uint8)
    # bit-exactness with cv2 is verified for DOWNSCALE (the only case the
    # pipeline hits: runtime size <= raw size); cv2's upscale path rounds
    # differently, so defer to it there
    if (lib is not None and src.flags.c_contiguous
            and dst.flags.c_contiguous and src.ndim == 2
            and h <= src.shape[0] and w <= src.shape[1]):
        lib.metring_resize_linear_u8(_ptr(src), src.shape[0], src.shape[1],
                                     _ptr(dst), h, w)
        return dst
    import cv2
    cv2.resize(src, dsize, dst=dst, interpolation=cv2.INTER_LINEAR)
    return dst


def resize_assemble_u8(frames: list, block: np.ndarray, n_start: int,
                       exp_frame: int = 1,
                       scratch: Optional[np.ndarray] = None) -> int:
    """Resize + exposure-max-merge a chunk of gray frames into consecutive
    block slots in ONE native call (one GIL release for the whole chunk:
    under active TPU-client streaming, per-frame Python work measured
    10-40x slower than the same work batched in C).

    frames: list of [sh, sw] u8 contiguous arrays, length a multiple of
    exp_frame. block: [*, dh, dw] u8; writes len(frames)//exp_frame slots
    starting at n_start. Returns slots written; falls back to per-frame
    cv2 when the native library is missing.
    """
    n = len(frames)
    dh, dw = block.shape[1], block.shape[2]
    n_out = n // exp_frame
    lib = get_lib()
    if (lib is not None and all(f.flags.c_contiguous for f in frames)
            and dh <= frames[0].shape[0] and dw <= frames[0].shape[1]):
        ptrs = (ctypes.c_void_p * n)(*[f.ctypes.data for f in frames])
        if scratch is None and exp_frame > 1:
            scratch = np.empty((dh, dw), np.uint8)
        sp = _ptr(scratch) if scratch is not None else None
        dst_view = block[n_start:]
        lib.metring_resize_assemble_u8(
            ptrs, n, frames[0].shape[0], frames[0].shape[1],
            _ptr(dst_view), dh, dw, exp_frame, sp)
        return n_out
    import cv2
    for g in range(n_out):
        slot = block[n_start + g]
        for k in range(exp_frame):
            f = frames[g * exp_frame + k]
            if k == 0:
                cv2.resize(f, (dw, dh), dst=slot,
                           interpolation=cv2.INTER_LINEAR)
            else:
                tmp = cv2.resize(f, (dw, dh),
                                 interpolation=cv2.INTER_LINEAR)
                np.maximum(slot, tmp, out=slot)
    return n_out


def resize_bgr2gray_assemble_u8(frames: list, block: np.ndarray,
                                n_start: int, exp_frame: int = 1,
                                color_scratch: Optional[np.ndarray] = None,
                                gray_scratch: Optional[np.ndarray] = None
                                ) -> int:
    """Color-source variant of :func:`resize_assemble_u8`: resize BGR
    frames, convert to gray (cv2-bit-exact BT.601 fixed point, same
    resize-then-gray order as HostPreprocess), and exposure-max-merge
    into consecutive GRAY block slots in one GIL-free call per chunk.

    frames: list of [sh, sw, 3] u8 contiguous arrays. block: [*, dh, dw]
    u8. Falls back to per-frame cv2 without the native library.
    """
    n = len(frames)
    dh, dw = block.shape[1], block.shape[2]
    n_out = n // exp_frame
    lib = get_lib()
    if (lib is not None and all(f.flags.c_contiguous for f in frames)
            and dh <= frames[0].shape[0] and dw <= frames[0].shape[1]):
        ptrs = (ctypes.c_void_p * n)(*[f.ctypes.data for f in frames])
        if color_scratch is None and (dh, dw) != frames[0].shape[:2]:
            color_scratch = np.empty((dh, dw, 3), np.uint8)
        if gray_scratch is None and exp_frame > 1:
            gray_scratch = np.empty((dh, dw), np.uint8)
        cp = _ptr(color_scratch) if color_scratch is not None else None
        gp = _ptr(gray_scratch) if gray_scratch is not None else None
        lib.metring_resize_bgr2gray_assemble_u8(
            ptrs, n, frames[0].shape[0], frames[0].shape[1],
            _ptr(block[n_start:]), dh, dw, exp_frame, cp, gp)
        return n_out
    import cv2
    for g in range(n_out):
        slot = block[n_start + g]
        for k in range(exp_frame):
            f = frames[g * exp_frame + k]
            if (dh, dw) != f.shape[:2]:
                f = cv2.resize(f, (dw, dh), interpolation=cv2.INTER_LINEAR)
            gray = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
            if k == 0:
                np.copyto(slot, gray)
            else:
                np.maximum(slot, gray, out=slot)
    return n_out
