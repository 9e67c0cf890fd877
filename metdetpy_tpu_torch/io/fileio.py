"""File IO: image read/write, mask loading, path helpers.

Behavior parity with reference MetLib/fileio.py. Host-side by design (tiny
inputs); RAW decoding (rawpy) and ICC embedding (pyexiv2) are optional and
gated on library availability (neither ships in this environment).
"""

from __future__ import annotations

import os
from os.path import join as path_join
from os.path import split as path_split
from typing import Optional, Union

import cv2
import numpy as np

from ..log import BaseMetLog, get_useable_logger
from ..structs import RawImgLoadCfg
from ..utils import get_resource_dir, transpose_wh

SUPPORT_COMMON_FORMAT = ["jpg", "png", "jpeg", "tiff", "tif", "bmp"]
SUPPORT_RAW_FORMAT = ["cr2", "cr3", "nef", "arw", "rw2", "raf", "dng"]
SUPPORT_ALL_IMG_FORMAT = SUPPORT_COMMON_FORMAT + SUPPORT_RAW_FORMAT

UINT16_MAX = 65535


def _color_profile_path(color_space: str) -> str:
    return os.path.join(get_resource_dir(), "resource", f"{color_space}.icc")


def is_ext_with(path: str, ext: str) -> bool:
    return path.lower().endswith(ext.lower())


def is_ext_within(path: str, ext_list: list[str]) -> bool:
    return path.split(".")[-1].lower() in [e.lower() for e in ext_list]


def replace_path_ext(src_path: str, ext: str) -> str:
    return os.path.splitext(src_path)[0] + "." + ext


def change_file_path(src_path: str, tgt_path: str) -> str:
    return path_join(tgt_path, path_split(src_path)[-1])


def save_path_handler(save_path: str, filename: str, ext: str = "json") -> str:
    """Resolve a save path: directory -> join renamed file; file path under
    an existing parent -> use directly (reference MetLib/fileio.py:59-82)."""
    if filename.endswith("/") or filename.endswith("\\"):
        filename = filename[:-1]
    if os.path.isdir(save_path):
        return change_file_path(replace_path_ext(filename, ext), save_path)
    root_path, _ = path_split(save_path)
    if os.path.isdir(root_path) or root_path == "":
        return save_path
    raise ValueError(f"Invalid saving path: {save_path}.")


def save_img(img: np.ndarray, filename: str, quality: int, compressing: int,
             color_space: Optional[str] = None,
             logger: Optional[BaseMetLog] = None) -> None:
    """Encode and save an image; embeds an ICC profile when pyexiv2 is
    available, otherwise degrades to a plain write
    (reference MetLib/fileio.py:85-131)."""
    logger = get_useable_logger(logger)
    if is_ext_with(filename, "png"):
        ext, params = ".png", [int(cv2.IMWRITE_PNG_COMPRESSION), compressing]
    elif is_ext_with(filename, "jpg") or is_ext_with(filename, "jpeg"):
        ext, params = ".jpg", [int(cv2.IMWRITE_JPEG_QUALITY), quality]
    else:
        raise NameError(f"Unsupported suffix \"{filename.split('.')[-1]}\"; "
                        "only .png and .jpeg/.jpg are supported.")
    status, buf = cv2.imencode(ext, img, params)
    if not status:
        raise Exception("imencode failed.")
    if color_space:
        try:
            import pyexiv2  # type: ignore
            profile_path = _color_profile_path(color_space)
            if os.path.isfile(profile_path):
                with open(profile_path, "rb") as f:
                    profile = f.read()
                with pyexiv2.ImageData(buf.tobytes()) as image_data:
                    image_data.modify_icc(profile)
                    with open(filename, "wb") as f:
                        f.write(image_data.get_bytes())
                    return
            logger.warning(f"No {color_space} ICC profile found; "
                           "saving without color space.")
        except (ImportError, OSError):
            logger.warning("pyexiv2 unavailable; saving without ICC profile.")
        except Exception as e:
            logger.error(f"Fatal error: {e!r}.")
    with open(filename, "wb") as f:
        f.write(buf.tobytes())


def load_8bit_image(filename: str) -> np.ndarray:
    img = cv2.imdecode(np.fromfile(filename, dtype=np.uint8),
                       cv2.IMREAD_UNCHANGED)
    if img is None:
        raise Exception(f"Failed to load image: {filename}.")
    return img


# ---------------------------------------------------------------------------
# RAW pipeline (gated on rawpy): linear 16-bit -> gamma normalize -> stretch
# (reference MetLib/fileio.py:142-202, math from MetLib/imgproc.py:17-67)
# ---------------------------------------------------------------------------


def scale2tgt_mean(img_lin: np.ndarray, power: float = 2.222,
                   target_nl_mean: float = 0.3) -> np.ndarray:
    """Scale a linear image so the gamma-mapped gray mean hits the target."""
    l_gray_mean = np.mean(cv2.cvtColor(img_lin, cv2.COLOR_BGR2GRAY))
    k = (target_nl_mean ** power) / l_gray_mean
    return ((k * img_lin) ** (1 / power) * UINT16_MAX).clip(
        0, UINT16_MAX).astype(np.uint16)


def contrast_stretch_uint16(img_uint16: np.ndarray,
                            alpha: float = 1.2) -> np.ndarray:
    lab = cv2.cvtColor((img_uint16 / UINT16_MAX).astype(np.float32),
                       cv2.COLOR_BGR2LAB)
    L, a, b = cv2.split(lab)
    l_mean = L.mean()
    L = np.clip((L - l_mean) * alpha + l_mean, 0.0, 100.0)
    rgb = cv2.cvtColor(cv2.merge([L, a, b]), cv2.COLOR_LAB2BGR)
    return (rgb * UINT16_MAX).astype(np.uint16)


def contrast_stretch_uint8(img_uint8: np.ndarray,
                           alpha: float = 1.2) -> np.ndarray:
    lab = cv2.cvtColor(img_uint8, cv2.COLOR_BGR2LAB)
    L, a, b = cv2.split(lab)
    l_mean = L.mean()
    L = np.clip((L - l_mean) * alpha + l_mean, 0, 255).astype(np.uint8)
    return cv2.cvtColor(cv2.merge([L, a, b]), cv2.COLOR_LAB2BGR)


def load_raw_image(filename: str, auto_gamma: bool = False,
                   auto_wb: bool = False) -> np.ndarray:
    try:
        import rawpy  # type: ignore
    except ImportError as e:
        raise ImportError(
            "rawpy is not available in this environment; RAW formats "
            f"({SUPPORT_RAW_FORMAT}) cannot be decoded.") from e
    if not os.path.isfile(filename):
        raise Exception(f"Raw file not found: {filename}.")
    with rawpy.imread(filename) as raw:
        if auto_gamma:
            img = raw.postprocess(output_bps=16, use_camera_wb=not auto_wb,
                                  use_auto_wb=auto_wb, no_auto_bright=True,
                                  output_color=rawpy.rawpy.ColorSpace(4))
        else:
            img = raw.postprocess(output_bps=16, gamma=(1.0, 0.0),
                                  use_camera_wb=not auto_wb,
                                  use_auto_wb=auto_wb, no_auto_bright=True)
    return cv2.cvtColor(img, cv2.COLOR_RGB2BGR)


def load_raw_with_preprocess(filename: str, power: float = 2.222,
                             target_nl_mean: float = 0.3,
                             contrast_alpha: float = 1.2,
                             output_bps: int = 16) -> np.ndarray:
    img = scale2tgt_mean(load_raw_image(filename, auto_gamma=False,
                                        auto_wb=True),
                         power=power, target_nl_mean=target_nl_mean)
    if output_bps == 8:
        return contrast_stretch_uint8((img // 257).astype(np.uint8),
                                      alpha=contrast_alpha)
    return contrast_stretch_uint16(img, alpha=contrast_alpha)


def load_image_file(filename: str, cfg: Optional[RawImgLoadCfg] = None,
                    logger: Optional[BaseMetLog] = None):
    """Unified image loader for common + RAW formats
    (reference MetLib/fileio.py:205-247)."""
    logger = get_useable_logger(logger)
    try:
        if is_ext_within(filename, SUPPORT_RAW_FORMAT):
            if cfg is None:
                logger.warning("No RawImgLoadCfg for a RAW file; using "
                               "auto-gamma 16-bit decode.")
                return load_raw_image(filename, auto_gamma=True)
            return load_raw_with_preprocess(
                filename, power=cfg.power, target_nl_mean=cfg.target_nl_mean,
                contrast_alpha=cfg.contrast_alpha,
                output_bps=8 if cfg.output_bps == 8 else 16)
        if is_ext_within(filename, SUPPORT_COMMON_FORMAT):
            return load_8bit_image(filename)
        logger.error(f"Unsupported image format: {filename.split('.')[-1]}.")
        return None
    except (Exception, KeyboardInterrupt) as e:
        logger.error(f"Failed to load image {filename}: {e!r}.")
        if isinstance(e, KeyboardInterrupt):
            raise e
        return None


def load_mask(mask_fname: Optional[str] = None,
              resize_wh: Optional[list[int]] = None,
              grayscale: bool = False) -> np.ndarray:
    """Load an ROI mask as a 0/1 uint8 array.

    jpg masks: gray + binarize (>128 -> 1); png masks: inverted alpha
    channel (reference MetLib/fileio.py:250-292). Returns all-ones when no
    path is given.
    """
    if mask_fname is None:
        if resize_wh is None:
            raise ValueError("resize_wh is required when mask_fname is empty")
        shape = transpose_wh(resize_wh if grayscale else list(resize_wh) + [3])
        return np.ones(shape, dtype=np.uint8)
    mask = load_8bit_image(mask_fname)
    if is_ext_with(mask_fname, ".png"):
        mask = mask[:, :, -1]
        if resize_wh:
            mask = cv2.resize(mask, tuple(resize_wh),
                              interpolation=cv2.INTER_LINEAR)
        mask = np.where(mask > 128, 0, 1).astype(np.uint8)
    else:
        if resize_wh:
            mask = cv2.resize(mask, tuple(resize_wh),
                              interpolation=cv2.INTER_LINEAR)
        if mask.ndim == 3:
            mask = cv2.cvtColor(mask, cv2.COLOR_BGR2GRAY)
        mask = np.where(mask > 128, 1, 0).astype(np.uint8)
    if not grayscale:
        mask = np.repeat(mask[..., None], 3, axis=-1)
    return mask
