"""Preprocessing transforms over frame blocks (plain PyTorch, any device).

Counterpart of ``metdetpy_tpu/ops/transforms.py`` (the reference's
per-frame Transform pipeline, MetLib/imgproc.py:70-158): functions on
``[T, H, W, C]`` or ``[T, H, W]`` uint8 tensors. The ``*_exact`` functions
and ``make_block_preprocess`` are bit-exact with cv2 (the loader's device
preprocess relies on it); the others reproduce the jitted JAX functions as
XLA's CPU backend computes them: the float32 gray conversions with the
multiply-adds XLA fuses, and ``resize_bilinear`` with the antialiased
triangle weights ``jax.image.resize`` builds.

Integer arithmetic runs in int32 (PyTorch has few uint16/uint32 ops on
CUDA); the largest intermediate, 32768 * 255 + 16384, fits. The 2:1
downscale's sum of four pixels fits int16.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .f32 import fma_f32

UINT8_MAX = 255
UINT16_MAX = 65535

# BT.601 luma weights used by cv2.cvtColor BGR2GRAY
_B, _G, _R = 0.114, 0.587, 0.299


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """round half to even, clip to [0, 255], uint8 (jnp.round's rule)."""
    return torch.clamp(torch.round(x), 0, UINT8_MAX).to(torch.uint8)


def _luma(img: torch.Tensor, w0: float, w1: float, w2: float) -> torch.Tensor:
    """``c0*w0 + c1*w1 + c2*w2`` in float32 as XLA contracts it:
    fma(c2, w2, fma(c0, w0, round(c1*w1)))."""
    f = img.to(torch.float32)
    inner = fma_f32(f[..., 0], w0, f[..., 1] * float(np.float32(w1)))
    return fma_f32(f[..., 2], w2, inner)


def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] BGR uint8 -> [...] uint8, cv2 BGR2GRAY semantics in float32
    (y = 0.299 R + 0.587 G + 0.114 B, rounded)."""
    return _round_u8(_luma(img, _B, _G, _R))


def rgb2gray(img: torch.Tensor) -> torch.Tensor:
    return _round_u8(_luma(img, _R, _G, _B))


def gray2bgr(img: torch.Tensor) -> torch.Tensor:
    return img[..., None].repeat_interleave(3, dim=-1)


def bgr2gray_exact(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] BGR uint8 -> [...] uint8, bit-exact with cv2's u8 path
    (15-bit fixed-point coefficients summing to 1 << 15; the same math as
    native/metring.cpp)."""
    x = img.to(torch.int32)
    y = 3735 * x[..., 0] + 19235 * x[..., 1] + 9798 * x[..., 2] + (1 << 14)
    return (y >> 15).to(torch.uint8)


def _has_channels(x: torch.Tensor) -> bool:
    return x.ndim >= 3 and x.shape[-1] in (1, 3, 4)


def downscale2x_exact(block: torch.Tensor) -> torch.Tensor:
    """Exact cv2.resize INTER_LINEAR for the 2:1 case on [..., H, W(, C)]
    uint8: source coordinates fall on pixel-pair midpoints with weight
    1024/1024, and OpenCV's fixed-point combine reduces to
    ((x00 + x01 + x10 + x11 + 2) >> 2). Height and width must be even.

    The four taps are strided views of the block added in place into one
    int16 sum (at most 4 * 255 + 2): a few passes over the output, with no
    widened copy of the block and no reduction over pairs, since this runs
    on the card beside the detector's step for every raw block."""
    ha = block.ndim - (3 if _has_channels(block) else 2)  # H axis
    h, w = block.shape[ha], block.shape[ha + 1]
    if h % 2 or w % 2:
        raise ValueError(f"2:1 downscale of an odd size {w}x{h}")
    # [..., h/2, 2 (row of the pair), w/2, 2 (column of the pair)(, C)]
    x = block.unflatten(ha + 1, (w // 2, 2)).unflatten(ha, (h // 2, 2))

    def tap(row: int, col: int) -> torch.Tensor:
        return x.select(ha + 3, col).select(ha + 1, row)

    s = tap(0, 0).to(torch.int16)
    s += tap(0, 1)
    s += tap(1, 0)
    s += tap(1, 1)
    s += 2
    s >>= 2
    return s.to(torch.uint8)


def make_block_preprocess(down2: bool, color: bool
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The cv2-bit-exact device preprocess of the feed: (optional) exact
    2:1 downscale, then (colour sources) exact BT.601 gray -- the
    resize-then-gray order of HostPreprocess. Lets the loader upload raw
    decoded blocks and keep the whole preprocess on the device."""

    def fn(block: torch.Tensor) -> torch.Tensor:
        out = downscale2x_exact(block) if down2 else block
        return bgr2gray_exact(out) if color else out

    return fn


def _triangle_weight_mat(m: int, n: int) -> np.ndarray:
    """[m, n] float32 weights of ``jax.image.resize(method="bilinear")``
    along one axis from m to n samples: half-pixel centres, the triangle
    kernel widened by m/n when scaling down (antialiasing), each output's
    weights normalised to sum 1, in float32, the division by the kernel's
    width a multiplication by its reciprocal. These equal the jitted JAX
    weights exactly when scaling up; when scaling down XLA fuses some of
    the kernel's multiply-adds and not others, depending on the shape, and
    up to a few percent of the weights differ by an ulp (the outputs by at
    most 1 in rare pixels, ROADMAP.md section 3)."""
    f = np.float32
    inv_scale = f(1.0 / (n / m))
    kernel_scale = max(inv_scale, f(1.0))
    sample = (np.arange(n, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f)[:, None]
               ) * f(1.0 / np.float64(kernel_scale))
    w = np.maximum(f(0.0), f(1.0) - np.abs(x.astype(f)))
    total = np.sum(w, axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def _resize_axis(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    m = x.shape[axis]
    if m == n:
        return x
    w = torch.from_numpy(_triangle_weight_mat(m, n)).to(x.device)  # [m, n]
    out = torch.tensordot(x, w, dims=([axis], [0]))   # axis moved last
    return out.movedim(-1, axis)


def resize_bilinear(img: torch.Tensor, dsize_wh: tuple[int, int]
                    ) -> torch.Tensor:
    """Bilinear (antialiased when scaling down) resize of [..., H, W(, C)]
    uint8 to (w, h), as ``jax.image.resize`` computes it: one weight
    product per axis in float32, rounded half to even."""
    w, h = dsize_wh
    ha = img.ndim - (3 if _has_channels(img) else 2)
    out = _resize_axis(img.to(torch.float32), ha, h)
    out = _resize_axis(out, ha + 1, w)
    return _round_u8(out)


def debayer_bilinear(raw: torch.Tensor, pattern: str = "BGGR"
                     ) -> torch.Tensor:
    """Simple bilinear demosaic of a [..., H, W] Bayer mosaic to BGR
    (the BGGR / RGGB patterns of the reference, MetLib/imgproc.py:74-77,
    :123-127). Sums of integers halved or quartered: exact in float32."""
    assert pattern in ("BGGR", "RGGB"), f"unsupported pattern {pattern}"
    f = raw.to(torch.float32)
    hh, ww = raw.shape[-2], raw.shape[-1]
    pad = torch.cat([f[..., :1, :], f, f[..., -1:, :]], dim=-2)
    pad = torch.cat([pad[..., :1], pad, pad[..., -1:]], dim=-1)

    def sh(dy: int, dx: int) -> torch.Tensor:
        return pad[..., dy:dy + hh, dx:dx + ww]

    cross = (sh(0, 1) + sh(2, 1) + sh(1, 0) + sh(1, 2)) / 4.0
    diag = (sh(0, 0) + sh(0, 2) + sh(2, 0) + sh(2, 2)) / 4.0
    horiz = (sh(1, 0) + sh(1, 2)) / 2.0
    vert = (sh(0, 1) + sh(2, 1)) / 2.0

    ys = (torch.arange(hh, device=raw.device) % 2)[:, None]
    xs = (torch.arange(ww, device=raw.device) % 2)[None, :]
    at00 = (ys == 0) & (xs == 0)
    at01 = (ys == 0) & (xs == 1)
    at10 = (ys == 1) & (xs == 0)
    at11 = (ys == 1) & (xs == 1)

    # BGGR: (0,0)=B, (0,1)=G, (1,0)=G, (1,1)=R. RGGB swaps B and R.
    b_plane = torch.where(at00, f, torch.where(at01, horiz,
                          torch.where(at10, vert, diag)))
    g_plane = torch.where(at00 | at11, cross, f)
    r_plane = torch.where(at11, f, torch.where(at10, horiz,
                          torch.where(at01, vert, diag)))
    if pattern == "RGGB":
        b_plane, r_plane = r_plane, b_plane
    return _round_u8(torch.stack([b_plane, g_plane, r_plane], dim=-1))


def u16_to_u8(img: torch.Tensor) -> torch.Tensor:
    """uint16 (or any integer) values -> uint8 by integer division by 257."""
    return torch.div(img.to(torch.int32), 257,
                     rounding_mode="floor").to(torch.uint8)


class Transform:
    """Composable transform pipeline over a frame block (API parity with
    the reference Transform, MetLib/imgproc.py:70-158); the op list is
    applied in order."""

    MASK_FLAG = "MASK"

    def __init__(self) -> None:
        self.transform: list[Callable[[torch.Tensor], torch.Tensor]] = []

    def resize(self, dsize: list[int], **_: Any) -> None:
        self.transform.append(
            lambda img: resize_bilinear(img, (dsize[0], dsize[1])))

    # opencv_* aliases keep reference config/call-site compatibility
    opencv_resize = resize

    def opencv_BGR2GRAY(self) -> None:
        self.transform.append(bgr2gray)

    def opencv_RGB2GRAY(self) -> None:
        self.transform.append(rgb2gray)

    def opencv_GRAY2BGR(self) -> None:
        self.transform.append(gray2bgr)

    def opencv_debayer(self, pattern: str = "BGGR") -> None:
        self.transform.append(lambda img: debayer_bilinear(img, pattern))

    def mask_with(self, mask) -> None:
        mask_t = torch.as_tensor(np.asarray(mask))
        self.transform.append(lambda img: img * mask_t.to(img.device))

    def expand_3rd_channel(self, num: int) -> None:
        assert isinstance(num, int) and num > 0
        self.transform.append(
            lambda img: img[..., None].repeat_interleave(num, dim=-1)
            if num > 1 else img[..., None])

    def opencv_binary(self, threshold, maxval: int = 255,
                      inv: bool = False) -> None:
        hi, lo = (0, maxval) if inv else (maxval, 0)
        self.transform.append(lambda img: torch.where(
            img > threshold, hi, lo).to(torch.uint8))

    def u16_to_u8(self) -> None:
        self.transform.append(u16_to_u8)

    def exec_transform(self, img: torch.Tensor) -> torch.Tensor:
        for fn in self.transform:
            img = fn(img)
        return img

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return self.exec_transform(img)
