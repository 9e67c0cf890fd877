"""YOLOv5s as PyTorch modules, the counterpart of
``metdetpy_tpu/models/yolov5.py``.

Architecture: YOLOv5 v6.0 "s" variant (depth 0.33 / width 0.50): backbone
CSPDarknet (Conv6x6s2 stem, C3 blocks, SPPF) + PANet head, 3 detection
scales with 3 anchors each, SiLU activations, BN eps 1e-3.

The modules carry the names of their flax counterparts, so the shipped
weights load through ``weights.params_from_flax``. The interface is NHWC as
in the JAX package (``[B, H, W, 3]`` in, heads ``[B, h, w, 3*(5+nc)]`` out);
inside, tensors are NCHW in the ``channels_last`` memory format, so neither
end copies. ``dtype`` is the body's compute dtype, as flax's: parameters are
kept in float32 and cast per layer, the batch norm subtracts the mean and
applies ``rsqrt(var + eps) * scale`` and the bias in float32 before it
rounds to ``dtype``, and the three detect heads always run in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# default anchors (v5s, 640px): per scale [w, h] x 3
DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),       # P3/8
    ((30, 61), (62, 45), (59, 119)),      # P4/16
    ((116, 90), (156, 198), (373, 326)),  # P5/32
)
STRIDES = (8, 16, 32)
BN_EPS = 1e-3

# frozen: the control. "float8" rounds every body convolution's input and
# kernel to float8 e4m3, "int8" to int8 (symmetric), each with one scale a
# tensor, as a scaled low-precision matmul takes them
CONTROL = None
_E4M3_MAX = 448.0


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / _E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def _int8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


def _make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


class FrozenBatchNorm(nn.Module):
    """Inference batch norm over the channel axis of an NCHW tensor with
    float32 parameters whatever the input's dtype, as flax's: ``(x - mean)
    * rsqrt(var + eps) * scale + bias`` in float32, then rounded to the
    compute dtype."""

    def __init__(self, c: int, eps: float = BN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one library call: float32 statistics on an input of the compute
        # dtype, arithmetic in float32, one rounding to the input's dtype
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class ConvBNAct(nn.Module):
    """Conv2D + BatchNorm(inference) + SiLU."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: int | None = None, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        p = p if p is not None else k // 2
        self.conv = nn.Conv2d(c_in, c_out, k, s, p, bias=False)
        self.bn = FrozenBatchNorm(c_out)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.conv.weight.to(self.dtype)
        if CONTROL == "float8":
            x, w = _fp8_round(x), _fp8_round(w)
        elif CONTROL == "int8":
            x, w = _int8_round(x), _int8_round(w)
        x = F.conv2d(x, w, None, self.conv.stride, self.conv.padding)
        x = self.bn(x)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 e: float = 0.5, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        c_hidden = int(c_out * e)
        self.cv1 = ConvBNAct(c_in, c_hidden, 1, 1, dtype=dtype)
        self.cv2 = ConvBNAct(c_hidden, c_out, 3, 1, dtype=dtype)
        self.add = shortcut and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 shortcut: bool = True, e: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        c_hidden = int(c_out * e)
        self.n = n
        self.cv1 = ConvBNAct(c_in, c_hidden, 1, 1, dtype=dtype)
        self.cv2 = ConvBNAct(c_in, c_hidden, 1, 1, dtype=dtype)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c_hidden, c_hidden, shortcut,
                                              e=1.0, dtype=dtype))
        self.cv3 = ConvBNAct(2 * c_hidden, c_out, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x), self.cv2(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, b], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained same-k maxpools (padded
    with -inf, as ``max_pool2d`` pads)."""

    def __init__(self, c_in: int, c_out: int, k: int = 5,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        c_hidden = c_in // 2
        self.k = k
        self.cv1 = ConvBNAct(c_in, c_hidden, 1, 1, dtype=dtype)
        self.cv2 = ConvBNAct(4 * c_hidden, c_out, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NCHW tensor."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv5(nn.Module):
    """YOLOv5 backbone+head; returns raw per-scale predictions."""

    def __init__(self, nc: int = 8, width: float = 0.50, depth: float = 0.33,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.nc, self.dtype = nc, dtype

        def w(c: int) -> int:
            return _make_divisible(c * width)

        def d(n: int) -> int:
            return max(round(n * depth), 1)

        dt = dtype
        # backbone
        self.b0 = ConvBNAct(3, w(64), 6, 2, 2, dtype=dt)             # P1/2
        self.b1 = ConvBNAct(w(64), w(128), 3, 2, dtype=dt)           # P2/4
        self.b2 = C3(w(128), w(128), d(3), dtype=dt)
        self.b3 = ConvBNAct(w(128), w(256), 3, 2, dtype=dt)          # P3/8
        self.b4 = C3(w(256), w(256), d(6), dtype=dt)
        self.b5 = ConvBNAct(w(256), w(512), 3, 2, dtype=dt)          # P4/16
        self.b6 = C3(w(512), w(512), d(9), dtype=dt)
        self.b7 = ConvBNAct(w(512), w(1024), 3, 2, dtype=dt)         # P5/32
        self.b8 = C3(w(1024), w(1024), d(3), dtype=dt)
        self.b9 = SPPF(w(1024), w(1024), 5, dtype=dt)
        # head (PANet)
        self.h10 = ConvBNAct(w(1024), w(512), 1, 1, dtype=dt)
        self.h13 = C3(2 * w(512), w(512), d(3), shortcut=False, dtype=dt)
        self.h14 = ConvBNAct(w(512), w(256), 1, 1, dtype=dt)
        self.h17 = C3(2 * w(256), w(256), d(3), shortcut=False, dtype=dt)
        self.h18 = ConvBNAct(w(256), w(256), 3, 2, dtype=dt)
        self.h20 = C3(2 * w(256), w(512), d(3), shortcut=False, dtype=dt)
        self.h21 = ConvBNAct(w(512), w(512), 3, 2, dtype=dt)
        self.h23 = C3(2 * w(512), w(1024), d(3), shortcut=False, dtype=dt)
        # detect heads: plain conv with bias, always float32
        no = 3 * (5 + nc)
        self.detect0 = nn.Conv2d(w(256), no, 1)
        self.detect1 = nn.Conv2d(w(512), no, 1)
        self.detect2 = nn.Conv2d(w(1024), no, 1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [B, H, W, 3] float in [0, 1]. Returns list of 3 raw heads
        [B, h_i, w_i, 3*(5+nc)] float32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        x = self.b0(x)
        x = self.b1(x)
        x = self.b2(x)
        x = self.b3(x)
        p3 = self.b4(x)
        x = self.b5(p3)
        p4 = self.b6(x)
        x = self.b7(p4)
        x = self.b8(x)
        p5 = self.b9(x)
        h10 = self.h10(p5)
        h13 = self.h13(torch.cat([_upsample2x(h10), p4], dim=1))
        h14 = self.h14(h13)
        out3 = self.h17(torch.cat([_upsample2x(h14), p3], dim=1))
        out4 = self.h20(torch.cat([self.h18(out3), h14], dim=1))
        out5 = self.h23(torch.cat([self.h21(out4), h10], dim=1))
        return [det(feat.float()).permute(0, 2, 3, 1).contiguous()
                for det, feat in ((self.detect0, out3), (self.detect1, out4),
                                  (self.detect2, out5))]


def decode_predictions(heads: Sequence[torch.Tensor], nc: int,
                       anchors=DEFAULT_ANCHORS,
                       strides=STRIDES) -> torch.Tensor:
    """Decode raw heads to [B, N, 5+nc] (xywh in px, obj, cls) with the
    YOLOv5 v5+ box parameterization: xy = (2*sig(xy) - 0.5 + grid) * stride,
    wh = (2*sig(wh))^2 * anchor."""
    outs = []
    for head, anc, stride in zip(heads, anchors, strides):
        b, h, w, _ = head.shape
        dev = head.device
        p = torch.sigmoid(head.reshape(b, h, w, 3, 5 + nc))
        gx = torch.arange(w, dtype=torch.float32, device=dev)
        gy = torch.arange(h, dtype=torch.float32, device=dev)
        grid = torch.stack([gx[None, :].expand(h, w),
                            gy[:, None].expand(h, w)], dim=-1)  # [h, w, 2]
        anc_t = torch.tensor(anc, dtype=torch.float32, device=dev)  # [3, 2]
        xy = (p[..., 0:2] * 2.0 - 0.5 + grid[None, :, :, None, :]) * stride
        wh = torch.square(p[..., 2:4] * 2.0) * anc_t
        outs.append(torch.cat([xy, wh, p[..., 4:]],
                              dim=-1).reshape(b, h * w * 3, 5 + nc))
    return torch.cat(outs, dim=1)


_BN_KEYS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def params_from_flax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Turn the flattened flax tree of the JAX package's YOLOv5
    (``params/<mod>/conv/kernel`` HWIO, ``params/<mod>/bn/{scale,bias}``,
    ``batch_stats/<mod>/bn/{mean,var}``, ``params/detect{i}/{kernel,bias}``)
    into the ``state_dict`` of ``models.yolov5.YOLOv5``: module paths joined
    by dots, conv kernels OIHW, float32. Every array is used exactly once;
    a key of another form raises ``KeyError``. (Keys missing for the model
    surface when the state_dict is loaded with ``strict=True``.)"""
    sd: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        coll, mod, leaf = parts[0], parts[1:-1], parts[-1]
        arr = np.asarray(value, dtype=np.float32)
        if coll == "params" and leaf == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)      # HWIO->OIHW
        elif (coll == "params" and leaf == "bias" and len(mod) == 1
              and mod[0].startswith("detect")):
            name = "bias"
        elif (coll == "params" and mod and mod[-1] == "bn"
              and leaf in ("scale", "bias")) or (
                coll == "batch_stats" and mod and mod[-1] == "bn"
                and leaf in ("mean", "var")):
            name = _BN_KEYS[leaf]
        else:
            raise KeyError(f"cannot map flax parameter {key!r}")
        dst = ".".join(mod + [name])
        if dst in sd:
            raise KeyError(f"flax parameter {key!r} maps onto {dst!r} twice")
        sd[dst] = torch.from_numpy(np.array(arr, order="C"))  # a copy
    return sd
