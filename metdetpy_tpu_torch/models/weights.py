"""YOLOv5 weight persistence and conversion for the PyTorch/CUDA port.

Counterpart of ``metdetpy_tpu/models/weights.py``. The shipped weights
(``weights/*.flax.npz``) are the flattened parameter tree of the JAX
package's flax model; this module provides

  - npz load of that tree (``load_params``, ``flatten_tree``,
    ``unflatten_tree``),
  - ``params_from_flax``: the flattened tree -> the ``state_dict`` of the
    port's ``models.yolov5.YOLOv5`` (every array used exactly once),
  - the numpy-only converters of the JAX package, kept with their output
    format (the flax tree): ``convert_state_dict`` (ultralytics
    ``model.N.*`` names) and ``convert_onnx`` with its built-in protobuf
    wire parser; feed their result through ``flatten_tree`` and
    ``params_from_flax`` to load it into the port.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

# ultralytics layer index -> our module name
_LAYER_MAP = {
    0: "b0", 1: "b1", 2: "b2", 3: "b3", 4: "b4", 5: "b5", 6: "b6", 7: "b7",
    8: "b8", 9: "b9", 10: "h10", 13: "h13", 14: "h14", 17: "h17", 18: "h18",
    20: "h20", 21: "h21", 23: "h23",
}


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params(path: str) -> dict:
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def _assign_convbn(flat: dict, sd: dict, src: str, dst: str) -> None:
    """Map one ConvBNAct: torch OIHW conv weight -> flax HWIO kernel plus
    the four BN arrays."""
    flat[f"params/{dst}/conv/kernel"] = sd[f"{src}.conv.weight"].transpose(
        2, 3, 1, 0)
    flat[f"params/{dst}/bn/scale"] = sd[f"{src}.bn.weight"]
    flat[f"params/{dst}/bn/bias"] = sd[f"{src}.bn.bias"]
    flat[f"batch_stats/{dst}/bn/mean"] = sd[f"{src}.bn.running_mean"]
    flat[f"batch_stats/{dst}/bn/var"] = sd[f"{src}.bn.running_var"]


def _assign_c3(flat: dict, sd: dict, src: str, dst: str) -> None:
    for cv in ("cv1", "cv2", "cv3"):
        _assign_convbn(flat, sd, f"{src}.{cv}", f"{dst}/{cv}")
    i = 0
    while f"{src}.m.{i}.cv1.conv.weight" in sd:
        _assign_convbn(flat, sd, f"{src}.m.{i}.cv1", f"{dst}/m{i}/cv1")
        _assign_convbn(flat, sd, f"{src}.m.{i}.cv2", f"{dst}/m{i}/cv2")
        i += 1


# --- minimal ONNX protobuf wire parser (no onnx package needed) -----------
#
# ONNX files are protobuf ModelProto messages; weight conversion only needs
# the graph's initializer tensors, which live at ModelProto.graph (field 7)
# -> GraphProto.initializer (field 5, repeated TensorProto). TensorProto:
# dims=1, data_type=2, float_data=4, int32_data=5, int64_data=7, name=8,
# raw_data=9, double_data=10. Parsing that subset of the wire format is
# ~60 lines -- cheaper than depending on the (absent) onnx wheel.

_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
                5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
                10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one protobuf message.
    value is an int for varint/fixed fields and bytes for length-delimited
    fields."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:                    # 64-bit
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wt == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                    # 32-bit
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def _varint_to_signed(val: int) -> int:
    """Fold a raw protobuf varint to a signed int: negative int32/int64
    values are wire-encoded as 10-byte two's-complement varints (so -1
    arrives as 2**64-1)."""
    return val - (1 << 64) if val >= 1 << 63 else val


def _parse_tensor_proto(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw = None
    floats: list[float] = []
    int64s: list[int] = []
    int32s: list[int] = []
    doubles: list[float] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1:
            if wt == 2:  # packed dims
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    dims.append(d)
            else:
                dims.append(val)
        elif field == 2 and wt == 0:
            dtype_code = val
        elif field == 4:
            floats.extend(np.frombuffer(val, "<f4") if wt == 2
                          else [np.uint32(val).view(np.float32)])
        elif field == 5:
            if wt == 2:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    int32s.append(_varint_to_signed(d))
            else:
                int32s.append(_varint_to_signed(val))
        elif field == 7:
            if wt == 2:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    int64s.append(_varint_to_signed(d))
            else:
                int64s.append(_varint_to_signed(val))
        elif field == 8 and wt == 2:
            name = val.decode("utf-8")
        elif field == 9 and wt == 2:
            raw = val
        elif field == 10:
            doubles.extend(np.frombuffer(val, "<f8") if wt == 2
                           else [np.uint64(val).view(np.float64)])
    dt = _ONNX_DTYPES.get(dtype_code, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(dt).newbyteorder("<"))
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif doubles:
        arr = np.asarray(doubles, np.float64)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    elif int32s:
        arr = np.asarray(int32s, np.int32)
    else:
        arr = np.zeros(0, dt)
    return name, arr.reshape(dims).astype(dt, copy=False)


def parse_onnx_initializers(onnx_path: str) -> dict[str, np.ndarray]:
    """Extract {name: array} initializer tensors from an ONNX file via the
    built-in wire parser (no onnx dependency)."""
    with open(onnx_path, "rb") as f:
        data = f.read()
    graph = None
    for field, wt, val in _iter_fields(data):
        if field == 7 and wt == 2:   # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{onnx_path}: no graph found (not an ONNX file?)")
    out: dict[str, np.ndarray] = {}
    for field, wt, val in _iter_fields(graph):
        if field == 5 and wt == 2:   # GraphProto.initializer
            name, arr = _parse_tensor_proto(val)
            out[name] = arr
    return out


def convert_onnx(onnx_path: str) -> dict:
    """Convert an ultralytics-exported yolov5s ONNX file to the Flax
    variable tree. Uses the onnx package when present, else the built-in
    wire parser."""
    try:
        import onnx
        from onnx import numpy_helper
        model = onnx.load(onnx_path)
        sd = {init.name: numpy_helper.to_array(init)
              for init in model.graph.initializer}
    except ImportError:
        sd = parse_onnx_initializers(onnx_path)
    return convert_state_dict(sd)


def convert_state_dict(sd: dict[str, np.ndarray]) -> dict:
    """Map an ultralytics yolov5s state dict (``model.N.*`` names, torch
    OIHW conv layout) onto this package's Flax module tree."""
    flat: dict[str, np.ndarray] = {}
    for idx, dst in _LAYER_MAP.items():
        src = f"model.{idx}"
        if f"{src}.conv.weight" in sd:                  # plain ConvBNAct
            _assign_convbn(flat, sd, src, dst)
        elif f"{src}.cv3.conv.weight" in sd:            # C3
            _assign_c3(flat, sd, src, dst)
        elif f"{src}.cv2.conv.weight" in sd:            # SPPF
            _assign_convbn(flat, sd, f"{src}.cv1", f"{dst}/cv1")
            _assign_convbn(flat, sd, f"{src}.cv2", f"{dst}/cv2")
        else:
            raise KeyError(f"cannot map ONNX layer {src}")
    for i in range(3):                                   # Detect heads
        flat[f"params/detect{i}/kernel"] = sd[
            f"model.24.m.{i}.weight"].transpose(2, 3, 1, 0)
        flat[f"params/detect{i}/bias"] = sd[f"model.24.m.{i}.bias"]
    return unflatten_tree(flat)


LFS_HEADER = b"version https://git-lfs.github.com/spec/v1"


def is_lfs_pointer(file_path: str, max_read: int = 4096) -> bool:
    if not os.path.isfile(file_path):
        return False
    with open(file_path, "rb") as f:
        data = f.read(max_read)
    return (data.lstrip().startswith(LFS_HEADER)
            or data.startswith(b"\xef\xbb\xbf" + LFS_HEADER))


# --- flax tree -> state_dict of the port's YOLOv5 -------------------------

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
