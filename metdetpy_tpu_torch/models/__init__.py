"""Deep-learning model runtime of the PyTorch/CUDA port (YOLOv5s).

Replaces the reference's onnxruntime backend (MetLib/model.py:43-166) with
PyTorch modules batched on the device.
"""

from __future__ import annotations

from os import path

from ..log import BaseMetLog
from ..structs import ModelCfg
from ..utils import relative2abs_path


def init_model(cfg: ModelCfg, logger: BaseMetLog, device: str = "cuda"):
    """Instantiate a model from config (parity with reference
    MetLib/model.py:407-434) on ``device``. A missing weight file raises."""
    from .yolo import YOLOModel
    available = {"YOLOModel": YOLOModel}
    if cfg.name not in available:
        raise Exception(f"No model named {cfg.name}.")
    weight_path = (cfg.weight_path if path.isabs(cfg.weight_path)
                   else relative2abs_path(cfg.weight_path))
    kwargs = {}
    if cfg.input_hw:
        h, w = cfg.input_hw.lower().split("x")
        kwargs["input_hw"] = (int(h), int(w))
    return available[cfg.name](
        weight_path=weight_path, dtype=cfg.dtype, nms=cfg.nms,
        warmup=cfg.warmup, pos_thre=cfg.pos_thre, nms_thre=cfg.nms_thre,
        multiscale_pred=cfg.multiscale_pred,
        multiscale_partition=cfg.multiscale_partition, logger=logger,
        device=device, **kwargs)


def __getattr__(name: str):
    if name == "YOLOModel":
        from .yolo import YOLOModel
        return YOLOModel
    raise AttributeError(name)
