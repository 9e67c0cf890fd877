"""MetDetPy-TPU's PyTorch/CUDA port: meteor detection on an NVIDIA GPU.

A second package beside ``metdetpy_tpu`` (the JAX reference it is tested
against); it imports ``torch`` and nothing of JAX or of the JAX package.
Component registry with name->class resolution for config strings
(reference MetLib/__init__.py:17-48, including the reference class names
so reference config files load unchanged).
"""

from __future__ import annotations

from typing import Callable

import torch

from .version import PROJECT_NAME, VERSION  # noqa: F401


def resolve_device(device="cuda") -> torch.device:
    """The torch.device to run on. ``"cuda"`` (the default of every entry
    point) requires a card and raises without one: there is no fallback
    to the CPU, which runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _loaders():
    from .io.videoloader import (BlockVideoLoader, ProcessVideoLoader,
                                 ThreadVideoLoader, VanillaVideoLoader)
    return {
        "VanillaVideoLoader": VanillaVideoLoader,
        "ThreadVideoLoader": ThreadVideoLoader,
        "BlockVideoLoader": BlockVideoLoader,
        "ProcessVideoLoader": ProcessVideoLoader,
    }


def _wrappers():
    from .io.mjpgavi import MJPGAVIVideoWrapper
    from .io.videowrapper import (NumpyVideoWrapper, OpenCVVideoWrapper,
                                  PyAVVideoWrapper)
    return {
        "OpenCVVideoWrapper": OpenCVVideoWrapper,
        "PyAVVideoWrapper": PyAVVideoWrapper,
        "NumpyVideoWrapper": NumpyVideoWrapper,
        "MJPGAVIVideoWrapper": MJPGAVIVideoWrapper,
    }


def _detectors():
    from .detectors.m3det import (ClassicDetector, DiffAreaGuidingDetecor,
                                  M3Detector)
    from .detectors.mldet import MLDetector
    return {
        "M3Detector": M3Detector,
        "ClassicDetector": ClassicDetector,
        "DiffAreaGuidingDetecor": DiffAreaGuidingDetecor,
        "MLDetector": MLDetector,
    }


def _writers():
    from .io.videowriter import (BaseVideoWriter, FFMpegVideoWriter,
                                 OpenCVVideoWriter, PyAVVideoWriter)
    return {
        "BaseVideoWriter": BaseVideoWriter,
        "OpenCVVideoWriter": OpenCVVideoWriter,
        "PyAVVideoWriter": PyAVVideoWriter,
        "FFMpegVideoWriter": FFMpegVideoWriter,
    }


def _models():
    from .models.yolo import YOLOModel
    return {"YOLOModel": YOLOModel}


def _resolver(kind: str, table_fn: Callable[[], dict]):
    def get(class_name: str):
        table = table_fn()
        if class_name not in table:
            raise Exception(f"No class named {class_name} for {kind}.")
        return table[class_name]
    return get


get_loader = _resolver("loader", _loaders)
get_wrapper = _resolver("wrapper", _wrappers)
get_detector = _resolver("detector", _detectors)
get_writer = _resolver("writer", _writers)
get_model = _resolver("model", _models)
