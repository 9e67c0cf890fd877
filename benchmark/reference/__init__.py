"""The plain reference of a detection run over an in-memory clip.

``detect`` works out every layer of the run again from the clip and the
configuration: the loader's preprocess (``preprocess``: the resize to the
analysed size and the exposure's max-merge), the detector (``m3``: the
frozen M3 block step, block by block with its carries; ``dl``: YOLOv5s on
the window-max stacks), the collector's input of every frame the run feeds
it (each frame with a line or a box, and one frame a second of analysed
time besides), and the collector's records (the frozen host collector).
It imports nothing of the program: its frozen parts are under ``frozen/``.

``control`` makes it the control, in the nearest precision below the
configuration's: ``"bfloat16"`` computes the M3 Hough vote's rho in
bfloat16 (the step is float32); ``"int8"`` or ``"float8"`` rounds every
YOLOv5s body convolution's input and kernel to int8 or float8 e4m3, one
scale a tensor (the body is bfloat16).
"""

from __future__ import annotations

import contextlib
import json
import math
import os

import numpy as np

BLOCK = 64   # analysed frames a step takes
CHUNK = 32   # raw frames resized at once, at most
CONTROLS = ("bfloat16", "float8", "int8")


@contextlib.contextmanager
def _plain_float32():
    import torch
    kept = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = kept


def analysed_size(resize, width: int, height: int) -> tuple:
    """(w, h) of the analysed frames: a number is the long side, a pair is
    [w, h], nothing keeps the clip's size."""
    if resize is None:
        return width, height
    if isinstance(resize, (list, tuple)):
        return int(resize[0]), int(resize[1])
    r = int(resize)
    if width > height:
        return r, int(height * r / width)
    return int(width * r / height), r


def exposure(loader: dict, fps: float) -> tuple:
    """(exposure seconds, raw frames merged into an analysed frame)."""
    exp = loader["exp_time"]
    exp_time = 1 / fps if exp == "real-time" else float(exp)
    if exp_time * fps < 1:
        exp_time = 1 / fps
    return exp_time, int(round(exp_time * fps))


def analysed(clip: np.ndarray, cfg: dict, device, e: int, start: int,
             stop: int):
    """Analysed frames ``start``..``stop`` of the clip on ``device``: each
    raw frame resized, and turned gray where the configuration asks for
    gray frames, then each run of ``e`` of them max-merged."""
    import torch

    from . import preprocess
    h, w = clip.shape[1:3]
    aw, ah = analysed_size(cfg["loader"]["resize"], w, h)
    step = max(1, CHUNK // e) * e
    out = []
    for a in range(start * e, stop * e, step):
        raw = torch.from_numpy(clip[a:min(a + step, stop * e)]).to(device)
        x = preprocess.resize_linear(raw, aw, ah)
        if cfg["loader"]["grayscale"] and x.dim() == 4:
            x = preprocess.bgr2gray(x)
        out.append(preprocess.max_merge(x, e))
    return torch.cat(out)


def detect(clip: np.ndarray, cfg: dict, device: str, fps: float,
           control: str | None = None):
    """(records, stats, rows) of the run over ``clip`` ([N, H, W(, 3)]
    uint8 at ``fps``) under ``cfg`` (the configuration's dict, its weight
    paths absolute). ``rows`` holds (frame, lines, probabilities) of each
    frame fed to the collector; ``stats`` holds ``vote_points``, the points
    the M3 Hough votes counted."""
    import torch

    from .frozen import kernels, utils
    from .frozen.collector import MeteorCollector
    from .frozen.records import RuntimeParams
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    dev = torch.device(device)
    h, w = clip.shape[1:3]
    aw, ah = analysed_size(cfg["loader"]["resize"], w, h)
    exp_time, e = exposure(cfg["loader"], fps)
    eq_fps = 1 / exp_time
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "global", "clip_cfg.json"), encoding="utf-8") as f:
        positive = json.load(f)["export"]["positive_category_list"]
    params = RuntimeParams(fps=fps, exp_frame=e, eq_fps=eq_fps,
                           eq_int_fps=math.floor(eq_fps), exp_time=exp_time,
                           runtime_size=[aw, ah], raw_size=[w, h],
                           positive_category_list=positive)
    collector = MeteorCollector(_namespace(cfg["collector"]), params)
    num_cls = utils.get_num_class()
    det = cfg["detector"]
    n_merged = clip.shape[0] // e
    rows = []

    def feed(start: int, results: list) -> None:
        for j, (lines, probs) in enumerate(results):
            k = start + j
            if len(lines) or k % params.eq_int_fps == 0:
                rows.append((k * e, np.array(lines), np.array(probs)))
                collector.update(k * e, lines=lines, cates=probs)

    kernels.CONTROL = control if control == "bfloat16" else None
    kernels.VOTE_POINTS.clear()
    try:
        with _plain_float32(), torch.inference_mode():
            if det["name"] == "M3Detector":
                from .m3 import M3
                m3 = M3(det["cfg"], det["window_sec"], eq_fps, (ah, aw),
                        num_cls, dev)
                for a in range(0, n_merged, BLOCK):
                    b = min(a + BLOCK, n_merged)
                    feed(a, m3.block(analysed(clip, cfg, dev, e, a, b)))
            elif det["name"] == "MLDetector":
                from . import dl
                model = dl.YOLO(det["cfg"]["model"], num_cls - 2, dev,
                                control if control != "bfloat16" else None)
                n = max(int(det["window_sec"] * eq_fps), 1)
                stacks = dl.window_max(analysed(clip, cfg, dev, e, 0,
                                                n_merged), n)
                feed(0, dl.orient(stacks, model.boxes(stacks)))
            else:
                raise ValueError(f"no reference of {det['name']!r}")
        points = int(sum(int(p) for p in kernels.VOTE_POINTS))
    finally:
        kernels.CONTROL = None
        kernels.VOTE_POINTS.clear()
    collector.clear()
    return collector.met_exporter.meteor_list, {"vote_points": points}, rows


class _namespace:
    """A configuration group's keys as attributes, its groups likewise."""

    def __init__(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, _namespace(v) if isinstance(v, dict) else v)
