"""Declarative debug-overlay records and an OpenCV renderer.

Capability parity with reference MetLib/metvisu.py:74-446: detectors and the
collector emit typed visu records; the renderer draws img -> rect/circle ->
text layers and handles keyboard interrupts. Headless-safe: with
``flag=False`` (the default in server/TPU runs) rendering is a no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import cv2
import numpy as np

from .log import get_default_logger
from .utils import pt_offset

ColorTuple = tuple[int, int, int]

COLOR_MAP: dict[str, ColorTuple] = {
    "black": (0, 0, 0),
    "green": (0, 255, 0),
    "orange": (0, 128, 255),
    "purple": (128, 64, 128),
    "red": (0, 0, 255),
    "white": (255, 255, 255),
    "yellow": (0, 255, 255),
}
DEFAULT_COLOR = "green"
DEFAULT_VISUAL_DELAY = 200
DEFAULT_INTERRUPT_KEY = "q"

# position key -> (w_frac, h_frac, border_dx, border_dy, line_dx, line_dy)
POSITION_MAP = {
    "left-top": (0.0, 0.0, 1, 1, 0, 1),
    "left-bottom": (0.0, 1.0, 1, -1, 0, -1),
    "right-top": (1.0, 0.0, -1, 1, 0, 1),
    "right-bottom": (1.0, 1.0, -1, -1, 0, -1),
}


def _to_color(color) -> Optional[ColorTuple]:
    if isinstance(color, str):
        return COLOR_MAP.get(color, COLOR_MAP[DEFAULT_COLOR])
    return color


def _scale_pt(pt, scaler):
    return [int(pt[0] / scaler[0]), int(pt[1] / scaler[1])]


@dataclasses.dataclass
class TextColorPair:
    text: str
    color: Union[ColorTuple, str, None] = None
    position: Optional[Sequence[int]] = None


@dataclasses.dataclass
class SquareColorPair:
    dot_pair: tuple
    color: Union[ColorTuple, str, None] = None


@dataclasses.dataclass
class DotColorPair:
    dot: tuple
    color: Union[ColorTuple, str, None] = None


@dataclasses.dataclass
class BaseVisuAttrs:
    name: str

    def render(self, img: np.ndarray, scaler) -> np.ndarray:
        return img


@dataclasses.dataclass
class ImgVisuAttrs(BaseVisuAttrs):
    weight: Optional[float] = None
    img: Optional[np.ndarray] = None
    color: Union[ColorTuple, str, None] = None

    def render(self, base: np.ndarray, scaler) -> np.ndarray:
        overlay = self.img
        if overlay is None:
            return base
        if overlay.ndim == 2:
            color = _to_color(self.color)
            if color is not None:
                overlay = np.einsum("hw,c->hwc", overlay.astype(np.float32),
                                    np.array(color, np.float32))
                overlay = np.clip(overlay, 0, 255).astype(np.uint8)
            else:
                overlay = cv2.cvtColor(overlay, cv2.COLOR_GRAY2BGR)
        if overlay.shape[:2] != base.shape[:2]:
            overlay = cv2.resize(overlay, (base.shape[1], base.shape[0]))
        w = self.weight if self.weight is not None else 1.0
        return cv2.addWeighted(base, 1.0, overlay, w, 0)


@dataclasses.dataclass
class DrawVisuAttrs(BaseVisuAttrs):
    color: Union[ColorTuple, str, None] = None
    thickness: Optional[int] = None


@dataclasses.dataclass
class DrawRectVisu(DrawVisuAttrs):
    pair_list: list[SquareColorPair] = dataclasses.field(default_factory=list)

    def render(self, base: np.ndarray, scaler) -> np.ndarray:
        for pair in self.pair_list:
            color = _to_color(pair.color if pair.color is not None
                              else self.color)
            pt1, pt2 = pair.dot_pair
            cv2.rectangle(base, tuple(_scale_pt(pt1, scaler)),
                          tuple(_scale_pt(pt2, scaler)), color,
                          self.thickness or 2)
        return base


@dataclasses.dataclass
class DrawCircleVisu(DrawVisuAttrs):
    dot_list: list[DotColorPair] = dataclasses.field(default_factory=list)
    radius: Optional[int] = None

    def render(self, base: np.ndarray, scaler) -> np.ndarray:
        for dot in self.dot_list:
            color = _to_color(dot.color if dot.color is not None
                              else self.color)
            cv2.circle(base, tuple(_scale_pt(dot.dot, scaler)),
                       self.radius or 2, color, self.thickness or -1)
        return base


@dataclasses.dataclass
class TextVisu(BaseVisuAttrs):
    text_list: list[TextColorPair] = dataclasses.field(default_factory=list)
    position: Union[str, Sequence[int], None] = None
    color: Union[ColorTuple, str, None] = None
    font_face: Optional[int] = None
    font_scale: Optional[float] = None
    font_thickness: Optional[int] = None

    def render(self, base: np.ndarray, scaler) -> np.ndarray:
        for pair in self.text_list:
            color = _to_color(pair.color if pair.color is not None
                              else self.color)
            pos = pair.position if pair.position is not None else self.position
            if not isinstance(pos, (list, tuple)):
                pos = [10, 20]
            cv2.putText(base, pair.text, tuple(int(v) for v in pos),
                        self.font_face or cv2.FONT_HERSHEY_COMPLEX,
                        self.font_scale or 0.5, color,
                        self.font_thickness or 1)
        return base


class OpenCVMetVisu:
    """Renders visu record lists onto frames; headless-safe when flag=False."""

    def __init__(self, exp_time: float, resolution: list[int],
                 flag: bool = True, delay: int = DEFAULT_VISUAL_DELAY,
                 interrupt_key: str = DEFAULT_INTERRUPT_KEY,
                 font_color: Optional[str] = None) -> None:
        assert len(interrupt_key) == 1
        self.flag = flag
        self.visual_delay = int(exp_time * delay)
        self.resolution = resolution
        self.interrupt_key = ord(interrupt_key)
        self.font_color = COLOR_MAP[font_color or DEFAULT_COLOR]
        self.manual_stop = False
        self.logger = get_default_logger()
        self._line_offsets = {k: 0 for k in POSITION_MAP}

    def display_a_frame(self, base_img: np.ndarray,
                        data_list: list[BaseVisuAttrs]) -> bool:
        if not self.flag:
            return True
        if cv2.waitKey(self.visual_delay) & 0xFF == self.interrupt_key:
            self.manual_stop = True
            return False
        if base_img.ndim == 2:
            base_img = cv2.cvtColor(base_img, cv2.COLOR_GRAY2BGR)
        scaler = (1.0, 1.0)
        if (self.resolution[0] != base_img.shape[1]
                or self.resolution[1] != base_img.shape[0]):
            scaler = (base_img.shape[1] / self.resolution[0],
                      base_img.shape[0] / self.resolution[1])
            base_img = cv2.resize(base_img, tuple(self.resolution))

        img_w, img_h = self.resolution
        pos_acc = {k: [int(wf * img_w) + 10 * dx, int(hf * img_h) + 10 * dy]
                   for k, (wf, hf, dx, dy, _, _) in POSITION_MAP.items()}
        offsets = {k: [ow * 20, oh * 20]
                   for k, (_, _, _, _, ow, oh) in POSITION_MAP.items()}

        imgs = [d for d in data_list if isinstance(d, ImgVisuAttrs)]
        draws = [d for d in data_list if isinstance(d, DrawVisuAttrs)]
        texts = [d for d in data_list if isinstance(d, TextVisu)]
        for d in imgs:
            base_img = d.render(base_img, scaler)
        for d in draws:
            base_img = d.render(base_img, scaler)
        for d in texts:
            if isinstance(d.position, str) and d.position in POSITION_MAP:
                pos_acc[d.position] = pt_offset(pos_acc[d.position],
                                                offsets[d.position])
                d.position = list(pos_acc[d.position])
            base_img = d.render(base_img, scaler)
        cv2.imshow(
            f"Debug Window (Press {chr(self.interrupt_key).upper()} to exit)",
            base_img)
        return True

    def stop(self) -> None:
        if self.flag:
            cv2.destroyAllWindows()
