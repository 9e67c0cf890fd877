"""Detector base classes.

Contract parity with reference BaseDetector (MetLib/Detector.py:130-157):
``update(frame)`` / ``detect() -> (lines, cls_pred)`` / ``visu()``.

The TPU-native extension is the block API: ``process_block(block)`` consumes
a whole ``[T, H, W]`` uint8 block of merged frames on device and returns the
per-frame results in one pass -- the per-frame API is implemented on top of
it with a one-frame block, so both call styles share a single device
pipeline.
"""

from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import Sequence

import numpy as np

FrameResult = tuple[np.ndarray, np.ndarray]  # (lines [m,4], cls_pred [m,C])


class BaseDetector(metaclass=ABCMeta):

    @abstractmethod
    def __init__(self, *args, **kwargs) -> None:
        ...

    @abstractmethod
    def update(self, new_frame: np.ndarray) -> None:
        ...

    @abstractmethod
    def detect(self) -> FrameResult:
        ...

    def visu(self) -> list:
        return []

    def process_block(self, block: np.ndarray) -> list[FrameResult]:
        """Default block path: sequential update/detect per frame."""
        out = []
        for frame in block:
            self.update(frame)
            out.append(self.detect())
        return out
