"""The records the collector fills (the port's ``structs``: Box,
RuntimeParams, MDTarget, SingleMDRecord), as plain dataclasses."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Box:
    """An axis-ordered detection box (x1<=x2, y1<=y2).

    Mirrors reference MetLib/metstruct.py:15-58.
    """
    x1: int
    y1: int
    x2: int
    y2: int

    @classmethod
    def from_list(cls, coord_list: list[int]) -> "Box":
        assert len(coord_list) == 4, f"expect 4 coords, got {len(coord_list)}"
        x1, y1, x2, y2 = coord_list
        x1, x2 = max(0, min(x1, x2)), max(x1, x2)
        y1, y2 = max(0, min(y1, y2)), max(y1, y2)
        return cls(int(x1), int(y1), int(x2), int(y2))

@dataclasses.dataclass
class RuntimeParams:
    fps: float
    exp_frame: int
    eq_fps: float
    eq_int_fps: int
    exp_time: float
    runtime_size: list[int]
    raw_size: list[int]
    positive_category_list: list[str]


@dataclasses.dataclass
class MDTarget:
    """A single detected target (reference MetLib/metstruct.py:142-183)."""
    start_frame: int
    start_time: str
    end_time: str
    last_activate_frame: int
    last_activate_time: str
    duration: int
    speed: float
    dist: float
    fix_dist: float
    fix_speed: float
    fix_motion_duration: float
    fix_duration: float
    num_pts: int
    category: str
    pt1: list[int]
    pt2: list[int]
    drct_loss: float
    score: float
    real_dist: float
    center_point_list: list[list[int]] = dataclasses.field(default_factory=list)
    raw_score: Optional[float] = None
    recheck_score: Optional[float] = None
    relative_brightness: Optional[float] = None
    aesthetic_score: Optional[float] = None


@dataclasses.dataclass
class SingleMDRecord:
    """A record covering one clip, with its targets
    (reference MetLib/metstruct.py:186-246)."""
    start_time: str
    end_time: str
    video_size: list[int]
    target: list[MDTarget]
    start_frame: Optional[int] = None
    end_frame: Optional[int] = None

    @classmethod
    def from_target(cls, target: MDTarget, video_size: list[int]):
        return cls.from_target_list([target], video_size)

    @classmethod
    def from_target_list(cls, target_list: list[MDTarget],
                         video_size: list[int]):
        return cls(
            start_frame=min(t.start_frame for t in target_list),
            start_time=min(t.start_time for t in target_list),
            end_time=max(t.last_activate_time for t in target_list),
            end_frame=max(t.last_activate_frame for t in target_list),
            video_size=video_size,
            target=target_list,
        )
