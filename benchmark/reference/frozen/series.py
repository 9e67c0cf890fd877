"""Meteor track series: point accumulation, geometry stats, and MDTarget
conversion.

Semantics parity with reference MetLib/collector.py:97-369 (PointList,
MeteorSeries). Stays on host in float64 numpy: this is tiny pointer-chasing
bookkeeping fed by compact device readbacks (SURVEY.md §7).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .records import MDTarget
from .utils import frame2ts, get_id2name, pt_drct, pt_len


class PointList:
    """Append-only point store with per-point frame numbers."""

    def __init__(self) -> None:
        self.pts = np.zeros((0, 2), dtype=np.int32)
        self.frame_num = np.zeros((0,), dtype=np.int64)

    def extend(self, new_pts, frame: int) -> None:
        arr = np.asarray(new_pts)
        self.pts = np.concatenate([self.pts, arr.astype(np.int32)], axis=0)
        self.frame_num = np.concatenate(
            [self.frame_num, np.full((len(arr),), frame, dtype=np.int64)])

    def get_pts_as_list(self) -> list[list[int]]:
        return [[int(p[0]), int(p[1])] for p in self.pts]

    def __getitem__(self, i):
        return self.pts[i]

    def __len__(self) -> int:
        return len(self.pts)


class MeteorSeries:
    """One candidate event track.

    Accumulates line/area response points across frames, tracks the bounding
    range, direction variance and class-probability sums, and derives the
    normalized motion statistics used by the collector's probability scoring
    (reference MeteorSeries, MetLib/collector.py:141-369).
    """

    def __init__(self, start_frame: int, cur_frame: int,
                 init_pts: Sequence, max_acceptable_dist: float,
                 max_acti_frame: float, cate_prob, fps: float,
                 runtime_size: list[int]) -> None:
        self.coord_list = PointList()
        self.center_list = PointList()
        self.drct_list: list[float] = []
        self.coord_list.extend(init_pts, cur_frame)
        self.center_list.extend(np.mean(np.asarray(init_pts), axis=0)[None],
                                cur_frame)
        self.drct_list.append(pt_drct(init_pts[0], init_pts[1]))
        self.start_frame = start_frame
        self.end_frame = cur_frame
        self.last_activate_frame = cur_frame
        self.max_acti_frame = max_acti_frame
        self.max_acceptable_dist = max_acceptable_dist
        self.count = 1
        self.cate_prob = cate_prob
        self.fps = fps
        self.runtime_length = max(runtime_size)
        self.range = ([2 ** 16, 2 ** 16], [-2 ** 16, -2 ** 16])
        self.calc_new_range(init_pts)

    # -- derived statistics -------------------------------------------

    @property
    def drst_std(self) -> float:
        """Direction variance: min of the stds computed in the two angle
        wrappings, dropping the largest sample when >= 3 samples."""
        if not self.drct_list:
            return 0.0
        d = np.array(self.drct_list, dtype=float)
        std1 = np.std(np.sort(d)[:-1]) if len(d) >= 3 else np.std(d)
        d2 = d.copy()
        d2[d2 > np.pi / 2] -= np.pi
        std2 = np.std(np.sort(d2)[:-1]) if len(d2) >= 3 else np.std(d2)
        return float(min(std1, std2))

    @property
    def cate(self) -> int:
        return int(np.argmax(self.cate_prob, axis=0))

    @property
    def duration(self) -> int:
        """Full frames from start to the last response (uses
        last_activate_frame, not end_frame)."""
        return self.last_activate_frame - self.start_frame + 1

    @property
    def fix_duration(self) -> float:
        return self.duration / self.fps

    @property
    def fix_motion_duration(self) -> float:
        return (self.end_frame - self.start_frame) / self.fps

    @property
    def sort_range(self):
        """Range endpoints ordered by time of first/last response."""
        [x0, y0], [x1, y1] = self.range
        e_x, e_y = self.coord_list[int(np.argmin(self.coord_list.frame_num))]
        l_x, l_y = self.coord_list[int(np.argmax(self.coord_list.frame_num))]
        if e_x > l_x:
            x0, x1 = x1, x0
        if e_y > l_y:
            y0, y1 = y1, y0
        return [x0, y0], [x1, y1]

    @property
    def dist(self) -> float:
        pt1, pt2 = self.range
        return float(pt_len(pt1, pt2))

    @property
    def fix_dist(self) -> float:
        """Distance as % of the long frame side (x100)."""
        return self.dist / self.runtime_length * 100

    @property
    def speed(self) -> float:
        """Px per frame, over motion duration only."""
        return self.dist / (self.end_frame - self.start_frame + 1e-6)

    @property
    def fix_speed(self) -> float:
        """% of long side per second (x100)."""
        return self.speed * self.fps / self.runtime_length * 100

    # -- updates -------------------------------------------------------

    def calc_new_range(self, pts) -> None:
        self.range = ([
            min(int(min(p[0] for p in pts)), self.range[0][0]),
            min(int(min(p[1] for p in pts)), self.range[0][1]),
        ], [
            max(int(max(p[0] for p in pts)), self.range[1][0]),
            max(int(max(p[1] for p in pts)), self.range[1][1]),
        ])

    def update(self, new_frame: int, new_box, new_cate) -> None:
        (x1, y1), (x2, y2) = self.range
        # points outside the current range advance end_frame (the object is
        # still moving); others only refresh last_activate_frame
        for pt in new_box:
            if not (x1 <= pt[0] <= x2 and y1 <= pt[1] <= y2):
                self.end_frame = new_frame
                break
        self.last_activate_frame = new_frame
        self.coord_list.extend(new_box, new_frame)
        self.center_list.extend(np.mean(np.asarray(new_box), axis=0)[None],
                                new_frame)
        self.calc_new_range(new_box)
        self.drct_list.append(pt_drct(new_box[0], new_box[1]))
        self.cate_prob = self.cate_prob + new_cate
        self.count += 1

    def may_in_series(self, pts, cur_frame: int) -> bool:
        """Nearest-point gating against recent track points
        (reference MetLib/collector.py:357-369; note the threshold compares
        squared distance against thre2 directly). Vectorized: the python
        point-pair loop measured ~2 ms/call on busy skies — with the
        decode path fixed, track association was next in line to bind the
        pipeline. float64 keeps the arithmetic exact for pixel coords."""
        recent = np.where(self.coord_list.frame_num
                          >= cur_frame - self.max_acti_frame)[0]
        first = (len(self.coord_list.frame_num) if len(recent) == 0
                 else recent[0])
        in_pts = self.coord_list.pts[first:].astype(np.float64)
        tgt = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        if len(in_pts) == 0 or len(tgt) == 0:
            return False
        d = tgt[:, None, :] - in_pts[None, :, :]
        return bool(((d * d).sum(-1) < self.max_acceptable_dist).any())

    def get_met_attr(self, decimals: int = 3) -> MDTarget:
        pt1, pt2 = self.sort_range
        dist = float(pt_len(pt1, pt2))
        id2name = get_id2name()
        return MDTarget(
            start_time=frame2ts(self.start_frame, self.fps),
            start_frame=self.start_frame,
            end_time=frame2ts(self.end_frame, self.fps),
            last_activate_frame=self.last_activate_frame,
            last_activate_time=frame2ts(self.last_activate_frame, self.fps),
            duration=self.duration,
            speed=float(np.round(self.speed, decimals)),
            dist=float(np.round(dist, decimals)),
            fix_dist=float(np.round(self.fix_dist, decimals)),
            fix_speed=float(np.round(self.fix_speed, decimals)),
            fix_motion_duration=float(np.round(self.fix_motion_duration,
                                               decimals)),
            fix_duration=float(np.round(self.fix_duration, decimals)),
            num_pts=len(self.coord_list),
            category=id2name[self.cate],
            pt1=[int(pt1[0]), int(pt1[1])],
            pt2=[int(pt2[0]), int(pt2[1])],
            center_point_list=self.center_list.get_pts_as_list(),
            drct_loss=float(np.round(self.drst_std, 3)),
            score=-1,
            real_dist=-1)
