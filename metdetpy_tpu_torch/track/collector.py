"""Meteor collector: greedy track association, lifecycle management and
probability scoring.

Semantics parity with reference MeteorCollector (MetLib/collector.py:372-631)
including its quirks (documented inline) -- bit-compatible MDRF output is a
stated goal (BASELINE.json north star). Host-side float64 numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..log import BaseMetLog
from ..profiling import StageTimer
from ..structs import CollectorCfg, MDTarget, RuntimeParams
from ..utils import Name2Label, create_prob_func, frame2ts
from .exporter import MetExporter
from .series import MeteorSeries


class MeteorCollector:
    """Aggregates per-frame line/box responses into scored event series.
    ``spans`` (a ``profiling.StageTimer``) goes to the exporter, whose
    thread it times."""

    def __init__(self, collector_cfg: CollectorCfg,
                 runtime_param: RuntimeParams, video_loader,
                 logger: BaseMetLog, stack_provider=None,
                 recheck_model=None, device: str = "cuda",
                 spans: Optional[StageTimer] = None) -> None:
        mcfg = collector_cfg.meteor_cfg
        self.min_len = mcfg.min_len
        self.max_interval = mcfg.max_interval * runtime_param.fps
        self.max_acti_frame = int(mcfg.max_interval * runtime_param.fps)
        self.det_thre = mcfg.det_thre
        # NOTE: thre2 scales with exp_frame and gates *squared* point
        # distance (reference MetLib/collector.py:386, :367)
        self.thre2 = mcfg.thre2 * runtime_param.exp_frame
        self.runtime_size = runtime_param.runtime_size
        self.cur_frame = 0
        self.eframe = runtime_param.exp_frame
        self.fps = runtime_param.fps
        self.time_prob_func = create_prob_func(mcfg.time_range)
        self.speed_prob_func = create_prob_func(mcfg.speed_range)
        self.len_prob_func = create_prob_func((self.min_len, np.inf))
        self.drct_prob_func = create_prob_func(mcfg.drct_range)
        self.logger = logger

        # sentinel series keeps the active list non-empty; it never expires
        # within a run and never matches real points
        self._sentinel = MeteorSeries(
            2 ** 16, 2 ** 16,
            np.array([[-100, -100], [-101, -101], [-102, -102]]),
            np.nan, np.nan, None, runtime_param.fps, self.runtime_size)
        self.active_meteor: list[MeteorSeries] = [self._sentinel]
        self.waiting_meteor: list[MeteorSeries] = []

        self.met_exporter = MetExporter(
            collector_cfg.recheck_cfg, runtime_param,
            video_loader=video_loader, logger=logger,
            max_interval=self.max_interval, det_thre=self.det_thre,
            stack_provider=stack_provider, recheck_model=recheck_model,
            device=device, spans=spans)

    # ------------------------------------------------------------------

    def update(self, cur_frame: int, lines: Sequence, cates: Sequence) -> None:
        """Feed the responses of one frame (raw-frame index ``cur_frame``).

        Retires series idle for longer than max_interval: scores above
        det_thre/2 go to the waiting (export/recheck) list, others are
        dropped. Without recheck, OTHERS / PLANE_SATELLITE are suppressed
        (reference MetLib/collector.py:430-448).
        """
        self.cur_frame = cur_frame
        to_wait: list[MeteorSeries] = []
        to_drop: list[MeteorSeries] = []
        for ms in self.active_meteor:
            if ms is self._sentinel:
                continue  # never expire/export the sentinel (long runs
                # pass frame 2**16, its synthetic activation frame)
            if self.cur_frame - ms.last_activate_frame >= self.max_interval:
                prob = self.prob_meteor(ms)
                if prob > self.det_thre / 2 and prob != self.det_thre:
                    if self.met_exporter.recheck or ms.cate not in (
                            Name2Label.OTHERS(), Name2Label.PLANE_SATELLITE):
                        to_wait.append(ms)
                    else:
                        to_drop.append(ms)
                else:
                    to_drop.append(ms)
        for ms in to_drop:
            self.active_meteor.remove(ms)
        for ms in to_wait:
            self.active_meteor.remove(ms)

        self.met_exporter.export(MetExporter.DROP_FLAG,
                                 [self.get_met_attr(ms) for ms in to_drop])
        self.waiting_meteor.extend(to_wait)

        # flush the waiting list once no active candidate can still join it
        if self.waiting_meteor:
            no_prob_met = True
            for ms in self.active_meteor:
                if (self.prob_meteor(ms) > self.det_thre / 2
                        and ms.start_frame
                        - self.waiting_meteor[-1].last_activate_frame
                        <= self.max_interval):
                    no_prob_met = False
                    break
            if no_prob_met:
                waiting = [self.get_met_attr(ms) for ms in self.waiting_meteor]
                waiting.sort(key=lambda t: t.start_frame)
                self.met_exporter.export(MetExporter.ACTIVE_FLAG, waiting)
                self.waiting_meteor.clear()

        if len(cates) == 0:
            return

        num_activate = len(self.active_meteor)
        # QUIRK (kept for output parity): the reference computes argmax over
        # axis=0 -- a column-wise argmax -- and zips it against the lines,
        # which also truncates processing to min(n_lines, num_cls) responses
        # (reference MetLib/collector.py:486-487).
        cate_ids = np.argmax(np.array(cates), axis=0)
        for line_pts, cate_id, cate_prob in zip(np.asarray(lines), cate_ids,
                                                np.asarray(cates)):
            if cate_id in (Name2Label.METEOR, Name2Label.PLANE_SATELLITE):
                # line types contribute endpoints + midpoint
                pts = np.array([line_pts[:2], line_pts[2:],
                                (line_pts[:2] + line_pts[2:]) // 2])
            else:
                # area types contribute the four corners + center
                x1, y1, x2, y2 = line_pts
                pts = np.array([[x1, y1], [x2, y2], [x2, y1], [x1, y2],
                                [int((x1 + x2) / 2), int((y1 + y2) / 2)]])
            matched = False
            for ms in self.active_meteor[:num_activate]:
                if ms.may_in_series(pts, cur_frame):
                    ms.update(self.cur_frame, pts, new_cate=cate_prob)
                    matched = True
                    break
            if matched:
                continue
            self.active_meteor.insert(
                len(self.active_meteor) - 1,
                MeteorSeries(max(self.cur_frame - 2 * self.eframe, 0),
                             self.cur_frame, pts,
                             max_acceptable_dist=self.thre2,
                             max_acti_frame=self.max_acti_frame,
                             cate_prob=cate_prob, fps=self.fps,
                             runtime_size=self.runtime_size))

    def clear(self) -> None:
        """Flush everything and join the export thread (call once)."""
        self.update(self.cur_frame + 2 ** 16, [], [])
        self.met_exporter.export(MetExporter.END_FLAG, [])
        self.met_exporter.join()

    def prob_meteor(self, met: MeteorSeries) -> float:
        """Score: for METEOR the product of trapezoid memberships of
        duration/speed/length/direction-variance; otherwise the mean class
        probability (reference MetLib/collector.py:591-615)."""
        if met.cate == 0:
            return (self.time_prob_func(met.fix_duration)
                    * self.speed_prob_func(met.fix_speed)
                    * self.len_prob_func(met.dist)
                    * self.drct_prob_func(met.drst_std))
        if np.any(np.isnan(met.cate_prob)):
            self.logger.error(f"nan detected in cate_prob: {met.cate_prob}")
            raise ValueError("nan in cate_prob")
        return met.cate_prob[met.cate] / met.count

    def get_met_attr(self, met: MeteorSeries) -> MDTarget:
        target = met.get_met_attr()
        target.score = float(np.round(self.prob_meteor(met), 2))
        return target

    def frame2ts(self, frame: int) -> str:
        return frame2ts(frame, self.fps)

    def visu(self, frame_num: int):
        from ..visu import (DotColorPair, DrawCircleVisu, DrawRectVisu,
                            SquareColorPair, TextColorPair, TextVisu)
        from ..utils import color_interpolater, get_id2name, pt_offset
        color_mapper = color_interpolater([(128, 128, 128), (128, 128, 128),
                                           (0, 255, 0)])
        rects, pts_out, texts, text_bg = [], [], [], []
        for ms in self.active_meteor:
            if ms is self._sentinel:
                continue
            pt1, pt2 = ms.range
            prob = self.prob_meteor(ms)
            color = color_mapper(prob)
            rects.append(SquareColorPair(dot_pair=(pt1, pt2), color=color))
            recent = np.where(ms.coord_list.frame_num
                              >= frame_num - self.max_acti_frame)[0]
            first = (len(ms.coord_list.frame_num) if len(recent) == 0
                     else recent[0])
            for p in ms.coord_list[first:]:
                pts_out.append(DotColorPair(dot=(int(p[0]), int(p[1])),
                                            color=color))
            tl = [min(pt1[0], pt2[0]), min(pt1[1], pt2[1])]
            if tl[1] <= 15:
                tl[1] = max(pt1[1], pt2[1]) + 15
            label = f"{get_id2name()[ms.cate]}:{prob:.2f}"
            text_bg.append(SquareColorPair(
                dot_pair=(tl, pt_offset(tl, (10 * len(label), -15))),
                color=color))
            texts.append(TextColorPair(text=label,
                                       position=pt_offset(tl, (0, -2))))
        return [
            DrawRectVisu("active_meteors", pair_list=rects),
            DrawCircleVisu("active_pts", dot_list=pts_out, radius=2,
                           thickness=-1),
            TextVisu("score_text", text_list=texts, color="white"),
            DrawRectVisu("score_bg", pair_list=text_bg, thickness=-1),
        ]
