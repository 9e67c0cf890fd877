"""Result exporter: clip merging, recheck fusion, rescaling, serialization.

Semantics parity with reference MetExporter (MetLib/collector.py:634-866):
a dedicated thread consumes flagged batches, merges temporally-close targets
into SingleMDRecord clips, optionally rechecks each clip with the DL model
on a max-stacked color image, fuses scores and demotes unmatched or
low-score targets to DROPPED/OTHERS.

The stacked recheck image comes from a ``stack_provider`` callback. With
BlockVideoLoader this reads the loader's in-memory per-chunk color
max-stacks -- eliminating the reference's second decode pass
(MetLib/collector.py:789-792). A provider backed by a second loader is also
available for the per-frame loaders. The recheck model is the port's
``models.YOLOModel`` on ``device``; a failure to construct it (a missing
weight file, no card) raises out of the constructor, and an exception in
the export thread (the recheck's forward included) is kept and raised again
by ``join``.

The call's span recorder (``spans``, a ``profiling.StageTimer``) times the
export thread: ``exporter.wait`` (blocked on the queue), ``exporter.recheck``
(a batch's recheck), inside it ``exporter.stack`` (the stack provider) and
``recheck.forward`` (the model's forward of a clip's stack), with the
counters ``recheck.clips``, ``recheck.tiles`` (from the tile plan the
forward ran) and ``exporter.stack_bytes``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np

from ..log import BaseMetLog
from ..profiling import StageTimer
from ..structs import Box, MDTarget, RecheckCfg, RuntimeParams, SingleMDRecord
from ..utils import Name2Label, box_matching, get_id2name, get_name2id
from .features import calc_brightness_with_roi

StackProvider = Callable[[int, int], Optional[np.ndarray]]


def scale_to(pt: list[int], rescale: list[float]) -> list[int]:
    return [int(x * y) for x, y in zip(pt, rescale)]


class MetExporter:
    END_FLAG = "END_FLAG"
    DROP_FLAG = "DROP_FLAG"
    ACTIVE_FLAG = "ACTIVE_FLAG"

    def __init__(self, recheck_cfg: RecheckCfg, runtime_param: RuntimeParams,
                 video_loader, logger: BaseMetLog, max_interval: float,
                 det_thre: float,
                 stack_provider: Optional[StackProvider] = None,
                 recheck_model=None, device: str = "cuda",
                 spans: Optional[StageTimer] = None) -> None:
        self.spans = StageTimer() if spans is None else spans
        self.queue: "queue.Queue[tuple[str, list[MDTarget]]]" = queue.Queue()
        self.recheck = recheck_cfg.switch
        self.positive_cates = list(runtime_param.positive_category_list)
        name2id = get_name2id()
        self.positive_cate_ids = [name2id[c] for c in self.positive_cates
                                  if c in name2id]
        self.logger = logger
        self.max_interval = max_interval
        self.det_thre = det_thre
        self.fps = runtime_param.fps
        self.recheck_model = recheck_model
        self.stack_provider = stack_provider
        if self.recheck and self.recheck_model is None:
            # late model init so detect_video can inject a shared instance
            from ..models import init_model
            self.recheck_model = init_model(recheck_cfg.model,
                                            logger=self.logger, device=device)
        if self.recheck and self.stack_provider is None and \
                video_loader is not None:
            self.stack_provider = _loader_stack_provider(video_loader,
                                                         self.logger)
        if self.recheck and self.stack_provider is None:
            self.logger.warning("No stacked-image source for recheck; "
                                "recheck disabled.")
            self.recheck = False

        self.raw_size = runtime_param.raw_size
        self.rescale_ratio = [x / y for x, y in zip(
            runtime_param.raw_size, runtime_param.runtime_size)]
        self.meteor_list: list[SingleMDRecord] = []
        self._loop_error: Optional[BaseException] = None
        self.export_loop = threading.Thread(target=self.loop, daemon=True)
        self.export_loop.start()

    def export(self, flag: str, data: list[MDTarget]) -> None:
        self.queue.put((flag, data))

    def join(self) -> None:
        """Wait for the export thread; raise what ended it, if anything
        did (``meteor_list`` is then incomplete)."""
        self.export_loop.join()
        if self._loop_error is not None:
            raise self._loop_error

    # ------------------------------------------------------------------

    def loop(self) -> None:
        try:
            self._loop()
        except BaseException as e:
            self.logger.error(f"export thread ended by {e!r}")
            self._loop_error = e

    def _get(self) -> tuple[str, list[MDTarget]]:
        with self.spans.span("exporter.wait", wait=True):
            return self.queue.get()

    def _loop(self) -> None:
        id2name = get_id2name()
        flag, data = self._get()
        while flag in (self.ACTIVE_FLAG, self.DROP_FLAG):
            if flag == self.DROP_FLAG:
                for ms_attr in data:
                    ms_attr.category = id2name[Name2Label.DROPPED()]
                    rec = SingleMDRecord.from_target(ms_attr, self.raw_size)
                    rec = self.rescale(rec)
                    self.meteor_list.append(rec)
                    self.logger.dropped(rec.to_json(full=False))
            else:
                final_list = self._merge_clips(data)
                drop_list: list[MDTarget] = []
                if self.recheck:
                    with self.spans.span("exporter.recheck"):
                        final_list, drop_list = self.recheck_progress(
                            final_list)
                for met in final_list:
                    met = self.rescale(met)
                    self.meteor_list.append(met)
                    self.logger.meteor(met.to_json(full=False))
                for ms_attr in drop_list:
                    rec = SingleMDRecord.from_target(ms_attr, self.raw_size)
                    rec = self.rescale(rec)
                    self.meteor_list.append(rec)
                    self.logger.dropped(rec.to_json(full=False))
            flag, data = self._get()
        if flag != self.END_FLAG:
            raise KeyError(f"Unexpected exporter flag {flag}.")

    def _merge_clips(self, data: list[MDTarget]) -> list[SingleMDRecord]:
        """Merge targets whose start is within max_interval of the running
        clip's end into one SingleMDRecord
        (reference MetLib/collector.py:704-729)."""
        current: Optional[SingleMDRecord] = None
        final_list: list[SingleMDRecord] = []
        for ms_attr in data:
            if current is None:
                current = SingleMDRecord.from_target(ms_attr, self.raw_size)
                continue
            if current.end_frame is None:
                self.logger.error("Invalid end frame got!")
                final_list.append(current)
                current = None
                continue
            if ms_attr.start_frame < current.end_frame + self.max_interval:
                if ms_attr.last_activate_frame > current.end_frame:
                    current.end_frame = ms_attr.last_activate_frame
                    current.end_time = ms_attr.last_activate_time
                current.target.append(ms_attr)
            else:
                final_list.append(current)
                current = SingleMDRecord.from_target(ms_attr, self.raw_size)
        if current is not None:
            final_list.append(current)
        return final_list

    def rescale(self, record: SingleMDRecord) -> SingleMDRecord:
        """Map runtime-resolution coordinates back to the raw resolution
        (reference MetLib/collector.py:753-770)."""
        for t in record.target:
            t.pt1 = scale_to(t.pt1, self.rescale_ratio)
            t.pt2 = scale_to(t.pt2, self.rescale_ratio)
            t.real_dist = t.dist * max(self.rescale_ratio)
            for i in range(len(t.center_point_list)):
                t.center_point_list[i] = scale_to(t.center_point_list[i],
                                                  self.rescale_ratio)
        return record

    def recheck_progress(self, final_list: list[SingleMDRecord]
                         ) -> tuple[list[SingleMDRecord], list[MDTarget]]:
        """Per-clip recheck: run the DL model on the clip's color max-stack,
        greedy-match boxes to proposals, fuse scores (mean of raw+recheck for
        METEOR), annotate brightness/aesthetics, demote the rest
        (reference MetLib/collector.py:772-866)."""
        id2name = get_id2name()
        new_final: list[SingleMDRecord] = []
        new_drop: list[MDTarget] = []
        for record in final_list:
            if record.end_frame is None:
                self.logger.error(f"Invalid output clip: {record}")
                continue
            with self.spans.span("exporter.stack"):
                stacked = self.stack_provider(record.start_frame,
                                              record.end_frame + 1)
            if stacked is None:
                self.logger.error(
                    "Failed to get stacked img; clip passes through "
                    f"unchecked (frames {record.start_frame}.."
                    f"{record.end_frame}).")
                new_final.append(record)
                continue
            self.spans.count("exporter.stack_bytes", stacked.nbytes)
            with self.spans.span("recheck.forward"):
                bbox_list, score_list = self.recheck_model.forward(stacked)
            self.spans.count("recheck.clips", 1)
            self.spans.count("recheck.tiles", self.recheck_model.last_tiles)
            raw_boxes = [[*t.pt1, *t.pt2] for t in record.target]
            matched_pairs = box_matching(bbox_list, raw_boxes)
            fixed: list[MDTarget] = []
            unmatched = [True] * len(record.target)
            for l, r in matched_pairs:
                label = int(np.argmax(score_list[l, :], axis=0))
                score = float(score_list[l, label])
                tgt = record.target[r]
                tgt.category = id2name.get(label,
                                           id2name[Name2Label.OTHERS()])
                tgt.raw_score = tgt.score
                tgt.recheck_score = round(score, ndigits=3)
                if label == Name2Label.METEOR:
                    mge_score = (tgt.recheck_score + tgt.raw_score) / 2
                else:
                    mge_score = score
                tgt.score = float(np.round(mge_score, 2))
                if ((label != Name2Label.METEOR
                     and label in self.positive_cate_ids)
                        or (label == Name2Label.METEOR
                            and tgt.score >= self.det_thre)):
                    box = Box.from_pts(tgt.pt1, tgt.pt2)
                    tgt.relative_brightness = round(
                        calc_brightness_with_roi(stacked, box), ndigits=3)
                    tgt.aesthetic_score = round(
                        tgt.score * tgt.fix_dist * tgt.relative_brightness,
                        ndigits=3)
                    fixed.append(tgt)
                else:
                    if label == Name2Label.METEOR:
                        tgt.category = id2name[Name2Label.DROPPED()]
                    new_drop.append(tgt)
                unmatched[r] = False
            if fixed:
                new_final.append(SingleMDRecord.from_target_list(
                    fixed, record.video_size))
            for idx, still in enumerate(unmatched):
                if not still:
                    continue
                if record.target[idx].category in self.positive_cates:
                    record.target[idx].category = id2name[Name2Label.OTHERS()]
                new_drop.append(record.target[idx])
        return new_final, new_drop


def _loader_stack_provider(video_loader, logger) -> StackProvider:
    """Stack provider that re-reads frames from a (second) loader -- the
    path of the per-frame loaders; block loaders give their recheck_stack
    instead. A clip with no frame in range gives None (the clip passes
    unchecked, logged); an exception of the loader propagates, ends the
    export thread and, through ``MetExporter.join``, the run."""

    def provider(start_frame: int, end_frame: int) -> Optional[np.ndarray]:
        video_loader.reset(start_frame=start_frame, end_frame=end_frame)
        acc = None
        video_loader.start()
        try:
            for _ in range(video_loader.iterations):
                frame = video_loader.pop()
                if frame is None:
                    break
                acc = frame if acc is None else np.maximum(acc, frame)
        finally:
            video_loader.stop()
        return acc

    return provider
