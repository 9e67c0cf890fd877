"""The port's result exporter with the recheck off: it merges temporally
close targets into one record, marks dropped targets DROPPED and maps the
coordinates back to the clip's size. The port runs it on a thread of its
own; here each batch is exported when it is handed over, in the same
order.
"""

from __future__ import annotations

from .records import MDTarget, RuntimeParams, SingleMDRecord
from .utils import Name2Label, get_id2name


def scale_to(pt: list[int], rescale: list[float]) -> list[int]:
    return [int(x * y) for x, y in zip(pt, rescale)]


class MetExporter:
    DROP_FLAG = "DROP_FLAG"
    ACTIVE_FLAG = "ACTIVE_FLAG"

    def __init__(self, runtime_param: RuntimeParams,
                 max_interval: float) -> None:
        self.max_interval = max_interval
        self.raw_size = runtime_param.raw_size
        self.rescale_ratio = [x / y for x, y in zip(
            runtime_param.raw_size, runtime_param.runtime_size)]
        self.meteor_list: list[SingleMDRecord] = []

    def export(self, flag: str, data: list[MDTarget]) -> None:
        if flag == self.DROP_FLAG:
            id2name = get_id2name()
            for ms_attr in data:
                ms_attr.category = id2name[Name2Label.DROPPED()]
                rec = SingleMDRecord.from_target(ms_attr, self.raw_size)
                self.meteor_list.append(self.rescale(rec))
        else:
            for met in self._merge_clips(data):
                self.meteor_list.append(self.rescale(met))

    def _merge_clips(self, data: list[MDTarget]) -> list[SingleMDRecord]:
        """Merge targets whose start is within max_interval of the running
        clip's end into one SingleMDRecord
        (reference MetLib/collector.py:704-729)."""
        current = None
        final_list: list[SingleMDRecord] = []
        for ms_attr in data:
            if current is None:
                current = SingleMDRecord.from_target(ms_attr, self.raw_size)
                continue
            if current.end_frame is None:
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
