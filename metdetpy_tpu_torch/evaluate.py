"""Evaluation / regression harness of the PyTorch/CUDA port:

    python -m metdetpy_tpu_torch.evaluate <annotation.json> [--cfg CFG]
        [--load MDRF] [--save-path PATH] [--metric] [--debug]
        [--device cuda|cpu]

Counterpart of the top-level ``evaluate.py`` (argument-compatible with the
reference evaluate.py:327-421), over the port's ``api.detect_video``: run
detection on an annotated video while sampling CPU and memory, save the
MDRF, and/or compare two MDRFs (ground truth or a previous run) with
temporal-IoU + box-IoU two-pointer matching, confusion matrix and
cross-ratio (``--metric`` writes the mismatches to ``mismatch.json`` in the
working directory). ``--device`` (``cuda``, the default, raises without a
card) is where the detection runs. The process's CPU share and resident
memory are read from the standard library (``os.times``,
``/proc/self/statm``), under the keys of the JAX harness.
"""

import argparse
import copy
import json
import os
import pprint
import threading
import time
from typing import Any, Callable, Optional, Union

import numpy as np

from . import resolve_device
from .api import detect_video
from .io.fileio import save_path_handler
from .io.videowrapper import OpenCVVideoWrapper
from .structs import (MDRF, BasicInfo, Box, MainDetectCfg, MDTarget,
                      MockVideoObject, SingleMDRecord)
from .utils import (calculate_area_iou, get_name2id, get_num_class,
                    relative2abs_path)


def scale(x: list[int], scaler: list[float]) -> list[int]:
    return [int(i * s) for i, s in zip(x, scaler)]


class ProcessSampler:
    """This process's CPU share and resident set size, as psutil's
    ``Process.cpu_percent(interval=None)`` and ``memory_info().rss`` read
    them on Linux: the user + system CPU seconds of all threads since the
    previous call over the wall seconds, in percent (the first call gives
    0.0), and the resident pages of ``/proc/self/statm``."""

    def __init__(self) -> None:
        self._last: Optional[tuple[float, float]] = None

    def cpu_percent(self) -> float:
        t = os.times()
        now = (t.user + t.system, time.monotonic())
        last, self._last = self._last, now
        if last is None or now[1] <= last[1]:
            return 0.0
        return 100.0 * (now[0] - last[0]) / (now[1] - last[1])

    @staticmethod
    def rss() -> int:
        with open("/proc/self/statm", encoding="ascii") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def monitor_performance(func: Callable, args: list[Any],
                        kwargs: dict[str, Any], interval: float = 0.5
                        ) -> tuple[dict[str, float], Any]:
    """Run func while sampling process CPU% and RSS on a timer thread
    (reference evaluate.py:26-84)."""
    process = ProcessSampler()
    start_time = time.time()
    cpu_samples: list[float] = []
    mem_samples: list[float] = []
    stop_event = threading.Event()

    def sample():
        while not stop_event.is_set():
            cpu_samples.append(process.cpu_percent())
            mem_samples.append(process.rss())
            time.sleep(interval)

    thread = threading.Thread(target=sample)
    thread.start()
    try:
        result = func(*args, **kwargs)
    finally:
        stop_event.set()
        thread.join()
    stats = dict(tot_time=time.time() - start_time,
                 avg_cpu_usage=sum(cpu_samples) / max(len(cpu_samples), 1),
                 avg_mem_usage=sum(mem_samples) / max(len(mem_samples), 1)
                 / 1024 / 1024)
    return stats, result


def get_regularized_results(result_dict: MDRF,
                            video: OpenCVVideoWrapper) -> list[MDTarget]:
    """Flatten record targets and rescale coordinates from anno_size to the
    real video size (reference evaluate.py:87-116)."""
    real_size = video.size
    anno_size = result_dict.anno_size
    results = result_dict.results
    assert anno_size is not None and results is not None, \
        "Metrics require anno_size and results!"
    flat = [t for rec in results if isinstance(rec, SingleMDRecord)
            for t in rec.target]
    scaler = [real_size[0] / anno_size[0], real_size[1] / anno_size[1]]
    for t in flat:
        t.pt1 = scale(t.pt1, scaler)
        t.pt2 = scale(t.pt2, scaler)
    return flat


def calculate_time_iou(met_a: MDTarget, met_b: MDTarget) -> float:
    """Temporal IoU over [start_frame, last_activate_frame]."""
    if (met_a.start_frame >= met_b.last_activate_frame
            or met_a.last_activate_frame <= met_b.start_frame):
        return 0
    t = sorted([met_a.start_frame, met_a.last_activate_frame,
                met_b.start_frame, met_b.last_activate_frame], reverse=True)
    return (t[1] - t[2]) / (t[0] - t[3])


def print_confusion_matrix(matrix: np.ndarray, labels: list[str]) -> None:
    head_w, col_w = 15, 5
    header = "PRED\\BASE".center(head_w) + "|"
    header += "".join(lbl[:col_w].center(col_w) + "|" for lbl in labels)
    sep = "-" * head_w + "+" + "+".join("-" * col_w for _ in labels)
    print(header)
    print(sep)
    for i, lbl in enumerate(labels):
        row = lbl.ljust(head_w) + "|"
        row += "".join(str(c).center(col_w) + "|" for c in matrix[i])
        print(row)
        print(sep)


def _target_box(t: MDTarget) -> Box:
    return Box.from_pts(t.pt1, t.pt2)


def compare(video: OpenCVVideoWrapper, base_dict: MDRF, new_dict: MDRF,
            pos_thre: float = 0.5, tiou: float = 0.3,
            aiou: float = 0.3) -> MDRF:
    """Two-pointer greedy matching on (TIoU >= tiou) & (IoU >= aiou) with a
    confusion matrix and cross-ratio summary (reference
    evaluate.py:176-307). Returns the mismatch collection as an MDRF."""
    name2id = get_name2id()
    num_class = get_num_class()
    gt_mode = base_dict.type == "annotation"
    base_results = get_regularized_results(base_dict, video)
    new_results = get_regularized_results(new_dict, video)

    mismatch: list[MDTarget] = []
    confusion = np.zeros((num_class + 1, num_class + 1), dtype=np.int16)
    matched_id = np.zeros((len(base_results),), dtype=bool)
    gt_id = 0
    end_flag = False
    considered = 0
    for i, inst in enumerate(new_results):
        if gt_mode and inst.score <= pos_thre:
            continue
        considered += 1
        while (gt_id < len(base_results)
               and inst.start_time >= base_results[gt_id].end_time):
            gt_id += 1
        if gt_id >= len(base_results):
            end_flag = True
        if end_flag:
            break
        match_flag = False
        cur_id = gt_id
        while (cur_id < len(base_results)
               and inst.end_time >= base_results[cur_id].start_time):
            base = base_results[cur_id]
            if (not matched_id[cur_id]
                    and calculate_time_iou(inst, base) >= tiou
                    and calculate_area_iou(_target_box(inst),
                                           _target_box(base)) >= aiou):
                if base.score is not None and base.score <= pos_thre:
                    base.category = "DROPPED"
                base_cat = base.category
                if base_cat == "UNKNOWN_AREA":
                    base_cat = "OTHERS"
                confusion[name2id[inst.category], name2id[base_cat]] += 1
                if name2id[inst.category] != name2id[base_cat]:
                    mismatch.append(inst)
                match_flag = True
                matched_id[cur_id] = True
                break
            cur_id += 1
        if not match_flag:
            confusion[name2id[inst.category], -1] += 1

    tp_num = int(np.sum(matched_id))
    new_n, old_n = len(new_results), len(base_results)
    summary = {
        "matched_num": tp_num,
        "new_predict_num": new_n,
        "old_predict_num": old_n,
        "cross_ratio(A n B / A u B)": tp_num / max(new_n + old_n - tp_num, 1),
        "fn_num": old_n - tp_num,
        "tn_num": new_n - tp_num,
    }
    if gt_mode:
        # precision over confident (score > pos_thre) predictions only --
        # MDRF results include DROPPED records by design
        summary["considered_num"] = considered
        precision = tp_num / max(considered, 1)
        recall = tp_num / max(old_n, 1)
        summary["precision"] = precision
        summary["recall"] = recall
        summary["f1"] = (2 * precision * recall / max(precision + recall,
                                                      1e-9))
    pprint.pprint(summary)
    print_confusion_matrix(confusion, list(name2id.keys()) + ["MISSED"])

    out = copy.deepcopy(new_dict)
    assert new_dict.anno_size is not None
    out.results = [SingleMDRecord.from_target(t, new_dict.anno_size)
                   for t in mismatch]
    return out


def generate_full_result(results: MDRF,
                         performance: dict[str, Union[float, str, None]]
                         ) -> MDRF:
    assert isinstance(results.basic_info, BasicInfo), "Invalid basic info!"
    results.basic_info.desc = "Basic information about the video"
    performance["desc"] = "Hardware performance"
    performance["cpu_core"] = os.cpu_count()
    results.performance = performance
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m metdetpy_tpu_torch.evaluate",
        description="MetDetPy-TPU Evaluater (PyTorch/CUDA port).")
    parser.add_argument("json", help="json file of test videos.")
    parser.add_argument("--cfg", "-C", help="Config file.",
                        default=relative2abs_path(
                            "./config/m3det_normal.json"))
    parser.add_argument("--load", "-L", default=None,
                        help="Load a result file instead of re-running.")
    parser.add_argument("--save-path", "-S", default=None,
                        help="Save result files.")
    parser.add_argument("--metric", "-M", action="store_true", default=False,
                        help="Calculate metrics against the base json.")
    parser.add_argument("--debug", "-D", action="store_true", default=False,
                        help="Apply Debug Mode")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on: cuda (default) or cpu.")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)

    video_dict = MDRF.from_json_file(args.json)
    cfg = MainDetectCfg.from_json_file(args.cfg)
    if video_dict.basic_info is None or isinstance(video_dict.basic_info,
                                                   MockVideoObject):
        return
    video_name = video_dict.basic_info.video
    mask_name = video_dict.basic_info.mask
    start_time = video_dict.basic_info.start_time
    end_time = video_dict.basic_info.end_time

    shared_path = os.path.split(args.json)[0]
    if os.path.split(video_name)[0] == "":
        video_name = os.path.join(shared_path, video_name)
        video_dict.basic_info.video = video_name
    if mask_name and os.path.split(mask_name)[0] == "":
        mask_name = os.path.join(shared_path, mask_name)
        video_dict.basic_info.mask = mask_name

    video = OpenCVVideoWrapper(video_name)
    try:
        if args.load:
            new_result = MDRF.from_json_file(args.load)
        else:
            performance, results = monitor_performance(
                detect_video, [video_name, mask_name, cfg, args.debug],
                dict(work_mode="frontend",
                     time_range=(str(start_time), str(end_time)),
                     device=args.device))
            new_result = generate_full_result(results, performance)
            if args.save_path:
                save_path = save_path_handler(args.save_path, video_name,
                                              ext="json")
                with open(save_path, "w", encoding="utf-8") as f:
                    json.dump(new_result.to_dict(), f, ensure_ascii=False,
                              indent=4)
        if args.metric:
            mismatch = compare(video, base_dict=video_dict,
                               new_dict=new_result)
            with open("mismatch.json", "w", encoding="utf-8") as f:
                json.dump(mismatch.to_dict(), f, ensure_ascii=False, indent=4)
    finally:
        video.release()


if __name__ == "__main__":
    main()
