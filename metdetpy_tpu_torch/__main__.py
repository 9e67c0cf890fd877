"""Video detection CLI of the PyTorch/CUDA port:

    python -m metdetpy_tpu_torch <video> [flags] [--device cuda|cpu]

The arguments of ``MetDetPy.py`` (reference MetDetPy.py:253-398) plus
``--device``. The presets run as shipped: they switch the recheck on, and
the recheck model (YOLOv5s, ``weights/yolov5s_v5.flax.npz``) runs on the
same device as the detector; ``--recheck off`` switches it off. A weight
file that does not exist ends the run with an error. ``--temporal-shards
N`` runs ``api.detect_video_temporal`` instead: the whole clip (or, with
``--temporal-super-block SEC``, super-blocks of SEC seconds) with its time
axis sharded over N cards (N shards on ``--device cpu``).
"""

import argparse
import json

from .api import detect_video, detect_video_temporal
from .io.fileio import save_path_handler
from .structs import BinaryCfg, MainDetectCfg
from .utils import (SWITCH2BOOL, VERSION, relative2abs_path,
                    set_resource_dir)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m metdetpy_tpu_torch",
        description=f"MetDetPy-TPU {VERSION} (PyTorch/CUDA port)")
    parser.add_argument("target", help="input video (H264, HEVC, ...).")
    parser.add_argument("--cfg", "-C", help="Path to the config file.",
                        default=None)
    parser.add_argument("--mask", "-M", help="Mask image.", default=None)
    parser.add_argument(
        "--resource-dir", "-R", default=None,
        help="Path to the resource folder (config/weights/resource/global).")
    parser.add_argument("--start-time", type=str, default=None,
                        help="The start time (ms) of the video.")
    parser.add_argument("--end-time", type=str, default=None,
                        help="The end time (ms) of the video.")
    parser.add_argument("--mode", choices=["backend", "frontend"],
                        default="frontend", type=str,
                        help="Working mode (changes logging format).")
    parser.add_argument("--debug", "-D", action="store_true", default=False,
                        help="Apply Debug Mode")
    parser.add_argument("--visual", "-V", action="store_true", default=False,
                        help="Apply Visual Mode")
    parser.add_argument("--resize", type=str, default=None,
                        help="Running-time resolution")
    parser.add_argument("--exp-time", type=str, default=None,
                        help="Exposure time (s); or auto/real-time/slow.")
    parser.add_argument("--adaptive-thre", nargs="?", const="on",
                        choices=["on", "off"], default=None, type=str,
                        help="Apply adaptive binary threshold.")
    group_bi = parser.add_mutually_exclusive_group(required=False)
    group_bi.add_argument("--bi-thre", type=int, default=None,
                          help="Constant binary threshold value.")
    group_bi.add_argument("--sensitivity", type=str, default=None,
                          help="The sensitivity of detection.")
    parser.add_argument("--recheck", type=str, choices=["on", "off"],
                        default=None,
                        help="Apply recheck before results are printed.")
    parser.add_argument("--provider", type=str, default=None,
                        help="Compute provider hint of the recheck.")
    parser.add_argument("--live-mode", type=str, nargs="?", const="on",
                        choices=["on", "off"], default=None,
                        help="Detect at approximately recording speed.")
    parser.add_argument("--save-path", type=str, default=None,
                        help="Save detection results as a json file.")
    parser.add_argument(
        "--temporal-shards", type=int, default=None,
        help="Batch mode: decode the whole video into memory and detect "
             "with the time axis sharded over N devices (default: "
             "streaming block pipeline).")
    parser.add_argument(
        "--temporal-super-block", type=float, default=None, metavar="SEC",
        help="With --temporal-shards: process the video in SEC-second "
             "super-blocks with the state carried on the device instead of "
             "the whole clip in memory (equal results; bounded host memory "
             "for multi-hour videos).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on: cuda (default) or cpu.")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resource_dir:
        set_resource_dir(args.resource_dir)
    if args.cfg is None:
        args.cfg = relative2abs_path("./config/m3det_normal.json")
    cfg = MainDetectCfg.from_json_file(args.cfg)

    if args.exp_time:
        cfg.loader.exp_time = args.exp_time
    if args.resize:
        cfg.loader.resize = args.resize
    if isinstance(cfg.detector.cfg, BinaryCfg):
        if args.adaptive_thre:
            cfg.detector.cfg.binary.adaptive_bi_thre = SWITCH2BOOL[
                args.adaptive_thre]
        if args.sensitivity:
            cfg.detector.cfg.binary.sensitivity = args.sensitivity
        if args.bi_thre:
            cfg.detector.cfg.binary.init_value = args.bi_thre
    if args.recheck:
        cfg.collector.recheck_cfg.switch = SWITCH2BOOL[args.recheck]
    live_mode = SWITCH2BOOL[args.live_mode] if args.live_mode else False

    if args.temporal_shards:
        result = detect_video_temporal(
            args.target, args.mask, cfg, n_shards=args.temporal_shards,
            work_mode=args.mode,
            time_range=(args.start_time, args.end_time),
            super_block_sec=args.temporal_super_block, device=args.device)
    else:
        result = detect_video(args.target, args.mask, cfg, args.debug,
                              args.visual, work_mode=args.mode,
                              time_range=(args.start_time, args.end_time),
                              live_mode=live_mode,
                              provider_key=args.provider,
                              device=args.device)
    if args.save_path:
        save_path = save_path_handler(args.save_path, args.target, ext="json")
        with open(save_path, mode="w", encoding="utf-8") as f:
            json.dump(result.to_dict(), f, ensure_ascii=False, indent=4)


if __name__ == "__main__":
    main()
