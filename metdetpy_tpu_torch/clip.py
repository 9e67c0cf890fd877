"""Clip export of the PyTorch/CUDA port: video clips and stacked images
from a video plus clip descriptions (json requests, MDRF results, or bare
times).

    python -m metdetpy_tpu_torch.clip <video|MDRF json> [json]
        [--mode image|video] [--denoise mfnr-mix|simple] [--device cuda|cpu]

The arguments of ``ClipToolkit.py`` (reference ClipToolkit.py:340-688),
including the three input dispatch styles (video+json, MDRF-only,
video+times), per-request padding/clamping, filter rules, max/denoise
stacking, bbox drawing, labelme annotation, and video stream copy / bbox
re-encode, plus ``--device``: where the MFNR denoise and the large-stack
median run (``cuda``, the default, raises without a card; ``cpu`` runs
their plain PyTorch forms on the CPU). Decode, the max stack, the simple
denoise and the writers are host work.

An exception ends the run (the image-folder flow too: ClipToolkit.py logs
it there and carries on).
"""

import argparse
import json
import os
import shutil
import time
from os.path import join as path_join
from os.path import split as path_split
from typing import Any, Optional

import cv2
import numpy as np

from . import get_loader, get_wrapper, get_writer, resolve_device
from .io.fileio import (SUPPORT_RAW_FORMAT, change_file_path, is_ext_with,
                        is_ext_within, load_image_file, replace_path_ext,
                        save_img)
from .log import BaseMetLog, get_default_logger, set_default_logger
from .ops.stack import (all_stacker, max_stacker, mfnr_mix_stacker,
                        simple_denoise_stacker)
from .structs import (MDRF, BasicInfo, ClipCfg, ClipRequest, ExportOption,
                      FilterRules, ImageFrameData, SimpleTarget,
                      VideoFrameData)
from .utils import (VERSION, adjust_ts, frame2ts, get_clip_config_path,
                    pt_len, set_resource_dir, ts2frame)

support_image_suffix = ["JPG", "JPEG", "PNG"]
support_video_suffix = ["AVI", "MP4"]
IMAGE_MODE, VIDEO_MODE = "image", "video"
DEFAULT_SUFFIX_MAPPING = {IMAGE_MODE: "jpg", VIDEO_MODE: "avi"}
NO_VIDEO_PROMPT = ("Missed video name in input MDRF files. Check `video` in "
                   "`basic_info` part.")
AVAILABLE_STACKER_MAPPING = {
    "mfnr-mix": mfnr_mix_stacker,
    "simple": simple_denoise_stacker,
}
BUILTIN_NEGATIVE_CATEGORIES = {"DROPPED", "OTHERS"}


def adaptive_font_param(img: np.ndarray) -> dict[str, int]:
    short = min(img.shape[0], img.shape[1])
    return {
        "font_offset": round(short / 2000) + 4,
        "font_scale": max(round(short / 2000), 1),
        "font_thickness": int(max(1, short // 750)),
    }


def draw_target(img: np.ndarray, target_list: Optional[list[SimpleTarget]],
                cfg: ExportOption) -> np.ndarray:
    """Draw labeled bounding boxes with category-mapped colors and
    boundary-aware label placement (reference ClipToolkit.py:90-143)."""
    if target_list is None:
        return img
    for target in target_list:
        color = cfg.bbox_color
        if cfg.bbox_color_mapping and target.preds in cfg.bbox_color_mapping:
            color = cfg.bbox_color_mapping[target.preds]
        img = cv2.rectangle(img, tuple(target.pt1), tuple(target.pt2),
                            color=color, thickness=cfg.bbox_thickness)
        fp = adaptive_font_param(img)
        text = f"{target.preds}: {target.prob}"
        font = cv2.FONT_HERSHEY_SIMPLEX
        (_, text_h), _ = cv2.getTextSize(text, font, fp["font_scale"],
                                         fp["font_thickness"])
        baseline = int(min(target.pt1[1], target.pt2[1]) - fp["font_offset"])
        if baseline - text_h < 0:
            baseline = int(max(target.pt1[1], target.pt2[1])
                           + fp["font_offset"] + text_h)
        baseline = min(baseline, img.shape[0] - 1)
        img = cv2.putText(img, text, (int(min(target.pt1[0], target.pt2[0])),
                                      baseline), fontFace=font,
                          fontScale=fp["font_scale"], color=color,
                          thickness=fp["font_thickness"])
    return img


def jsonsf2request(json_str: str) -> list[VideoFrameData]:
    if os.path.isfile(json_str):
        with open(json_str, encoding="utf-8") as f:
            data = json.load(f)
    else:
        data = json.loads(json_str)
    assert isinstance(data, list), "Json must be a list!"
    return [ClipRequest.from_dict(req).to_video_data() for req in data]


def parse_input(target_name: str, json_str: Optional[str],
                logger: BaseMetLog, args: Any):
    """Dispatch the three input styles (reference ClipToolkit.py:165-228)."""
    if json_str is not None:
        return target_name, jsonsf2request(json_str)
    if is_ext_with(target_name, "json"):
        if not os.path.isfile(target_name):
            raise FileNotFoundError(f"{target_name} cannot be opened.")
        with open(target_name, encoding="utf-8") as f:
            raw = json.load(f)
        mdrf = MDRF.from_dict(raw)
        video_name = getattr(mdrf.basic_info, "video", None)
        data = mdrf.results
        if mdrf.type in ("image-prediction", "timelapse-prediction"):
            if len(data) == 0:
                logger.warning("Empty result is provided.")
            if mdrf.type == "image-prediction":
                return None, [rec.to_image_data() for rec in data]
            assert isinstance(mdrf.basic_info, BasicInfo)
            assert video_name, NO_VIDEO_PROMPT
            return video_name, [
                rec.to_video_data(fps=mdrf.basic_info.fps,
                                  video_size=mdrf.anno_size) for rec in data]
        assert video_name, NO_VIDEO_PROMPT
        return video_name, [rec.to_video_data() for rec in data]
    return target_name, [VideoFrameData(start_time=args.start_time,
                                        end_time=args.end_time,
                                        target_list=None, video_size=None)]


def filter_targets(target_list: Optional[list[SimpleTarget]],
                   filter_rules: FilterRules,
                   diag_length: float) -> list[SimpleTarget]:
    """Retention rules: exclude negative/excluded classes, low scores and
    short targets (reference ClipToolkit.py:232-253)."""
    if target_list is None or diag_length <= 0:
        return []
    keep = []
    for t in target_list:
        if t.preds in BUILTIN_NEGATIVE_CATEGORIES:
            continue
        if t.preds in filter_rules.exclude_category_list:
            continue
        if t.prob is None or float(t.prob) < filter_rules.threshold:
            continue
        if pt_len(t.pt1, t.pt2) / diag_length < filter_rules.min_length_ratio:
            continue
        keep.append(t)
    return keep


def image_clip_process(data: list[ImageFrameData], clip_cfg: ClipCfg,
                       save_path: str, logger: BaseMetLog) -> None:
    """Image-folder export flow: copy/annotate selected images
    (reference ClipToolkit.py:256-337). An exception ends the flow."""
    try:
        logger.start()
        export_cfg, raw_cfg = clip_cfg.export, clip_cfg.raw_img_load_config
        filter_rules = export_cfg.filter_rules
        for frame_data in data:
            image_data = None
            target_list = frame_data.target_list
            if frame_data.img_size is not None:
                diag = pt_len([0, 0], list(frame_data.img_size))
            else:
                image_data = load_image_file(frame_data.img_filename,
                                             raw_cfg, logger)
                if image_data is None:
                    continue
                diag = pt_len([0, 0], list(image_data.shape[:2]))
                frame_data.img_size = image_data.shape[:2][1::-1]
            if filter_rules.switch:
                target_list = filter_targets(frame_data.target_list,
                                             filter_rules, diag)
                if not target_list:
                    logger.info(f"Skip {frame_data.img_filename}: no valid "
                                "target.")
                    continue
            full_path = change_file_path(frame_data.img_filename, save_path)
            if export_cfg.with_bbox:
                if image_data is None:
                    image_data = load_image_file(frame_data.img_filename,
                                                 raw_cfg, logger)
                    if image_data is None:
                        continue
                image_data = draw_target(image_data, target_list, export_cfg)
                if is_ext_within(full_path, SUPPORT_RAW_FORMAT):
                    logger.warning("Cannot draw targets on RAW; saving .jpg.")
                    full_path = replace_path_ext(full_path, "jpg")
                save_img(image_data, full_path, export_cfg.jpg_quality,
                         export_cfg.png_compressing, color_space="sRGB",
                         logger=logger)
                logger.info(f"Saved: {full_path}")
            else:
                shutil.copy(frame_data.img_filename, full_path)
                logger.info(f"Copied: {full_path}")
            if export_cfg.with_annotation:
                frame_data.target_list = target_list
                frame_data.saved_filename = full_path
                anno_path = replace_path_ext(full_path, "json")
                with open(anno_path, "w", encoding="utf-8") as f:
                    json.dump(frame_data.to_labelme(), f, ensure_ascii=False,
                              indent=4)
                logger.info(f"Saved: {anno_path}")
    finally:
        logger.stop()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m metdetpy_tpu_torch.clip",
        description=f"ClipToolkit {VERSION} (PyTorch/CUDA port)")
    p.add_argument("target", type=str, help="the target video.")
    p.add_argument("json", type=str, nargs="?", default=None,
                   help="json string or json file of clip requests.")
    p.add_argument("--cfg", "-C", type=str, default=None,
                   help="Path to the config file.")
    p.add_argument("--start-time", type=str,
                   help="clip start time (ms or HH:MM:SS).")
    p.add_argument("--end-time", type=str,
                   help="clip end time (ms or HH:MM:SS).")
    p.add_argument("--mode", choices=["image", "video"], default="image",
                   help="convert clip to video or image.")
    p.add_argument("--suffix", type=str, default=None,
                   help="output suffix (jpg for image / avi for video).")
    p.add_argument("--save-path", type=str, default=os.getcwd(),
                   help="output directory (or file for single clips).")
    p.add_argument("--png-compressing", type=int, default=3)
    p.add_argument("--jpg-quality", type=int, default=95)
    p.add_argument("--denoise", type=str,
                   choices=list(AVAILABLE_STACKER_MAPPING), default=None,
                   help="optional denoise algorithm.")
    p.add_argument("--with-annotation", action="store_true",
                   help="generate labelme style annotation.")
    p.add_argument("--with-bbox", action="store_true",
                   help="draw bounding boxes.")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--enable-filter-rules", dest="filter_rules_switch",
                   action="store_true")
    g.add_argument("--disable-filter-rules", dest="filter_rules_switch",
                   action="store_false")
    p.set_defaults(filter_rules_switch=None)
    p.add_argument("--debayer", action="store_true")
    p.add_argument("--debayer-pattern", default="BGGR")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--resource-dir", "-R", type=str, default=None)
    p.add_argument("--padding-before", type=float, default=None)
    p.add_argument("--padding-after", type=float, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device of the MFNR denoise and the large-stack "
                        "median: cuda (default) or cpu.")
    return p


def update_cfg_from_args(base_cfg: ClipCfg, args: argparse.Namespace) -> None:
    base_cfg.image_denoise.switch = args.denoise is not None
    if args.denoise is not None:
        base_cfg.image_denoise.algorithm = args.denoise
    base_cfg.export.jpg_quality = args.jpg_quality
    base_cfg.export.png_compressing = args.png_compressing
    base_cfg.export.with_bbox = args.with_bbox
    base_cfg.export.with_annotation = args.with_annotation
    if args.padding_before is not None:
        base_cfg.export.clip_padding.before = args.padding_before
    if args.padding_after is not None:
        base_cfg.export.clip_padding.after = args.padding_after
    if args.filter_rules_switch is not None:
        base_cfg.export.filter_rules.switch = args.filter_rules_switch


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.resource_dir:
        set_resource_dir(args.resource_dir)
    t0 = time.time()
    cfg_json_path = args.cfg or get_clip_config_path()
    with open(cfg_json_path, encoding="utf-8") as f:
        clip_cfg = ClipCfg.from_dict(json.load(f))
    update_cfg_from_args(clip_cfg, args)
    denoise_cfg, export_cfg = clip_cfg.image_denoise, clip_cfg.export
    filter_rules = export_cfg.filter_rules
    save_path, mode = args.save_path, args.mode

    logger = get_default_logger()
    set_default_logger(args.debug, work_mode="frontend")
    video_name, request_list = parse_input(args.target, args.json,
                                           logger=logger, args=args)

    if len(request_list) == 1 and request_list[0].saved_filename is None:
        if os.path.splitext(save_path)[-1]:
            save_path, request_list[0].saved_filename = path_split(save_path)
    if save_path and not os.path.exists(save_path):
        os.mkdir(save_path)

    if video_name is None:
        image_clip_process(request_list, clip_cfg, save_path=save_path,
                           logger=logger)
        logger.stop()
        return

    LoaderCls = get_loader(clip_cfg.loader)
    WrapperCls = get_wrapper(clip_cfg.wrapper)
    video_loader = LoaderCls(WrapperCls, video_name, resize_option=None,
                             hwaccel=None, exp_option="real-time",
                             resize_interpolation=cv2.INTER_LANCZOS4,
                             debayer=args.debayer,
                             debayer_pattern=args.debayer_pattern,
                             continue_on_err=True)
    WriterCls = get_writer(clip_cfg.writer)
    video_name_pure = os.path.splitext(path_split(video_name)[-1])[0]
    default_suffix = args.suffix or DEFAULT_SUFFIX_MAPPING.get(mode)

    if len(request_list) == 1 and not os.path.isdir(save_path):
        save_path, filename = path_split(save_path)
        request_list[0].saved_filename = filename

    try:
        logger.start()
        for video_frame in request_list:
            if video_frame.start_time is None:
                video_frame.start_time = frame2ts(video_loader.start_frame,
                                                  video_loader.fps)
            if video_frame.end_time is None:
                video_frame.end_time = frame2ts(video_loader.end_frame,
                                                video_loader.fps)
            if export_cfg.clip_padding.before != 0.0:
                video_frame.start_time = adjust_ts(
                    video_frame.start_time, -export_cfg.clip_padding.before,
                    video_loader.fps)
            if export_cfg.clip_padding.after != 0.0:
                video_frame.end_time = adjust_ts(
                    video_frame.end_time, export_cfg.clip_padding.after,
                    video_loader.fps)
            # clamp to the valid video range
            if ts2frame(video_frame.start_time, video_loader.fps) < 0:
                video_frame.start_time = frame2ts(0, video_loader.fps)
            if ts2frame(video_frame.end_time, video_loader.fps) > \
                    video_loader.video_total_frames:
                video_frame.end_time = frame2ts(
                    video_loader.video_total_frames, video_loader.fps)

            tgt_name = (video_frame.saved_filename or
                        f"{video_name_pure}_{video_frame.start_time}-"
                        f"{video_frame.end_time}.{default_suffix}")
            tgt_name = tgt_name.replace(":", "_")
            cur_mode = mode
            suffix = os.path.splitext(tgt_name)[-1].replace(".", "").upper()
            if suffix in support_image_suffix:
                cur_mode = IMAGE_MODE
            elif suffix in support_video_suffix:
                cur_mode = VIDEO_MODE
            else:
                logger.error(f"Unsupported suffix: {suffix}. Skipping.")
                continue

            video_frame.saved_filename = path_join(save_path, tgt_name)
            video_loader.reset(
                ts2frame(video_frame.start_time, video_loader.fps),
                ts2frame(video_frame.end_time, video_loader.fps))
            frame_target_list = video_frame.target_list
            if filter_rules.switch:
                diag = (pt_len([0, 0], list(video_frame.video_size))
                        if video_frame.video_size is not None
                        else pt_len([0, 0], video_loader.raw_size))
                frame_target_list = filter_targets(video_frame.target_list,
                                                   filter_rules, diag)
                if not frame_target_list:
                    logger.debug(f"Skip {video_frame.saved_filename}: no "
                                 "valid target.")
                    continue

            if cur_mode == IMAGE_MODE:
                if denoise_cfg.switch:
                    stacker = AVAILABLE_STACKER_MAPPING[denoise_cfg.algorithm]
                    kw = ({"device": device}
                          if stacker is mfnr_mix_stacker else {})
                    results = stacker(video_loader, denoise_cfg,
                                      logger=logger, **kw)
                else:
                    results = max_stacker(video_loader)
                if results is None:
                    logger.fatal(f"Failed to generate image for "
                                 f"{video_loader.video_name}.")
                    continue
                if export_cfg.with_bbox:
                    results = draw_target(results, frame_target_list,
                                          export_cfg)
                save_img(results, video_frame.saved_filename,
                         export_cfg.jpg_quality, export_cfg.png_compressing,
                         color_space="sRGB", logger=logger)
                logger.info(f"Saved: {video_frame.saved_filename}")
                if export_cfg.with_annotation:
                    video_frame.target_list = frame_target_list
                    anno_path = replace_path_ext(video_frame.saved_filename,
                                                 "json")
                    with open(anno_path, "w", encoding="utf-8") as f:
                        json.dump(video_frame.to_labelme(), f,
                                  ensure_ascii=False, indent=4)
                    logger.info(f"Saved: {anno_path}")
            else:
                if export_cfg.with_bbox:
                    img_series = all_stacker(video_loader, logger=logger)
                    if img_series is not None:
                        annotated = [draw_target(img, frame_target_list,
                                                 export_cfg)
                                     for img in img_series]
                        status = WriterCls.save_video_with_audio(
                            annotated, video_loader, export_cfg,
                            video_frame.saved_filename,
                            start_frame=video_loader.start_frame,
                            end_frame=video_loader.end_frame, logger=logger)
                    else:
                        status = -1
                else:
                    status = WriterCls.save_video_by_stream(
                        video_loader, export_cfg,
                        video_frame.saved_filename, logger=logger)
                if status == 0:
                    logger.info(f"Saved: {video_frame.saved_filename}")
                else:
                    logger.error(f"Error writing "
                                 f"{video_frame.saved_filename}.")
    finally:
        video_loader.release()
        logger.debug(f"Time cost: {time.time() - t0:.2f}s.")
        logger.stop()


if __name__ == "__main__":
    main()
