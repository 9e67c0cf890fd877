"""Meteor detection on still images, image folders and timelapse videos
(the photo entry point of the PyTorch/CUDA port):

    python -m metdetpy_tpu_torch.photo <image|folder|video> [flags]
        [--device cuda|cpu]

The arguments of ``MetDetPhoto.py`` (reference MetDetPhoto.py:98-334) plus
``--device`` (``cuda``, the default, raises without a card). YOLOv5s
(``weights/yolov5s_v5.flax.npz``) runs batched multiscale tile inference:

  - a folder: images decoded in parallel (``MultiThreadImgLoader``),
    same-shape images batched ``METDETPY_TPU_PHOTO_BATCH`` (32) at a time
    through ``BatchPipeline``;
  - one image: ``YOLOModel.forward``;
  - a video (timelapse): frames from a ``ThreadVideoLoader``, batched as
    the folder's images are.

An exception ends the run (in the folder mode too: no partial result is
written); only ``KeyboardInterrupt`` stops the folder loop and keeps what
was found so far. ``--data-parallel N`` (N > 1) splits each batch of the
folder and timelapse modes over N cards, one model replica each
(``parallel.dataparallel``), not in ``--visu`` mode, which shows one image
at a time; with fewer cards it ends with "need N devices, have M".
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as path

import numpy as np

from .io.fileio import (SUPPORT_ALL_IMG_FORMAT, SUPPORT_COMMON_FORMAT,
                        is_ext_within, load_8bit_image, load_mask,
                        load_raw_with_preprocess, save_path_handler)
from .io.imgloader import MultiThreadImgLoader
from .io.videoloader import ThreadVideoLoader
from .io.videowrapper import OpenCVVideoWrapper
from .log import get_default_logger, set_default_logger
from .models.pipeline import BatchPipeline
from .structs import MDRF, MockVideoObject, SingleImgRecord
from .utils import (VERSION, get_id2name, parse_resize_param, pt_offset,
                    relative2abs_path, set_resource_dir)
from .visu import (DrawRectVisu, OpenCVMetVisu, SquareColorPair,
                   TextColorPair, TextVisu)

SUPPORT_VIDEO_FORMAT = ["avi", "mp4", "mkv", "mpeg"]
EXCLUDE_LIST = ["PLANE/SATELLITE", "BUGS"]
# same-shape photos or timelapse frames batched into one device forward
PHOTO_BATCH_SIZE = int(os.environ.get("METDETPY_TPU_PHOTO_BATCH", 32))
DEFAULT_COLOR = (64, 64, 64)
DEFAULT_VISUAL_WINDOW_SIZE = [960, 540]
CATE2COLOR_MAPPING = {
    "METEOR": (0, 255, 0),
    "PLANE/SATELLITE": DEFAULT_COLOR,
    "RED_SPRITE": (0, 0, 255),
    "LIGHTNING": (128, 128, 128),
    "JET": (0, 0, 255),
    "RARE_SPRITE": (0, 0, 255),
    "SPACECRAFT": (255, 0, 255),
}


def construct_visu_info(boxes, preds, watermark_text: str = ""):
    id2name = get_id2name()
    rects, score_bg, score_text = [], [], []
    for b, p in zip(boxes, preds):
        cate_id = int(np.argmax(p))
        color = CATE2COLOR_MAPPING.get(id2name[cate_id], DEFAULT_COLOR)
        x1, y1, x2, y2 = [int(v) for v in b]
        text = f"{id2name[cate_id]}:{np.max(p):.2f}"
        rects.append(SquareColorPair(([x1, y1], [x2, y2]), color=color))
        score_bg.append(SquareColorPair(
            ([x1, y1], pt_offset((x1, y1), (10 * len(text), -15))),
            color=color))
        score_text.append(TextColorPair(text,
                                        position=pt_offset((x1, y1), (0, -2))))
    return [
        TextVisu("timestamp", text_list=[TextColorPair(watermark_text)],
                 position="left-bottom", color="white"),
        DrawRectVisu("activate_meteors", pair_list=rects),
        DrawRectVisu("score_bg", pair_list=score_bg, thickness=-1),
        TextVisu("score_text", text_list=score_text, color="white"),
    ]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m metdetpy_tpu_torch.photo",
        description=f"MetDetPhoto {VERSION} (PyTorch/CUDA port)")
    parser.add_argument("target", help="path to the img or video.")
    parser.add_argument("--mask", help="path to the mask file.")
    parser.add_argument("--model-path", default=None,
                        help="/path/to/the/model")
    parser.add_argument("--resource-dir", default=None,
                        help="Path to the resource folder.")
    parser.add_argument("--exclude-noise", action="store_true")
    parser.add_argument("--model-type", default="YOLOModel",
                        help="type of the model. Support YOLO.")
    parser.add_argument("--debayer", action="store_true",
                        help="apply debayer to the given image/video.")
    parser.add_argument("--debayer-pattern", default="BGGR",
                        help="debayer pattern, like RGGB or BGGR.")
    parser.add_argument("--scale", "-M", type=int, default=2,
                        help="multiscale num.")
    parser.add_argument("--partition", "-P", type=int, default=2,
                        help="partition in pyramid.")
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="split each batch over N devices (0 or 1: one "
                             "device).")
    parser.add_argument("--visu", "-V", action="store_true",
                        help="show detect results.")
    parser.add_argument("--visu-resolution", "-R", type=str,
                        help="detect results showing resolution.")
    parser.add_argument("--save-path", "-S", type=str,
                        help="save path for MDRF.")
    parser.add_argument("--debug", "-D", action="store_true",
                        help="debug mode.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on: cuda (default) or cpu.")
    return parser


def _record_from(boxes, probs, id2name, **kw) -> SingleImgRecord:
    return SingleImgRecord(
        boxes=[list(map(int, x)) for x in boxes],
        preds=[id2name[int(np.argmax(p))] for p in probs],
        prob=[f"{p[int(np.argmax(p))]:.2f}" for p in probs], **kw)


def _run_folder(args, model, logger, id2name, visu_resolution, results,
                sharding=None):
    """Folder mode: ordered parallel decode, batched inference, the
    dispatch of batch N+1 overlapping the postprocess of batch N (one
    image at a time and synchronous in --visu mode). Returns the MDRF's
    basic info."""
    input_path = args.target
    img_list = [os.path.join(input_path, x)
                for x in sorted(os.listdir(input_path))
                if is_ext_within(x, SUPPORT_ALL_IMG_FORMAT)]
    visual_manager = OpenCVMetVisu(exp_time=1, resolution=visu_resolution,
                                   flag=args.visu)
    img_loader = MultiThreadImgLoader(img_list, logger=logger)
    batch_cap = 1 if args.visu else PHOTO_BATCH_SIZE
    # visu mode runs single-image batches: sharding would pad each to N
    # copies, so it stays off there
    pipeline = BatchPipeline(model, inflight=0 if args.visu else 1,
                             sharding=None if args.visu else sharding)
    pending: list[tuple[str, np.ndarray]] = []

    def process_done(done) -> bool:
        for (img_path, img), (boxes, preds) in done:
            if args.visu:
                visual_manager.display_a_frame(
                    img, construct_visu_info(boxes, preds,
                                             watermark_text=img_path))
                if visual_manager.manual_stop:
                    logger.info("Manual interrupt signal detected.")
                    return False
            if len(boxes) > 0:
                results.append(_record_from(
                    boxes, preds, id2name, img_size=list(img.shape)[1::-1],
                    img_filename=img_path))
                logger.meteor(str(results[-1]))
            else:
                logger.debug(f"Image {img_path}: no result.")
        return True

    def flush_pending() -> bool:
        if not pending:
            return True
        done = pipeline.submit(list(pending),
                               np.stack([im for _, im in pending]))
        pending.clear()
        return process_done(done)

    try:
        img_loader.start()
        for _ in range(len(img_list)):
            img_path, img = img_loader.pop()
            if img is None:
                if img_path is None:
                    break
                continue
            if args.mask:
                mask = load_mask(args.mask, list(img.shape[1::-1]))
                img = (img * mask).astype(img.dtype)
            if pending and img.shape != pending[0][1].shape:
                if not flush_pending():
                    break
            pending.append((img_path, img))
            if len(pending) >= batch_cap:
                if not flush_pending():
                    break
        if flush_pending():
            # a manual stop happens only in visu mode (inflight=0, nothing
            # queued); otherwise collect the tail batches
            process_done(pipeline.drain())
    except KeyboardInterrupt:
        logger.error("detection interrupted; the results so far are kept")
    finally:
        img_loader.stop()
    return MockVideoObject(image_folder=input_path)


def _run_single_image(args, model, logger, id2name, visu_resolution):
    input_path = args.target
    if is_ext_within(input_path, SUPPORT_COMMON_FORMAT):
        img = load_8bit_image(input_path)
    else:
        img = load_raw_with_preprocess(input_path, output_bps=8)
    if img is None:
        raise ValueError(f"Failed to load image {input_path}.")
    mask = load_mask(args.mask, list(img.shape[1::-1]))
    img = img * mask
    visual_manager = OpenCVMetVisu(exp_time=1, resolution=visu_resolution,
                                   flag=args.visu)
    boxes, preds = model.forward(img)
    results = [_record_from(boxes, preds, id2name, img_filename=input_path)]
    logger.info(str(results))
    if args.visu:
        import cv2
        visual_manager.display_a_frame(
            img, construct_visu_info(boxes, preds,
                                     watermark_text=input_path))
        cv2.waitKey(0)
    return MockVideoObject(image_folder=input_path), results


def _run_timelapse(args, model, logger, id2name, visu_resolution, results,
                   sharding=None):
    """Timelapse mode: every frame of the video is a photo, batched as the
    folder's images are. Returns the MDRF's basic info (the loader's
    summary)."""
    video = ThreadVideoLoader(
        OpenCVVideoWrapper, args.target, hwaccel=None, mask_name=args.mask,
        exp_option="real-time", debayer=args.debayer,
        debayer_pattern=args.debayer_pattern, continue_on_err=True)
    video.start()
    try:
        visual_manager = OpenCVMetVisu(exp_time=1, resolution=visu_resolution,
                                       flag=args.visu)
        cap = 1 if args.visu else PHOTO_BATCH_SIZE
        pipeline = BatchPipeline(model, inflight=0 if args.visu else 1,
                                 sharding=None if args.visu else sharding)
        pending: list[tuple[int, np.ndarray]] = []

        def process_done(done) -> bool:
            for (i, img), (boxes, probs) in done:
                if args.visu:
                    visual_manager.display_a_frame(
                        img, construct_visu_info(
                            boxes, probs,
                            watermark_text=f"{i}/{video.iterations}"))
                    if visual_manager.manual_stop:
                        logger.info("Manual interrupt signal detected.")
                        return False
                preds = [id2name[int(np.argmax(p))] for p in probs]
                if args.exclude_noise:
                    sel = [k for k, pred in enumerate(preds)
                           if pred not in EXCLUDE_LIST]
                    boxes = [boxes[k] for k in sel]
                    probs = [probs[k] for k in sel]
                if len(boxes) > 0:
                    results.append(_record_from(boxes, probs, id2name,
                                                num_frame=i))
                    logger.meteor(str(results[-1]))
            return True

        def flush() -> bool:
            if not pending:
                return True
            done = pipeline.submit(list(pending),
                                   np.stack([im for _, im in pending]))
            pending.clear()
            return process_done(done)

        for i in range(video.iterations):
            img = video.pop()
            if img is None:
                continue
            pending.append((i, img))
            if len(pending) >= cap:
                if not flush():
                    break
        if flush():
            process_done(pipeline.drain())
        info = video.summary()
    finally:
        video.release()
    return info


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    sharding = None
    if args.data_parallel > 1:
        from .parallel.dataparallel import batch_sharding
        sharding = batch_sharding(args.data_parallel, device=args.device)
    if args.resource_dir:
        set_resource_dir(args.resource_dir)
    if args.model_path is None:
        args.model_path = "./weights/yolov5s_v5.flax.npz"
    input_path = args.target
    model_path = (relative2abs_path(args.model_path)
                  if not path.isabs(args.model_path) else args.model_path)
    visu_resolution = (parse_resize_param(args.visu_resolution,
                                          DEFAULT_VISUAL_WINDOW_SIZE)
                       if args.visu_resolution
                       else DEFAULT_VISUAL_WINDOW_SIZE)
    set_default_logger(debug_mode=args.debug, work_mode="frontend")
    logger = get_default_logger()
    id2name = get_id2name()

    from . import get_model
    model = get_model(args.model_type)(
        model_path, dtype="bfloat16", nms=True, warmup=True, logger=logger,
        multiscale_pred=args.scale, multiscale_partition=args.partition,
        device=args.device)
    if sharding is not None:
        logger.info(f"Data-parallel inference over {sharding.size} "
                    "devices.")
    logger.start()
    results: list[SingleImgRecord] = []
    try:
        if os.path.isdir(input_path):
            info = _run_folder(args, model, logger, id2name,
                               visu_resolution, results, sharding)
        elif os.path.isfile(input_path):
            suffix = input_path.split(".")[-1].lower()
            if suffix in [s.lower() for s in SUPPORT_ALL_IMG_FORMAT]:
                info, results = _run_single_image(
                    args, model, logger, id2name, visu_resolution)
            elif suffix in SUPPORT_VIDEO_FORMAT:
                info = _run_timelapse(args, model, logger, id2name,
                                      visu_resolution, results, sharding)
            else:
                raise NotImplementedError(
                    f"Unsupported file suffix \"{suffix}\"; supported: "
                    f"{SUPPORT_VIDEO_FORMAT} and {SUPPORT_ALL_IMG_FORMAT}.")
        else:
            raise FileNotFoundError(f"File {input_path} does not exist!")

        if args.save_path:
            fin_result = MDRF(
                version=VERSION, basic_info=info, config=None,
                type=("image-prediction" if isinstance(info, MockVideoObject)
                      else "timelapse-prediction"),
                anno_size=info.resolution, results=results)
            save_path = save_path_handler(args.save_path, input_path,
                                          ext="json")
            logger.info(f"Result saved to: {save_path}")
            with open(save_path, mode="w", encoding="utf-8") as f:
                json.dump(fin_result.to_dict(), f, ensure_ascii=False,
                          indent=4)
    except Exception as e:
        logger.error(repr(e))
        raise
    finally:
        logger.stop()


if __name__ == "__main__":
    main()
