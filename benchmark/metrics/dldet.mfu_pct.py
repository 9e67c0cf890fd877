"""The dldet step's share of the chip's bfloat16 peak over the window's
untraced calls, in percent: the YOLOv5s forward FLOPs of their merged
frames (``work/yolov5s.py``: FLOPs of a tile from the layer shapes at the
model's input, tiles a frame from the multiscale plan the configuration
asks) over their seconds times 989 TFLOP/s."""

import os

from benchmark.metrics._common import untraced
from benchmark.work import peaks, yolov5s


def _classes() -> int:
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reference", "global", "class_name.txt")
    with open(path, encoding="utf-8") as f:
        names = [ln for ln in f.read().splitlines() if ln.strip()]
    return len(names)  # the model's classes (DROPPED and OTHERS are not)


def read(run):
    model = run.config["detector"]["cfg"].get("model")
    calls = untraced(run)
    seconds = sum(c.seconds for c in calls)
    if model is None or not calls or seconds <= 0:
        return None
    mh, mw = (int(v) for v in model["input_hw"].lower().split("x"))
    h, w = run.entry.hw
    tiles = yolov5s.tiles_per_image(h, w, (mh, mw), model["multiscale_pred"],
                                    model["multiscale_partition"])
    flops = (len(calls) * run.entry.merged_frames * tiles
             * yolov5s.forward_flops(mh, mw, _classes()))
    return 100.0 * flops / (seconds * peaks.BF16_FLOP_PER_S)
