"""The recheck's YOLOv5s share of the chip's bfloat16 peak over the
window's untraced calls, in percent: the forward FLOPs of the tiles the
program forwarded (counter ``recheck_tiles``, from the tile plan each
forward ran; ``work/yolov5s.py``'s FLOPs of a tile at the model's input)
over the seconds of its forwards (span ``recheck_forward_s``) times 989
TFLOP/s. None where the program records no such span or counter."""

from benchmark.cell import metric_module
from benchmark.metrics._common import untraced
from benchmark.work import peaks, yolov5s


def read(run):
    calls = [c for c in untraced(run)
             if "recheck_forward_s" in c.perf and "recheck_tiles" in c.perf]
    seconds = sum(float(c.perf["recheck_forward_s"]) for c in calls)
    tiles = sum(int(c.perf["recheck_tiles"]) for c in calls)
    if not tiles or seconds <= 0:
        return None
    model = run.config["collector"]["recheck_cfg"]["model"]
    mh, mw = (int(v) for v in model["input_hw"].lower().split("x"))
    classes = metric_module("dldet.mfu_pct")._classes()
    flops = tiles * yolov5s.forward_flops(mh, mw, classes)
    return 100.0 * flops / (seconds * peaks.BF16_FLOP_PER_S)
