"""Entry ``detect_video``: ``metdetpy_tpu_torch.api.detect_video`` over one
in-memory feed (``NumpyVideoWrapper``), one file of a night's batch a call,
and the plain reference (``benchmark.reference.detect``) over the same
frames."""

from __future__ import annotations

import copy
import os

# top-level keys of a configuration file that the program does not read
META = ("source", "about", "reduced", "assumed")


def preset(config: dict, root: str) -> dict:
    """The configuration as the program reads it: the file without its
    notes, with the model weights' path made absolute in the checkout."""
    out = {k: copy.deepcopy(v) for k, v in config.items() if k not in META}

    def fix(model: dict) -> None:
        p = model.get("weight_path")
        if p and not os.path.isabs(p):
            model["weight_path"] = os.path.join(root, p[2:] if p.startswith(
                "./") else p)

    det = out["detector"]["cfg"]
    if "model" in det:
        fix(det["model"])
    fix(out["collector"]["recheck_cfg"]["model"])
    return out


def analysed_hw(config: dict, width: int, height: int) -> tuple:
    """(h, w) of the frames the detector sees: the loader's resize of the
    clip (an int is the long side, a pair is [w, h])."""
    r = config["loader"]["resize"]
    if r is None:
        return height, width
    if isinstance(r, (list, tuple)):
        return int(r[1]), int(r[0])
    s = int(r) / max(width, height)
    return int(round(height * s)), int(round(width * s))


def exp_frames(config: dict, fps: float) -> int:
    """Raw frames merged into one analysed frame."""
    exp = config["loader"]["exp_time"]
    if isinstance(exp, str):
        return 1
    return max(int(round(float(exp) * fps)), 1)


_SINKS: dict = {}


def sink(collector_cls):
    """The one ``judge.Sink`` of a collector class."""
    from benchmark.judge import Sink
    if collector_cls not in _SINKS:
        _SINKS[collector_cls] = Sink(collector_cls)
    return _SINKS[collector_cls]


class Entry:

    def __init__(self, run) -> None:
        if len(run.clips) != 1:
            raise ValueError("detect_video takes one feed")
        self.frames = run.clips[0]
        self.device = str(run.device)
        self.preset = preset(run.config, run.root)
        fps = self.fps = float(run.traffic["fps"])
        self.clip_frames = int(self.frames.shape[0])
        self.hw = analysed_hw(run.config, int(run.traffic["width"]),
                              int(run.traffic["height"]))
        # records give their end points at the clip's size
        self.px_scale = self.hw[1] / int(run.traffic["width"])
        self.exp = exp_frames(run.config, fps)
        self.merged_frames = self.clip_frames // self.exp
        self.window = max(int(run.config["detector"]["window_sec"] * fps
                              / self.exp), 1)
        # the score threshold a model's boxes were kept by (none for lines)
        model = run.config["detector"]["cfg"].get("model")
        self.score_threshold = (float(model["pos_thre"]) if model
                                else None)

    def call(self):
        """(frames offered, MDRF records, MDRF performance, the collector's
        per-frame inputs)."""
        from metdetpy_tpu_torch.api import detect_video
        from metdetpy_tpu_torch.structs import MainDetectCfg
        from metdetpy_tpu_torch.track.collector import MeteorCollector
        cfg = MainDetectCfg.from_dict(copy.deepcopy(self.preset))
        s = sink(MeteorCollector)
        s.open()
        try:
            mdrf = detect_video(self.frames, None, cfg, work_mode="backend",
                                device=self.device)
        finally:
            rows = s.close()
        return (self.clip_frames, mdrf.results,
                dict(mdrf.performance or {}), rows)

    def reference(self, control=None):
        """(records, stats, the collector's per-frame inputs) of the plain
        reference over the same frames."""
        from benchmark import reference
        return reference.detect(self.frames, copy.deepcopy(self.preset),
                                self.device, self.fps, control)
