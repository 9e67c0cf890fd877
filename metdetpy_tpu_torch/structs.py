"""Structured data and config schema for MetDetPy-TPU.

Schema parity: field names/shapes mirror the reference MDRF / config JSON
schema (reference: MetLib/metstruct.py:319-649) so that m3det_*.json presets
and MDRF results.json files are interchangeable between the two frameworks.
The (de)serialization engine below is a small dependency-free replacement for
dacite (the reference uses dacite, MetLib/metstruct.py:117-124).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import typing
from typing import Any, Optional, Union

import numpy as np

# --------------------------------------------------------------------------
# Minimal typed from_dict engine (dacite replacement)
# --------------------------------------------------------------------------


class StructError(Exception):
    pass


def _build(tp: Any, value: Any) -> Any:
    """Recursively construct a value of (possibly generic) type ``tp``."""
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)

    if tp is Any or tp is None:
        return value
    if origin is Union:
        if value is None and type(None) in args:
            return None
        # Dataclass unions (e.g. DetectorCfg.cfg: Union[BinaryCfg, DLCfg])
        # are discriminated EXPLICITLY by field shape rather than
        # first-successful-build: every required field of the winner must
        # be present and it must match strictly more of the dict's keys
        # than any other member -- so adding an optional field to one
        # member can never silently flip which member a config builds as
        # (the reference's dacite has exactly that first-match fragility,
        # MetLib/metstruct.py:394).
        dc_members = [m for m in args if dataclasses.is_dataclass(m)]
        if isinstance(value, dict) and len(dc_members) >= 2:
            keys = set(value)
            scored = []
            for m in dc_members:
                fields = dataclasses.fields(m)
                required = {f.name for f in fields
                            if f.default is dataclasses.MISSING
                            and f.default_factory is dataclasses.MISSING}
                if not required <= keys:
                    continue
                scored.append((len({f.name for f in fields} & keys), m))
            if scored:
                scored.sort(key=lambda s: s[0], reverse=True)
                if len(scored) > 1 and scored[0][0] == scored[1][0]:
                    raise StructError(
                        f"ambiguous Union {tp}: {value!r} matches "
                        f"{scored[0][1].__name__} and "
                        f"{scored[1][1].__name__} equally well")
                return _build(scored[0][1], value)
        # Optional[...] / primitive unions: try each member in order.
        last_err: Optional[Exception] = None
        for member in args:
            if member is type(None):
                continue
            try:
                return _build(member, value)
            except Exception as e:  # try next member
                last_err = e
        raise StructError(f"no Union member of {tp} accepts {value!r}: {last_err}")
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            raise StructError(f"expected sequence for {tp}, got {type(value)}")
        elem_tp = args[0] if args else Any
        seq = [_build(elem_tp, v) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        if not isinstance(value, dict):
            raise StructError(f"expected dict for {tp}, got {type(value)}")
        return dict(value)
    if dataclasses.is_dataclass(tp):
        if not isinstance(value, dict):
            raise StructError(f"expected dict for {tp}, got {type(value)}")
        fields = {f.name: f for f in dataclasses.fields(tp)}
        hints = _field_types(tp)
        kwargs: dict[str, Any] = {}
        for name, f in fields.items():
            if name in value:
                kwargs[name] = _build(hints.get(name, f.type), value[name])
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):  # type: ignore
                raise StructError(f"missing required field {tp.__name__}.{name}")
        return tp(**kwargs)
    # primitives: allow benign numeric coercions (int -> float)
    if tp is float and isinstance(value, (int, float)):
        return float(value)
    if tp is int and isinstance(value, int) and not isinstance(value, bool):
        return int(value)
    if tp is bool and isinstance(value, bool):
        return value
    if tp is str and isinstance(value, str):
        return value
    if isinstance(tp, type) and isinstance(value, tp):
        return value
    raise StructError(f"cannot build {tp} from {value!r} ({type(value)})")


_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def _field_types(tp: type) -> dict[str, Any]:
    """Resolved field annotations for a dataclass, cached per class.

    ``from __future__ import annotations`` stringifies every annotation;
    ``typing.get_type_hints`` is the stdlib's sanctioned resolver for
    them (no ad-hoc eval of annotation text)."""
    hints = _HINTS_CACHE.get(tp)
    if hints is None:
        hints = typing.get_type_hints(tp)
        _HINTS_CACHE[tp] = hints
    return hints


def from_dict(data_class: type, data: dict[str, Any]) -> Any:
    return _build(data_class, data)


def _jsonable(value: Any, full: bool) -> Any:
    if isinstance(value, DictAble):
        return value.to_dict(full)
    if isinstance(value, (list, tuple)):
        return [_jsonable(v, full) for v in value]
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _jsonable(getattr(value, f.name), full)
                for f in dataclasses.fields(value)}
    return value


@dataclasses.dataclass
class DictAble:
    """Base for dict/json round-trippable dataclasses.

    ``exclude_attrs`` lists fields omitted when ``full=False``
    (reference semantics: MetLib/metstruct.py:76-124).
    """

    EXCLUDE_KEY = "exclude_attrs"

    def to_dict(self, full: bool = True) -> dict[str, Any]:
        skip = [] if full else list(getattr(self, self.EXCLUDE_KEY, []) or [])
        out: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if f.name == self.EXCLUDE_KEY or f.name in skip:
                continue
            out[f.name] = _jsonable(getattr(self, f.name), full)
        return out

    def to_json(self, full: bool = True) -> str:
        return json.dumps(self.to_dict(full))

    @classmethod
    def from_dict(cls, data: dict[str, Any]):
        return from_dict(cls, data)

    @classmethod
    def from_json_file(cls, json_path: str):
        with open(json_path, mode="r", encoding="utf-8") as f:
            return from_dict(cls, json.load(f))


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Box:
    """An axis-ordered detection box (x1<=x2, y1<=y2).

    Mirrors reference MetLib/metstruct.py:15-58.
    """
    x1: int
    y1: int
    x2: int
    y2: int

    @classmethod
    def from_list(cls, coord_list: list[int]) -> "Box":
        assert len(coord_list) == 4, f"expect 4 coords, got {len(coord_list)}"
        x1, y1, x2, y2 = coord_list
        x1, x2 = max(0, min(x1, x2)), max(x1, x2)
        y1, y2 = max(0, min(y1, y2)), max(y1, y2)
        return cls(int(x1), int(y1), int(x2), int(y2))

    @classmethod
    def from_pts(cls, pt1: list[int], pt2: list[int]) -> "Box":
        return cls.from_list([*pt1, *pt2])

    def to_xywh_list(self) -> list[list[int]]:
        return [[(self.x1 + self.x2) // 2, (self.y1 + self.y2) // 2],
                [(self.x2 - self.x1) // 2, (self.y2 - self.y1) // 2]]


@dataclasses.dataclass
class RuntimeParams:
    fps: float
    exp_frame: int
    eq_fps: float
    eq_int_fps: int
    exp_time: float
    runtime_size: list[int]
    raw_size: list[int]
    positive_category_list: list[str]


# --------------------------------------------------------------------------
# MDRF result records
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BasicInfo(DictAble):
    loader: str
    video: str
    mask: Optional[str]
    start_time: int
    end_time: int
    resolution: list[int]
    runtime_resolution: list[int]
    exp_time: float
    total_frames: int
    fps: float
    desc: Optional[str] = None


@dataclasses.dataclass
class SimpleTarget:
    pt1: list[int]
    pt2: list[int]
    preds: Optional[str] = None
    prob: Optional[str] = None

    def to_json(self) -> dict[str, Any]:
        bbox = Box.from_pts(self.pt1, self.pt2)
        return {
            "label": self.preds,
            "points": [[bbox.x1, bbox.y1], [bbox.x2, bbox.y2]],
            "group_id": None,
            "description": "",
            "shape_type": "rectangle",
            "flags": {},
            "mask": None,
        }


@dataclasses.dataclass
class MDTarget(DictAble):
    """A single detected target (reference MetLib/metstruct.py:142-183)."""
    start_frame: int
    start_time: str
    end_time: str
    last_activate_frame: int
    last_activate_time: str
    duration: int
    speed: float
    dist: float
    fix_dist: float
    fix_speed: float
    fix_motion_duration: float
    fix_duration: float
    num_pts: int
    category: str
    pt1: list[int]
    pt2: list[int]
    drct_loss: float
    score: float
    real_dist: float
    center_point_list: list[list[int]] = dataclasses.field(default_factory=list)
    raw_score: Optional[float] = None
    recheck_score: Optional[float] = None
    relative_brightness: Optional[float] = None
    aesthetic_score: Optional[float] = None
    exclude_attrs: list[str] = dataclasses.field(
        default_factory=lambda: ["center_point_list"])

    def to_simple_target(self) -> SimpleTarget:
        return SimpleTarget(pt1=self.pt1, pt2=self.pt2, preds=self.category,
                            prob=str(round(self.score, 2)))


@dataclasses.dataclass
class SingleMDRecord(DictAble):
    """A record covering one clip, with its targets
    (reference MetLib/metstruct.py:186-246)."""
    start_time: str
    end_time: str
    video_size: list[int]
    target: list[MDTarget]
    start_frame: Optional[int] = None
    end_frame: Optional[int] = None

    @classmethod
    def from_target(cls, target: MDTarget, video_size: list[int]):
        return cls.from_target_list([target], video_size)

    @classmethod
    def from_target_list(cls, target_list: list[MDTarget],
                         video_size: list[int]):
        return cls(
            start_frame=min(t.start_frame for t in target_list),
            start_time=min(t.start_time for t in target_list),
            end_time=max(t.last_activate_time for t in target_list),
            end_frame=max(t.last_activate_frame for t in target_list),
            video_size=video_size,
            target=target_list,
        )

    def to_video_data(self, fps: Optional[float] = None,
                      video_size: Optional[list[int]] = None):
        return VideoFrameData(
            start_time=self.start_time,
            end_time=self.end_time,
            video_size=video_size,
            target_list=[t.to_simple_target() for t in self.target])

    def to_image_data(self):
        raise ValueError("SingleMDRecord cannot become ImageFrameData.")


@dataclasses.dataclass
class SingleImgRecord(DictAble):
    """Per-image detection record (reference MetLib/metstruct.py:249-313)."""
    boxes: list[list[int]]
    preds: list[str]
    prob: list[str]
    img_filename: Optional[str] = None
    img_size: Optional[list[int]] = None
    num_frame: Optional[int] = None

    def build_target_list(self) -> list[SimpleTarget]:
        return [SimpleTarget(pt1=list(b[:2]), pt2=list(b[2:]), preds=p, prob=pr)
                for b, p, pr in zip(self.boxes, self.preds, self.prob)]

    @staticmethod
    def _frame2ts(frame: int, fps: float) -> str:
        return datetime.datetime.strftime(
            datetime.datetime.fromtimestamp(frame / fps,
                                            tz=datetime.timezone.utc),
            "%H:%M:%S.%f")[:-3]

    def to_video_data(self, fps: Optional[float] = None,
                      video_size: Optional[list[int]] = None):
        if self.num_frame is None:
            raise ValueError("convert failed because num_frame is None.")
        assert fps is not None
        return VideoFrameData(start_time=self._frame2ts(self.num_frame, fps),
                              end_time=self._frame2ts(self.num_frame + 1, fps),
                              video_size=video_size,
                              target_list=self.build_target_list())

    def to_image_data(self):
        if self.img_filename is None:
            raise ValueError("convert failed because img_filename is None.")
        return ImageFrameData(img_filename=self.img_filename,
                              target_list=self.build_target_list(),
                              img_size=self.img_size,
                              saved_filename=self.img_filename)


# --------------------------------------------------------------------------
# Config dataclasses (schema parity with config/*.json)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class MockVideoObject(DictAble):
    video: Optional[str] = None
    image_folder: Optional[str] = None
    resolution: Optional[list[int]] = None

    def summary(self):
        return self


@dataclasses.dataclass
class LoaderCfg(DictAble):
    name: str
    wrapper: str
    resize: Union[list[int], int, str, None]
    exp_time: Union[float, str]
    merge_func: str
    grayscale: bool
    upper_bound: Optional[float] = None
    continue_on_err: bool = False
    hwaccel: Optional[str] = None


@dataclasses.dataclass
class ModelCfg(DictAble):
    name: str
    weight_path: str
    dtype: str
    nms: bool
    warmup: bool
    pos_thre: float
    nms_thre: float
    multiscale_pred: int
    multiscale_partition: int
    providers_key: Optional[str] = "default"
    # model input resolution "HxW"; None keeps the runtime default. The
    # reference bakes the shape into its ONNX file; flax weights are
    # fully-convolutional so the run size is a config choice.
    input_hw: Optional[str] = None


@dataclasses.dataclass
class BinaryCoreCfg(DictAble):
    adaptive_bi_thre: bool
    init_value: int
    sensitivity: str
    area: float
    interval: int


@dataclasses.dataclass
class HoughLineCfg(DictAble):
    threshold: int
    min_len: int
    max_gap: int


@dataclasses.dataclass
class DynamicCfg(DictAble):
    dy_mask: bool
    window_sec: float


@dataclasses.dataclass
class BinaryCfg(DictAble):
    binary: BinaryCoreCfg
    hough_line: HoughLineCfg
    dynamic: DynamicCfg


@dataclasses.dataclass
class DLCfg(DictAble):
    model: ModelCfg


@dataclasses.dataclass
class DetectorCfg(DictAble):
    name: str
    window_sec: float
    cfg: Union[BinaryCfg, DLCfg]


@dataclasses.dataclass
class MeteorCfg(DictAble):
    min_len: float
    max_interval: float
    time_range: list[float]
    speed_range: list[float]
    drct_range: list[float]
    det_thre: float
    thre2: int


@dataclasses.dataclass
class RecheckCfg(DictAble):
    switch: bool
    model: ModelCfg


@dataclasses.dataclass
class CollectorCfg(DictAble):
    meteor_cfg: MeteorCfg
    recheck_cfg: RecheckCfg
    positive_cfg: dict[str, Any]


@dataclasses.dataclass
class MainDetectCfg(DictAble):
    loader: LoaderCfg
    detector: DetectorCfg
    collector: CollectorCfg


@dataclasses.dataclass
class MDRF(DictAble):
    """Meteor Detection Recording Format
    (reference MetLib/metstruct.py:428-441)."""
    version: str
    basic_info: Union[BasicInfo, MockVideoObject]
    config: Optional[MainDetectCfg]
    type: str
    anno_size: Optional[list[int]]
    results: Union[list[SingleMDRecord], list[SingleImgRecord]]
    performance: Optional[dict[str, Union[float, str, None]]] = None


# --------------------------------------------------------------------------
# ClipToolkit structures (reference MetLib/metstruct.py:444-649)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FilterRules:
    switch: bool = True
    threshold: float = 0.0
    min_length_ratio: float = 0.0
    exclude_category_list: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClipPaddingOption:
    before: float = 0.0
    after: float = 0.0


@dataclasses.dataclass
class FFMpegConfig:
    path: Optional[str]
    preset: str = "slow"
    crf: int = 18
    video_encoder: str = "libx264"
    pix_fmt: str = "yuv420p"
    ffmpeg_path: Optional[str] = None
    ffprobe_path: Optional[str] = None


@dataclasses.dataclass
class ExportOption:
    positive_category_list: list[str] = dataclasses.field(
        default_factory=lambda: ["METEOR", "RED_SPRITE"])
    bbox_color_mapping: Optional[dict[str, list[int]]] = None
    filter_rules: FilterRules = dataclasses.field(default_factory=FilterRules)
    jpg_quality: int = 95
    png_compressing: int = 3
    with_bbox: bool = False
    with_annotation: bool = False
    bbox_color: list[int] = dataclasses.field(default_factory=lambda: [255, 0, 0])
    bbox_thickness: int = 2
    clip_padding: ClipPaddingOption = dataclasses.field(
        default_factory=ClipPaddingOption)
    ffmpeg_config: FFMpegConfig = dataclasses.field(
        default_factory=lambda: FFMpegConfig(path=None))


@dataclasses.dataclass
class ConnectParam:
    switch: bool
    ksize_multiplier: float
    gamma: float
    threshold: int


@dataclasses.dataclass
class SimpleDenoiseParam:
    ds_radius: int
    ds_threshold: int
    bi_d: int
    bi_sigma_color: int
    bi_sigma_space: int


@dataclasses.dataclass
class MFNRDenoiseParam:
    bg_algorithm: str
    sigma_high: float
    sigma_low: float
    bg_fix_factor: float


@dataclasses.dataclass
class DenoiseOption:
    switch: bool
    highlight_preserve: float
    algorithm: str
    blur_ksize: int
    connect_lines: ConnectParam
    simple_param: SimpleDenoiseParam
    mfnr_param: MFNRDenoiseParam


@dataclasses.dataclass
class RawImgLoadCfg:
    power: float
    target_nl_mean: float
    contrast_alpha: float
    output_bps: int


@dataclasses.dataclass
class ClipCfg(DictAble):
    loader: str
    wrapper: str
    writer: str
    image_denoise: DenoiseOption
    export: ExportOption
    raw_img_load_config: Optional[RawImgLoadCfg]


@dataclasses.dataclass
class ClipRequest(DictAble):
    time: list[str]
    filename: Optional[str] = None
    target: Optional[list[dict[str, Any]]] = None

    def cvt_tgt(self) -> Optional[list[SimpleTarget]]:
        if self.target is None:
            return None
        return [from_dict(SimpleTarget, t) for t in self.target]

    def to_video_data(self):
        return VideoFrameData(start_time=self.time[0], end_time=self.time[1],
                              target_list=self.cvt_tgt(), video_size=None,
                              saved_filename=self.filename)


@dataclasses.dataclass
class ImageFrameData:
    img_filename: str
    target_list: list[SimpleTarget]
    img_size: Union[list[int], tuple[int, ...], None] = None
    saved_filename: Optional[str] = None

    def to_labelme(self) -> dict[str, Any]:
        w, h = (self.img_size if self.img_size and len(self.img_size) == 2
                else (None, None))
        if not self.saved_filename:
            raise FileNotFoundError("labelme export requires a filename.")
        return {
            "version": "5.5.0", "flags": {}, "imagePath": self.saved_filename,
            "shapes": [t.to_json() for t in self.target_list],
            "imageData": None, "imageHeight": h, "imageWidth": w,
        }


@dataclasses.dataclass
class VideoFrameData:
    start_time: Optional[str]
    end_time: Optional[str]
    target_list: Optional[list[SimpleTarget]] = None
    video_size: Union[list[int], tuple[int, ...], None] = None
    saved_filename: Optional[str] = None

    def to_labelme(self) -> dict[str, Any]:
        w, h = (self.video_size if self.video_size and len(self.video_size) == 2
                else (None, None))
        if not self.saved_filename:
            raise FileNotFoundError("labelme export requires a filename.")
        return {
            "version": "5.5.0", "flags": {}, "imagePath": self.saved_filename,
            "shapes": ([t.to_json() for t in self.target_list]
                       if self.target_list else None),
            "imageData": None, "imageHeight": h, "imageWidth": w,
        }
