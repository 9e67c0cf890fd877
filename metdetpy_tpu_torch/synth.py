"""Synthetic night-sky fixture generator.

The reference's canonical test clip (test/20220413Red.mp4) and its weights
are Git-LFS pointers absent from the mount (SURVEY.md §4, §6); this module
generates annotated synthetic fixtures: a noisy starfield with one or more
meteor streaks moving over a time window, matching the annotation schema of
test/20220413_annotation.json.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np


@dataclasses.dataclass
class SynthMeteor:
    """One synthetic meteor event."""
    start_sec: float
    end_sec: float
    pt1: tuple[int, int]  # (x, y) at start
    pt2: tuple[int, int]  # (x, y) at end
    brightness: int = 230
    width: int = 2
    decay_sec: float = 0.35  # afterglow decay constant


@dataclasses.dataclass
class SynthPlane:
    """A plane/satellite-like distractor: a slow point light crossing the
    frame for many seconds, optionally blinking (strobe), leaving no
    afterglow trail. Correct detectors must NOT label these METEOR
    (collector trapezoid scoring: duration past time_range, slow
    fix_speed; reference collector.py:591-615)."""
    start_sec: float
    end_sec: float
    pt1: tuple[int, int]
    pt2: tuple[int, int]
    brightness: int = 180
    sigma: float = 1.3
    blink_hz: float = 1.0   # 0 disables blinking
    blink_duty: float = 0.6


@dataclasses.dataclass
class SynthCloud:
    """A drifting low-frequency luminance blob with slow flicker --
    models moonlit cloud edges that fool area-based thresholds."""
    center: tuple[int, int]
    sigma: float = 60.0
    amplitude: float = 26.0
    drift_px_per_sec: tuple[float, float] = (4.0, 1.0)
    flicker_hz: float = 0.15


def _draw_gaussian_dot(img: np.ndarray, x: float, y: float, amp: float,
                       sigma: float) -> None:
    h, w = img.shape
    r = int(3 * sigma) + 1
    x0, y0 = int(x), int(y)
    xs = np.arange(max(0, x0 - r), min(w, x0 + r + 1))
    ys = np.arange(max(0, y0 - r), min(h, y0 + r + 1))
    if len(xs) == 0 or len(ys) == 0:
        return
    gx = np.exp(-((xs - x) ** 2) / (2 * sigma ** 2))
    gy = np.exp(-((ys - y) ** 2) / (2 * sigma ** 2))
    patch = amp * gy[:, None] * gx[None, :]
    region = img[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
    np.maximum(region, patch, out=region)


def generate_meteor_video(width: int = 960, height: int = 540,
                          fps: float = 25.0, duration_sec: float = 8.0,
                          meteors: list[SynthMeteor] | None = None,
                          n_stars: int = 120, noise_sigma: float = 4.0,
                          seed: int = 7, color: bool = False,
                          planes: list[SynthPlane] | None = None,
                          clouds: list[SynthCloud] | None = None
                          ) -> np.ndarray:
    """Render a [T, H, W] (or [T, H, W, 3]) uint8 synthetic sky video."""
    rng = np.random.default_rng(seed)
    if meteors is None:
        meteors = [SynthMeteor(start_sec=2.4, end_sec=4.4,
                               pt1=(int(width * 0.45), int(height * 0.25)),
                               pt2=(int(width * 0.30), int(height * 0.55)))]
    n_frames = int(round(duration_sec * fps))

    # static background: dark sky + fixed stars
    bg = np.full((height, width), 12.0, dtype=np.float32)
    star_x = rng.uniform(0, width, n_stars)
    star_y = rng.uniform(0, height, n_stars)
    star_amp = rng.uniform(20, 140, n_stars)
    star_sigma = rng.uniform(0.7, 1.6, n_stars)
    for x, y, a, s in zip(star_x, star_y, star_amp, star_sigma):
        _draw_gaussian_dot(bg, x, y, a, s)

    frames = np.empty((n_frames, height, width), dtype=np.uint8)
    glow = np.zeros((height, width), dtype=np.float32)
    for t in range(n_frames):
        tsec = t / fps
        frame = bg.copy()
        # meteor head: advance along the trajectory, leaving decaying glow
        for m in meteors:
            if m.start_sec <= tsec <= m.end_sec:
                frac0 = (tsec - m.start_sec) / (m.end_sec - m.start_sec)
                frac1 = min(1.0, frac0 + 1.0 / (fps * (m.end_sec
                                                       - m.start_sec)))
                x0 = m.pt1[0] + (m.pt2[0] - m.pt1[0]) * frac0
                y0 = m.pt1[1] + (m.pt2[1] - m.pt1[1]) * frac0
                x1 = m.pt1[0] + (m.pt2[0] - m.pt1[0]) * frac1
                y1 = m.pt1[1] + (m.pt2[1] - m.pt1[1]) * frac1
                steps = max(int(math.hypot(x1 - x0, y1 - y0)) * 2, 2)
                for k in range(steps):
                    a = k / (steps - 1)
                    _draw_gaussian_dot(glow, x0 + (x1 - x0) * a,
                                       y0 + (y1 - y0) * a, m.brightness,
                                       m.width * 0.8)
        frame = np.maximum(frame, glow)
        # afterglow decay
        if meteors:
            glow *= math.exp(-1.0 / (fps * meteors[0].decay_sec))
        for p in (planes or []):
            if p.start_sec <= tsec <= p.end_sec:
                if p.blink_hz > 0:
                    phase = (tsec * p.blink_hz) % 1.0
                    if phase > p.blink_duty:
                        continue
                frac = (tsec - p.start_sec) / (p.end_sec - p.start_sec)
                px = p.pt1[0] + (p.pt2[0] - p.pt1[0]) * frac
                py = p.pt1[1] + (p.pt2[1] - p.pt1[1]) * frac
                _draw_gaussian_dot(frame, px, py, p.brightness, p.sigma)
        for c in (clouds or []):
            cx = c.center[0] + c.drift_px_per_sec[0] * tsec
            cy = c.center[1] + c.drift_px_per_sec[1] * tsec
            amp = c.amplitude * (0.75 + 0.25 * math.sin(
                2 * math.pi * c.flicker_hz * tsec))
            _draw_gaussian_dot(frame, cx, cy, amp, c.sigma)
        noise = rng.normal(0, noise_sigma, (height, width)).astype(np.float32)
        frames[t] = np.clip(frame + noise, 0, 255).astype(np.uint8)
    if color:
        return np.repeat(frames[..., None], 3, axis=-1)
    return frames


def write_video(frames: np.ndarray, filename: str, fps: float = 25.0,
                quality: int = 100) -> None:
    """Encode frames to a video file via cv2 (mp4v / MJPG by extension)."""
    import cv2
    h, w = frames.shape[1:3]
    fourcc = cv2.VideoWriter_fourcc(*("mp4v" if filename.endswith(".mp4")
                                      else "MJPG"))
    writer = cv2.VideoWriter(filename, fourcc, fps, (w, h))
    assert writer.isOpened(), f"cannot open video writer for {filename}"
    writer.set(cv2.VIDEOWRITER_PROP_QUALITY, quality)
    for frame in frames:
        if frame.ndim == 2:
            frame = cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
        writer.write(frame)
    writer.release()


def default_annotation(width: int = 960, height: int = 540) -> dict:
    """Annotation matching generate_meteor_video defaults, in the schema of
    the reference test/20220413_annotation.json."""
    return {
        "video": "synthetic.mp4",
        "mask": None,
        "anno_size": [width, height],
        "meteors": [{
            "start_time": "00:00:02.400000",
            "end_time": "00:00:04.400000",
            "pt1": [int(width * 0.45), int(height * 0.25)],
            "pt2": [int(width * 0.30), int(height * 0.55)],
        }],
    }


def write_annotated_clip(directory: str, width: int = 256, height: int = 144,
                         fps: float = 25.0) -> str:
    """Write the annotated clip of the F1 checks into ``directory``: a
    6.5 s MJPG AVI (``synth.avi``) of 40 stars and noise sigma 3 with one
    meteor from 2.4 s to 4.4 s, and its ground truth as an MDRF of type
    ``annotation`` (``anno.json``, the video named relative to it, as
    ``evaluate`` reads it). Returns the annotation's path."""
    from .utils import frame2ts
    pt1 = (int(width * 0.45), int(height * 0.25))
    pt2 = (int(width * 0.30), int(height * 0.55))
    frames = generate_meteor_video(
        width=width, height=height, fps=fps, duration_sec=6.5,
        meteors=[SynthMeteor(start_sec=2.4, end_sec=4.4, pt1=pt1, pt2=pt2)],
        n_stars=40, noise_sigma=3.0)
    os.makedirs(directory, exist_ok=True)
    write_video(frames, os.path.join(directory, "synth.avi"), fps=fps)
    sf, ef = int(2.4 * fps), int(4.4 * fps)
    target = {
        "start_frame": sf, "start_time": frame2ts(sf, fps),
        "end_time": frame2ts(ef, fps), "last_activate_frame": ef,
        "last_activate_time": frame2ts(ef, fps), "duration": ef - sf + 1,
        "speed": 1.0, "dist": 50.0, "fix_dist": 20.0, "fix_speed": 10.0,
        "fix_motion_duration": 2.0, "fix_duration": 2.0, "num_pts": 2,
        "category": "METEOR", "pt1": list(pt1), "pt2": list(pt2),
        "drct_loss": 0.0, "score": 1.0, "real_dist": 50.0,
    }
    anno = {
        "version": "anno", "basic_info": {
            "loader": "none", "video": "synth.avi", "mask": None,
            "start_time": 0, "end_time": int(6500 / fps * 1000),
            "resolution": [width, height],
            "runtime_resolution": [width, height], "exp_time": 1 / fps,
            "total_frames": int(6.5 * fps), "fps": fps,
        },
        "config": None, "type": "annotation", "anno_size": [width, height],
        "results": [{
            "start_time": frame2ts(sf, fps), "end_time": frame2ts(ef, fps),
            "video_size": [width, height], "target": [target],
            "start_frame": sf, "end_frame": ef,
        }],
    }
    path = os.path.join(directory, "anno.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(anno, f)
    return path
