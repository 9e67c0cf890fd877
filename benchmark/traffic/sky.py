"""The night-sky clip generator: a noisy star field with meteor streaks
(an afterglow that decays behind the head) and plane-like lights, made on
the device from a seed and copied once into host memory.

A plain PyTorch rewrite of ``metdetpy_tpu_torch/synth.py``'s sky model
(``generate_meteor_video``: background 12, Gaussian stars, a head drawn as
Gaussian dots along its step, glow decay exp(-1 / (fps * decay_sec)) a
frame, planes as blinking dots without glow, Gaussian noise, clip to
[0, 255] and truncate to uint8). It imports nothing of the program. Every
traffic parameter comes from the mix's file; meteor and plane times and
tracks are drawn from the seed inside the ranges the file gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 32  # frames rendered at a time


def _rng(seed: int, feed: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), feed, 0x5C7])


def _torch_seed(seed: int, feed: int) -> int:
    return (int(seed) * 1000003 + feed * 7919 + 17) % (2**63 - 1)


def _track(rng, w: int, h: int, length: float):
    """Two points ``length`` px apart, both inside the frame's central
    90%, in a direction drawn from the seed."""
    lo_x, hi_x, lo_y, hi_y = 0.05 * w, 0.95 * w, 0.05 * h, 0.95 * h
    length = min(length, 0.85 * math.hypot(hi_x - lo_x, hi_y - lo_y))
    while True:
        ang = rng.uniform(0, 2 * math.pi)
        x0, y0 = rng.uniform(lo_x, hi_x), rng.uniform(lo_y, hi_y)
        x1, y1 = x0 + length * math.cos(ang), y0 + length * math.sin(ang)
        if lo_x <= x1 <= hi_x and lo_y <= y1 <= hi_y:
            return (x0, y0), (x1, y1)


def scene(params: dict, seed: int, feed: int = 0) -> dict:
    """Everything the seed decides of one feed's clip, on the host."""
    w, h, fps = int(params["width"]), int(params["height"]), float(params["fps"])
    seconds = float(params["seconds"])
    rng = _rng(seed, feed)
    n_stars = int(params["stars"])
    stars = dict(x=rng.uniform(0, w, n_stars), y=rng.uniform(0, h, n_stars),
                 amp=rng.uniform(*params["star_amp"], n_stars),
                 sigma=rng.uniform(*params["star_sigma"], n_stars))
    diag = math.hypot(w, h)
    meteors = []
    for _ in range(int(params["meteors"])):
        dur = rng.uniform(*params["meteor_seconds"])
        lo, hi = params["meteor_start_s"]
        start = rng.uniform(lo, max(lo, min(hi, seconds - dur - 1.0)))
        pt1, pt2 = _track(rng, w, h,
                          rng.uniform(*params["meteor_length_frac"]) * diag)
        meteors.append(dict(start=start, end=start + dur, pt1=pt1, pt2=pt2,
                            brightness=rng.uniform(*params["meteor_brightness"]),
                            width=float(params["meteor_width"])))
    planes = []
    for _ in range(int(params.get("planes", 0))):
        dur = rng.uniform(*params["plane_seconds"])
        start = rng.uniform(-dur, seconds)  # some cross the clip's ends
        pt1, pt2 = _track(rng, w, h, rng.uniform(0.3, 0.8) * diag)
        blink = rng.uniform() < float(params.get("plane_blink_share", 0.5))
        planes.append(dict(start=start, end=start + dur, pt1=pt1, pt2=pt2,
                           brightness=float(params.get("plane_brightness", 180)),
                           sigma=1.3, blink_hz=1.0 if blink else 0.0,
                           duty=0.6))
    return dict(w=w, h=h, fps=fps, n_frames=int(round(seconds * fps)),
                stars=stars, meteors=meteors, planes=planes,
                noise_sigma=float(params["noise_sigma"]),
                background=float(params["background"]),
                decay=math.exp(-1.0 / (fps * float(params["decay_sec"]))),
                color=bool(params["color"]))


def _dots(img: torch.Tensor, xs, ys, amps, sigmas) -> None:
    """img = max(img, Gaussian dots), each drawn over its 3-sigma square as
    ``synth._draw_gaussian_dot`` draws it."""
    if len(xs) == 0:
        return
    h, w = img.shape
    dev = img.device
    x = torch.as_tensor(np.asarray(xs, np.float64), device=dev)
    y = torch.as_tensor(np.asarray(ys, np.float64), device=dev)
    a = torch.as_tensor(np.asarray(amps, np.float64), device=dev)
    s = torch.as_tensor(np.asarray(sigmas, np.float64), device=dev)
    r = (3 * s).floor().long() + 1
    rmax = int(r.max())
    off = torch.arange(-rmax, rmax + 1, device=dev)
    px = x.floor().long()[:, None] + off[None, :]          # [n, P]
    py = y.floor().long()[:, None] + off[None, :]
    okx = (off.abs()[None, :] <= r[:, None]) & (px >= 0) & (px < w)
    oky = (off.abs()[None, :] <= r[:, None]) & (py >= 0) & (py < h)
    gx = torch.exp(-((px - x[:, None]) ** 2) / (2 * s[:, None] ** 2))
    gy = torch.exp(-((py - y[:, None]) ** 2) / (2 * s[:, None] ** 2))
    val = (a[:, None, None] * gy[:, :, None] * gx[:, None, :]).float()
    ok = oky[:, :, None] & okx[:, None, :]
    idx = (py.clamp(0, h - 1)[:, :, None] * w + px.clamp(0, w - 1)[:, None, :])
    flat = img.view(-1)
    flat.scatter_reduce_(0, idx[ok], val[ok], reduce="amax")


def _head_dots(m: dict, tsec: float, fps: float):
    dur = m["end"] - m["start"]
    frac0 = (tsec - m["start"]) / dur
    frac1 = min(1.0, frac0 + 1.0 / (fps * dur))
    (ax, ay), (bx, by) = m["pt1"], m["pt2"]
    x0, y0 = ax + (bx - ax) * frac0, ay + (by - ay) * frac0
    x1, y1 = ax + (bx - ax) * frac1, ay + (by - ay) * frac1
    steps = max(int(math.hypot(x1 - x0, y1 - y0)) * 2, 2)
    k = np.arange(steps) / (steps - 1)
    return (x0 + (x1 - x0) * k, y0 + (y1 - y0) * k,
            np.full(steps, m["brightness"]), np.full(steps, m["width"] * 0.8))


def render(sc: dict, seed: int, feed: int, device, out: np.ndarray) -> None:
    """Render the feed's frames on ``device`` into ``out`` ([T, H, W] or
    [T, H, W, 3] uint8 host memory), CHUNK frames at a time."""
    w, h, fps = sc["w"], sc["h"], sc["fps"]
    gen = torch.Generator(device=device).manual_seed(_torch_seed(seed, feed))
    bg = torch.full((h, w), sc["background"], dtype=torch.float32,
                    device=device)
    st = sc["stars"]
    _dots(bg, st["x"], st["y"], st["amp"], st["sigma"])
    glow = torch.zeros((h, w), dtype=torch.float32, device=device)
    glow_on = False
    host = torch.from_numpy(out)
    for a in range(0, sc["n_frames"], CHUNK):
        n = min(CHUNK, sc["n_frames"] - a)
        chunk = torch.randn((n, h, w), generator=gen, device=device,
                            dtype=torch.float32)
        chunk.mul_(sc["noise_sigma"]).add_(bg)
        for i in range(n):
            tsec = (a + i) / fps
            heads = [_head_dots(m, tsec, fps) for m in sc["meteors"]
                     if m["start"] <= tsec <= m["end"]]
            for xs, ys, amps, sig in heads:
                _dots(glow, xs, ys, amps, sig)
                glow_on = True
            lights = []
            for p in sc["planes"]:
                if not p["start"] <= tsec <= p["end"]:
                    continue
                if (p["blink_hz"] > 0
                        and (tsec * p["blink_hz"]) % 1.0 > p["duty"]):
                    continue
                frac = (tsec - p["start"]) / (p["end"] - p["start"])
                (ax, ay), (bx, by) = p["pt1"], p["pt2"]
                lights.append((ax + (bx - ax) * frac, ay + (by - ay) * frac,
                               p["brightness"], p["sigma"]))
            if not (glow_on or lights):
                continue
            frame = torch.maximum(bg, glow) if glow_on else bg.clone()
            if glow_on:
                glow.mul_(sc["decay"])
            if lights:
                _dots(frame, *zip(*lights))
            chunk[i].add_(frame - bg)
        u8 = chunk.clamp_(0, 255).to(torch.uint8)
        if sc["color"]:
            u8 = u8[..., None].expand(n, h, w, 3)
        host[a:a + n].copy_(u8)
        del chunk, u8


def make(params: dict, seed: int, device) -> list[np.ndarray]:
    """One host clip per feed: [T, H, W] uint8 gray, or [T, H, W, 3] colour,
    every page written once."""
    clips = []
    for feed in range(int(params.get("feeds", 1))):
        sc = scene(params, seed, feed)
        shape = (sc["n_frames"], sc["h"], sc["w"]) + ((3,) if sc["color"]
                                                      else ())
        out = np.empty(shape, dtype=np.uint8)
        render(sc, seed, feed, torch.device(device), out)
        clips.append(out)
    return clips
