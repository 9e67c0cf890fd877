"""PyTorch port's video writers (``metdetpy_tpu_torch/io/videowriter.py``,
a copy of the JAX package's host module) against the JAX package's.

- ``get_writer`` resolves every writer of the registry.
- The OpenCV writer's MJPG AVI equals the JAX writer's, frame for frame
  once decoded (by stream and with the audio-less ``save_video_with_audio``).
- The ffmpeg writer builds the same commands as the JAX writer, against
  recording fake ``ffmpeg``/``ffprobe`` binaries (the model of
  ``tests/test_videowriter_ffmpeg.py``); the PyAV writer makes the same
  calls on a recording fake ``av`` module.
- Where ffmpeg/ffprobe or PyAV are not installed, each writer falls back
  to the next (the reference's availability rule): the output equals the
  OpenCV writer's.
"""

import json
import stat
import sys
import types

import cv2
import numpy as np
import pytest

from metdetpy_tpu.io import videowriter as jvw
from metdetpy_tpu.structs import ExportOption as JExportOption
from metdetpy_tpu_torch import get_writer
from metdetpy_tpu_torch.io import videowriter as pvw
from metdetpy_tpu_torch.log import BaseMetLog
from metdetpy_tpu_torch.structs import ExportOption

FPS = 25.0


def _frames(n=12, h=48, w=64, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, h, w, 3), np.uint8)
    for t in range(n):
        cv2.circle(frames[t], (8 + 4 * t, 20), 3, (250, 240, 230), -1)
    return frames


def _decode(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out) if out else np.zeros((0,))


def test_get_writer_resolves_every_writer():
    for name in ("BaseVideoWriter", "OpenCVVideoWriter", "PyAVVideoWriter",
                 "FFMpegVideoWriter"):
        cls = get_writer(name)
        assert cls.__name__ == name and cls is getattr(pvw, name)
    with pytest.raises(Exception, match="No class named"):
        get_writer("NoSuchWriter")


def test_series_loader_matches_jax():
    frames = list(_frames(5))
    got, want = pvw.SeriesLoader(frames, FPS), jvw.SeriesLoader(frames, FPS)
    assert got.iterations == want.iterations == 5
    assert got.runtime_size == want.runtime_size == [64, 48]
    got.start()
    want.start()
    for _ in range(6):
        a, b = got.pop(), want.pop()
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("gray", [False, True])
def test_opencv_writer_avi_equals_jax(tmp_path, gray):
    frames = _frames()
    if gray:
        frames = frames[..., 0].copy()
    paths = {}
    for name, mod, opt in (("jax", jvw, JExportOption()),
                           ("port", pvw, ExportOption())):
        paths[name] = tmp_path / f"{name}.avi"
        rc = mod.OpenCVVideoWriter.save_video(list(frames), FPS, opt,
                                              str(paths[name]))
        assert rc == 0
    got, want = _decode(paths["port"]), _decode(paths["jax"])
    assert got.shape == want.shape and got.shape[0] == len(frames)
    np.testing.assert_array_equal(got, want)


def test_opencv_writer_refuses_other_suffix(tmp_path):
    assert pvw.OpenCVVideoWriter.save_video(
        list(_frames(2)), FPS, ExportOption(), str(tmp_path / "x.mp4")) == -1


def test_save_with_audio_without_ffmpeg_equals_jax(tmp_path):
    """The base writer's audio path writes the video without audio, as the
    JAX package's does."""
    frames = list(_frames())
    paths = {}
    for name, mod, opt in (("jax", jvw, JExportOption()),
                           ("port", pvw, ExportOption())):
        paths[name] = tmp_path / f"{name}.avi"
        loader = mod.SeriesLoader(frames, FPS)
        assert mod.OpenCVVideoWriter.save_video_with_audio(
            frames, loader, opt, str(paths[name])) == 0
    np.testing.assert_array_equal(_decode(paths["port"]),
                                  _decode(paths["jax"]))


def test_fallbacks_where_ffmpeg_and_pyav_are_absent(tmp_path, monkeypatch):
    """FFMpegVideoWriter falls back to PyAV, PyAV to OpenCV, when the
    binaries or the module are not installed: the reference's rule, and
    the outputs equal the OpenCV writer's (a .mp4 target becomes .avi)."""
    frames = list(_frames())
    opt = ExportOption()
    opt.ffmpeg_config.ffmpeg_path = str(tmp_path / "no" / "ffmpeg")
    opt.ffmpeg_config.ffprobe_path = str(tmp_path / "no" / "ffprobe")
    assert not pvw.FFMpegVideoWriter.available(opt)
    monkeypatch.setattr(pvw, "HAS_PYAV", False)
    ref = tmp_path / "ref.avi"
    assert pvw.OpenCVVideoWriter.save_video(frames, FPS, opt, str(ref)) == 0
    loader = pvw.SeriesLoader(frames, FPS, video_name="src.avi")
    assert pvw.FFMpegVideoWriter.save_video_by_stream(
        loader, opt, str(tmp_path / "ff.mp4")) == 0
    assert pvw.PyAVVideoWriter.save_video_by_stream(
        pvw.SeriesLoader(frames, FPS), opt, str(tmp_path / "av.mp4")) == 0
    for name in ("ff.avi", "av.avi"):
        np.testing.assert_array_equal(_decode(tmp_path / name), _decode(ref))


# -- ffmpeg against recording fakes (tests/test_videowriter_ffmpeg.py) ------

FFPROBE_SRC = r'''#!/usr/bin/env python3
import json, os, sys
argv = sys.argv[1:]
with open(os.environ["FAKE_LOG"], "a") as f:
    f.write(json.dumps(["ffprobe"] + argv) + "\n")
if "-version" in argv:
    sys.exit(0)
if "stream=codec_name" in argv:
    codec = os.environ.get("FAKE_AUDIO_CODEC", "")
    if codec:
        print(codec)
    sys.exit(0)
if "frame=key_frame,pkt_pts_time" in argv:
    interval = argv[argv.index("-read_intervals") + 1]
    lo, hi = (float(x) for x in interval.split("%"))
    kfs = [float(x) for x in os.environ.get("FAKE_KEYFRAMES", "").split(",")
           if x]
    for k in sorted(kfs):
        if lo <= k <= hi:
            print(f"0,{k + 0.01:.3f}")
            print(f"1,{k:.3f}")
    sys.exit(0)
sys.exit(0)
'''

FFMPEG_SRC = r'''#!/usr/bin/env python3
import json, os, sys
argv = sys.argv[1:]
with open(os.environ["FAKE_LOG"], "a") as f:
    f.write(json.dumps(["ffmpeg"] + argv) + "\n")
if "-version" in argv:
    sys.exit(0)
with open(argv[-1], "wb") as f:
    f.write(b"fake")
sys.exit(int(os.environ.get("FAKE_FFMPEG_RC", "0")))
'''


class _Loader:
    """Metadata-only loader stub (the ffmpeg path never decodes)."""

    def __init__(self, video_name, fps=25.0, start_frame=0, end_frame=250):
        self.video_name = video_name
        self.fps = fps
        self.start_frame = start_frame
        self.end_frame = end_frame

    def reset(self, start_frame=None, end_frame=None):
        pass


@pytest.fixture
def fake_bin(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, src in (("ffprobe", FFPROBE_SRC), ("ffmpeg", FFMPEG_SRC)):
        p = bindir / name
        p.write_text(src.replace("#!/usr/bin/env python3",
                                 f"#!{sys.executable}"))
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("FAKE_KEYFRAMES", "1.0,2.0,7.5")
    return bindir


def _recorded(tmp_path, monkeypatch, fake_bin, name, run):
    """Run ``run(option)`` against the fakes; returns (rc, calls) with the
    temporary paths of the call normalised."""
    log = tmp_path / f"{name}.jsonl"
    monkeypatch.setenv("FAKE_LOG", str(log))
    opt = (JExportOption if name == "jax" else ExportOption)()
    opt.ffmpeg_config.ffmpeg_path = str(fake_bin / "ffmpeg")
    opt.ffmpeg_config.ffprobe_path = str(fake_bin / "ffprobe")
    rc = run(opt, str(tmp_path / f"{name}_out.mp4"))
    calls = [json.loads(ln) for ln in log.read_text().splitlines()]
    norm = [[("<avi>" if a.endswith("clip.avi") else
              a.replace(f"{name}_out", "out")) for a in c] for c in calls]
    return rc, norm


@pytest.mark.parametrize("codec", ["aac", "opus", ""])
@pytest.mark.parametrize("flow", ["stream", "with_audio", "failing"])
def test_ffmpeg_commands_equal_jax(tmp_path, monkeypatch, fake_bin, codec,
                                   flow):
    monkeypatch.setenv("FAKE_AUDIO_CODEC", codec)
    monkeypatch.setenv("FAKE_FFMPEG_RC", "1" if flow == "failing" else "0")
    frames = [np.zeros((16, 16, 3), np.uint8) for _ in range(12)]
    out = {}
    for name, mod in (("jax", jvw), ("port", pvw)):
        def run(opt, path, mod=mod):
            loader = _Loader("source.mp4")
            if flow == "with_audio":
                return mod.FFMpegVideoWriter.save_video_with_audio(
                    frames, loader, opt, path, start_frame=50,
                    end_frame=62, logger=BaseMetLog())
            return mod.FFMpegVideoWriter.save_video_by_stream(
                loader, opt, path, start_frame=240, end_frame=300,
                logger=BaseMetLog())
        out[name] = _recorded(tmp_path, monkeypatch, fake_bin, name, run)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (-1 if flow == "failing" else 0)
    assert any(c[0] == "ffmpeg" and "-version" not in c
               for c in out["port"][1])


# -- PyAV against a recording fake module -------------------------------------

def _fake_av(calls):
    class Stream:
        def __init__(self, codec, rate):
            calls.append(("add_stream", codec, rate))

        def __setattr__(self, key, value):
            calls.append(("set", key, value))
            object.__setattr__(self, key, value)

        def encode(self, frame=None):
            calls.append(("encode", None if frame is None else frame.sum))
            return [] if frame is None else ["packet"]

    class Container:
        def add_stream(self, codec, rate):
            return Stream(codec, rate)

        def mux(self, packet):
            calls.append(("mux", packet))

        def close(self):
            calls.append(("close",))

    class VideoFrame:
        @staticmethod
        def from_ndarray(arr, format):
            frame = types.SimpleNamespace(sum=int(arr.sum()))
            calls.append(("frame", format, arr.shape))
            return frame

    def open_(path, mode):
        calls.append(("open", path.rsplit("/", 1)[-1], mode))
        return Container()

    return types.SimpleNamespace(open=open_, VideoFrame=VideoFrame)


def test_pyav_writer_calls_equal_jax(tmp_path, monkeypatch):
    frames = list(_frames(6))
    calls = {}
    for name, mod, opt in (("jax", jvw, JExportOption()),
                           ("port", pvw, ExportOption())):
        calls[name] = []
        monkeypatch.setattr(mod, "HAS_PYAV", True)
        monkeypatch.setattr(mod, "av", _fake_av(calls[name]), raising=False)
        rc = mod.PyAVVideoWriter.save_video_by_stream(
            mod.SeriesLoader(frames, FPS), opt, str(tmp_path / "out.mp4"))
        assert rc == 0
    assert calls["port"] == calls["jax"]
    assert sum(c[0] == "frame" for c in calls["port"]) == len(frames)
