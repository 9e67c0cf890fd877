"""Video writers for clip export (host code; a copy of the JAX package's
``io/videowriter.py``).

API parity with reference MetLib/videowriter.py:86-605:
``save_video`` / ``save_video_by_stream`` / ``save_video_with_audio`` class
methods, plus the ``SeriesLoader`` in-memory mock. Backends:

  - OpenCVVideoWriter: MJPG .avi via cv2 (always available).
  - PyAVVideoWriter: stream encode via PyAV (gated: without PyAV it falls
    back to OpenCV with a warning).
  - FFMpegVideoWriter: keyframe-accurate stream copy / transcode with audio
    via the ffmpeg/ffprobe binaries (gated on their presence: without them
    it falls back to PyAV, then OpenCV).

The fallbacks are the reference's availability rule (a codec library or
binary that is not installed), not a hidden failure: a writer that is
present and fails logs the error and returns -1, as in the reference.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Any, Optional, Sequence, Union

import cv2
import numpy as np

from ..log import BaseMetLog, get_useable_logger
from ..structs import ExportOption
from ..utils import frame2ts, transpose_wh

try:
    import av  # type: ignore
    HAS_PYAV = True
except ImportError:
    av = None
    HAS_PYAV = False

CONTAINER_AUDIO_ACCEPT = {
    "mp4": ["aac", "mp3", "ac3"],
    "m4a": ["aac", "mp3", "ac3"],
    "mov": ["aac", "mp3", "ac3", "pcm_s16le"],
    "mkv": ["aac", "mp3", "ac3", "vorbis", "opus", "flac", "pcm_s16le"],
    "webm": ["vorbis", "opus"],
    "avi": ["mp3", "pcm_s16le", "ac3"],
    "wav": ["pcm_s16le", "pcm_s24le", "flac"],
}


def _chk_exec(name: str) -> bool:
    try:
        return subprocess.run([name, "-version"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE).returncode == 0
    except Exception:
        return False


class SeriesLoader:
    """VideoLoader-shaped wrapper around an in-memory frame sequence
    (reference MetLib/videowriter.py:46-83)."""

    def __init__(self, video_series: Sequence[np.ndarray], fps: float,
                 video_name: Optional[str] = None) -> None:
        self.video_name = video_name
        self.video_series = video_series
        self.fps = fps
        self.cur_index = -1

    def pop(self):
        if self.cur_index >= self.iterations - 1:
            return None
        self.cur_index += 1
        return self.video_series[self.cur_index]

    def start(self):
        self.cur_index = -1

    def stop(self):
        pass

    def reset(self, start_frame=None, end_frame=None):
        pass

    @property
    def iterations(self) -> int:
        return len(self.video_series)

    @property
    def runtime_size(self):
        return transpose_wh(self.video_series[0].shape[:2])


class BaseVideoWriter:
    """Video writer contract; see module docstring."""

    @classmethod
    def save_video(cls, video_series: Sequence[np.ndarray],
                   fps: Union[int, float], export_option: ExportOption,
                   video_path: str, logger: Optional[BaseMetLog] = None,
                   *args: Any, **kwargs: Any) -> int:
        return cls.save_video_by_stream(SeriesLoader(video_series, fps),
                                        export_option, video_path,
                                        logger=logger)

    @classmethod
    def save_video_by_stream(cls, video_loader, export_option: ExportOption,
                             video_path: str,
                             start_frame: Optional[int] = None,
                             end_frame: Optional[int] = None,
                             logger: Optional[BaseMetLog] = None) -> int:
        raise NotImplementedError

    @classmethod
    def save_video_with_audio(cls, video_series, video_loader,
                              export_option: ExportOption, video_path: str,
                              start_frame: Optional[int] = None,
                              end_frame: Optional[int] = None,
                              logger: Optional[BaseMetLog] = None) -> int:
        logger = get_useable_logger(logger)
        logger.warning(f"{cls.__name__} cannot copy source audio; the output "
                       "video has no audio track.")
        return cls.save_video(video_series, video_loader.fps, export_option,
                              video_path, logger)


class OpenCVVideoWriter(BaseVideoWriter):
    """MJPG .avi writer (reference MetLib/videowriter.py:143-201)."""

    @classmethod
    def save_video_by_stream(cls, video_loader, export_option, video_path,
                             start_frame=None, end_frame=None,
                             logger=None) -> int:
        logger = get_useable_logger(logger)
        if start_frame is not None or end_frame is not None:
            video_loader.reset(start_frame=start_frame, end_frame=end_frame)
        if not video_path.lower().endswith("avi"):
            logger.fatal(f"{cls.__name__} only supports .avi output.")
            return -1
        writer = None
        try:
            video_loader.start()
            writer = cv2.VideoWriter(video_path,
                                     cv2.VideoWriter_fourcc(*"MJPG"),
                                     video_loader.fps,
                                     tuple(video_loader.runtime_size))
            for _ in range(video_loader.iterations):
                frame = video_loader.pop()
                if frame is None:
                    continue
                if frame.ndim == 2:
                    frame = cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
                writer.write(frame)
        except Exception as e:
            logger.error(f"Failed to save video {video_path}: {e!r}.")
            return -1
        finally:
            video_loader.stop()
            if writer:
                writer.release()
        return 0


class PyAVVideoWriter(BaseVideoWriter):
    """PyAV stream encoder (reference MetLib/videowriter.py:204-294); falls
    back to OpenCV when PyAV is unavailable."""

    @classmethod
    def save_video_by_stream(cls, video_loader, export_option, video_path,
                             start_frame=None, end_frame=None,
                             logger=None) -> int:
        logger = get_useable_logger(logger)
        if not HAS_PYAV:
            logger.warning("PyAV unavailable; falling back to "
                           "OpenCVVideoWriter (.avi).")
            if not video_path.lower().endswith("avi"):
                video_path = os.path.splitext(video_path)[0] + ".avi"
            return OpenCVVideoWriter.save_video_by_stream(
                video_loader, export_option, video_path, start_frame,
                end_frame, logger)
        if start_frame is not None or end_frame is not None:
            video_loader.reset(start_frame=start_frame, end_frame=end_frame)
        ff = export_option.ffmpeg_config
        try:
            video_loader.start()
            container = av.open(video_path, mode="w")
            w, h = video_loader.runtime_size
            stream = container.add_stream(
                ff.video_encoder.replace("lib", ""),
                rate=round(video_loader.fps))
            stream.width, stream.height = w, h
            stream.pix_fmt = ff.pix_fmt
            stream.options = {"crf": str(ff.crf), "preset": ff.preset}
            for _ in range(video_loader.iterations):
                frame = video_loader.pop()
                if frame is None:
                    continue
                vf = av.VideoFrame.from_ndarray(frame, format="bgr24")
                for packet in stream.encode(vf):
                    container.mux(packet)
            for packet in stream.encode():
                container.mux(packet)
            container.close()
        except Exception as e:
            logger.error(f"Failed to save video {video_path}: {e!r}.")
            return -1
        finally:
            video_loader.stop()
        return 0


class FFMpegVideoWriter(BaseVideoWriter):
    """ffmpeg/ffprobe subprocess writer with keyframe-accurate 2-stage seek
    and audio copy (reference MetLib/videowriter.py:297-605); degrades to
    the PyAV/OpenCV path when the binaries are absent."""

    @classmethod
    def _resolve_paths(cls, export_option: ExportOption):
        ff = export_option.ffmpeg_config
        ffmpeg = ff.ffmpeg_path or (os.path.join(ff.path, "ffmpeg")
                                    if ff.path else "ffmpeg")
        ffprobe = ff.ffprobe_path or (os.path.join(ff.path, "ffprobe")
                                      if ff.path else "ffprobe")
        return ffmpeg, ffprobe

    @classmethod
    def available(cls, export_option: ExportOption) -> bool:
        ffmpeg, ffprobe = cls._resolve_paths(export_option)
        return _chk_exec(ffmpeg) and _chk_exec(ffprobe)

    @classmethod
    def _get_audio_args(cls, ffprobe: str, src: str, tgt: str) -> list[str]:
        """Probe the source's first audio-stream codec; stream-copy it when
        the target container accepts that codec, else transcode to the
        container's preferred codec (reference MetLib/videowriter.py:
        335-365)."""
        codec = None
        try:
            proc = subprocess.run(
                [ffprobe, "-v", "error", "-select_streams", "a:0",
                 "-show_entries", "stream=codec_name", "-of",
                 "default=noprint_wrappers=1:nokey=1", src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                timeout=30)
            codec_str = proc.stdout.strip()
            if codec_str:
                codec = codec_str.splitlines()[0].strip()
        except Exception:
            pass
        audio_args = ["-c:a", "copy"]
        if codec is not None:
            accept = CONTAINER_AUDIO_ACCEPT.get(
                tgt.lower().rsplit(".", 1)[-1], ["aac"])
            if codec not in accept:
                audio_args = ["-c:a", accept[0], "-b:a", "192k"]
        return audio_args

    @classmethod
    def _estimate_k_frame(cls, ffprobe: str, video_name: str,
                          start_time: float, logger,
                          max_retry_cnt: int = 5) -> float:
        """Find the nearest previous I-frame timestamp before start_time,
        retrying with a doubling look-back window sliding toward 0, then
        falling back to the S-2s heuristic (reference
        MetLib/videowriter.py:367-413)."""
        rev_time = 2.0
        eps = 1e-6
        cur_start_time = start_time
        for attempt in range(max_retry_cnt):
            cmd = [ffprobe, "-v", "error", "-select_streams", "v:0",
                   "-show_entries", "frame=key_frame,pkt_pts_time",
                   "-read_intervals",
                   f"{max(0.0, cur_start_time - rev_time):.3f}"
                   f"%{cur_start_time:.3f}",
                   "-of", "csv=p=0", video_name]
            try:
                res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     timeout=30)
                parts = [[p.strip() for p in line.split(",") if p.strip()]
                         for line in res.stdout.splitlines() if line]
                ks = [float(p[1]) for p in parts
                      if len(p) >= 2 and p[0] == "1"
                      and float(p[1]) < start_time + eps]
                if ks:
                    return max(ks)
            except Exception:
                pass
            logger.warning(f"keyframe probe attempt "
                           f"{attempt + 1}/{max_retry_cnt} found nothing.")
            cur_start_time = cur_start_time - rev_time + eps
            rev_time *= 2
        logger.warning(
            "ffprobe failed to list keyframes; falling back to K=S-2s.")
        return max(0.0, start_time - 2.0)

    @classmethod
    def save_video_by_stream(cls, video_loader, export_option, video_path,
                             start_frame=None, end_frame=None,
                             logger=None) -> int:
        """Keyframe-accurate clip export: coarse seek to the previous
        I-frame (-ss K before -i), precise seek by S-K, video transcode +
        probed audio handling (reference MetLib/videowriter.py:464-532)."""
        logger = get_useable_logger(logger)
        video_name = getattr(video_loader, "video_name", None)
        if not cls.available(export_option) or not video_name:
            logger.warning("ffmpeg/ffprobe unavailable; falling back to "
                           "PyAV/OpenCV writer.")
            return PyAVVideoWriter.save_video_by_stream(
                video_loader, export_option, video_path, start_frame,
                end_frame, logger)
        ffmpeg, ffprobe = cls._resolve_paths(export_option)
        ff = export_option.ffmpeg_config
        fps = video_loader.fps
        s = (start_frame if start_frame is not None
             else video_loader.start_frame) / fps
        e = (end_frame if end_frame is not None
             else video_loader.end_frame) / fps
        k = cls._estimate_k_frame(ffprobe, video_name, s, logger)
        audio_args = cls._get_audio_args(ffprobe, video_name, video_path)
        cmd = [ffmpeg, "-ss", f"{k:.3f}", "-i", video_name,
               "-ss", f"{s - k:.3f}", "-t", f"{e - s:.3f}",
               "-c:v", ff.video_encoder, "-preset", ff.preset,
               "-crf", str(ff.crf), "-pix_fmt", ff.pix_fmt, *audio_args,
               "-avoid_negative_ts", "1", "-y", video_path]
        try:
            ret = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, timeout=600)
            if ret.returncode != 0:
                logger.error(f"ffmpeg clip export failed: "
                             f"{ret.stderr.decode()[-400:]}")
                return -1
        except Exception as ex:
            logger.error(f"ffmpeg failed: {ex!r}")
            return -1
        return 0

    @classmethod
    def save_video_with_audio(cls, video_series, video_loader, export_option,
                              video_path, start_frame=None, end_frame=None,
                              logger=None) -> int:
        """Encode the (bbox-annotated) frames to a temp AVI, then transcode
        and mux the source audio segment with probed codec handling
        (reference MetLib/videowriter.py:534-605)."""
        logger = get_useable_logger(logger)
        video_name = getattr(video_loader, "video_name", None)
        if not cls.available(export_option) or not video_name:
            return super().save_video_with_audio(
                video_series, video_loader, export_option, video_path,
                start_frame, end_frame, logger)
        ffmpeg, ffprobe = cls._resolve_paths(export_option)
        ff = export_option.ffmpeg_config
        fps = video_loader.fps
        s0 = (start_frame if start_frame is not None
              else getattr(video_loader, "start_frame", 0))
        e0 = (end_frame if end_frame is not None
              else s0 + len(video_series))
        duration = (e0 - s0) / fps
        start_ts = frame2ts(s0, fps)
        audio_args = cls._get_audio_args(ffprobe, video_name, video_path)
        with tempfile.TemporaryDirectory() as tmp:
            tmp_avi = os.path.join(tmp, "clip.avi")
            if OpenCVVideoWriter.save_video(video_series, fps, export_option,
                                            tmp_avi, logger) != 0:
                return -1
            # video from the annotated temp clip (input 0); audio seeked/
            # trimmed from the source (input 1, '1:a:0?' tolerates missing
            # audio tracks)
            cmd = [ffmpeg, "-i", tmp_avi, "-ss", start_ts, "-t",
                   f"{duration:.3f}", "-i", video_name, "-map", "0:v:0",
                   "-map", "1:a:0?", "-c:v", ff.video_encoder, "-preset",
                   ff.preset, "-crf", str(ff.crf), "-pix_fmt", ff.pix_fmt,
                   *audio_args, "-avoid_negative_ts", "1", "-y", video_path]
            try:
                ret = subprocess.run(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, timeout=600)
                if ret.returncode != 0:
                    logger.error(f"ffmpeg mux failed: "
                                 f"{ret.stderr.decode()[-400:]}")
                    return -1
            except Exception as ex:
                logger.error(f"ffmpeg failed: {ex!r}")
                return -1
        return 0
