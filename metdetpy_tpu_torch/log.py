"""Leveled, threaded logging with domain levels (Meteor/Dropped/Processing).

Behavior parity with reference MetLib/metlog.py:17-166: eight levels
including the domain levels a GUI frontend parses, a queue+thread non-blocking
logger, and a backend mode that remaps the Dropped header.
"""

from __future__ import annotations

import datetime
import queue
import sys
import threading
import time
from typing import Callable, Optional

LEVEL_HEADER = [
    "Dropped", "Debug", "Processing", "Info", "Warning", "Error", "Meteor",
    "Fatal",
]

LV_DROPPED = 0
LV_DEBUG = 1
LV_PROCESSING = 2
LV_INFO = 3
LV_WARNING = 4
LV_ERROR = 5
LV_METEOR = 6
LV_FATAL = 7


class BaseMetLog:
    """No-op logger; also the interface."""

    def log(self, level: int, string: str) -> None:
        pass

    def debug(self, string: str) -> None:
        self.log(LV_DEBUG, string)

    def info(self, string: str) -> None:
        self.log(LV_INFO, string)

    def warning(self, string: str) -> None:
        self.log(LV_WARNING, string)

    def error(self, string: str) -> None:
        self.log(LV_ERROR, string)

    def fatal(self, string: str) -> None:
        self.log(LV_FATAL, string)

    def meteor(self, string: str) -> None:
        self.log(LV_METEOR, string)

    def dropped(self, string: str) -> None:
        self.log(LV_DROPPED, string)

    def processing(self, string: str) -> None:
        self.log(LV_PROCESSING, string)

    @property
    def is_empty(self) -> bool:
        return True

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class ThreadMetLog(BaseMetLog):
    """Queue-backed logger running its own daemon thread."""

    def __init__(self, pipe: Callable[..., None] = print, flush: bool = True,
                 log_level: int = LV_INFO, with_strf: bool = False) -> None:
        self.log_level = log_level
        self.print = pipe
        self.with_strf = with_strf
        self.flush = flush
        self.pool: "queue.Queue[tuple[str, int, str]]" = queue.Queue()
        self.stopped = True
        self._wait = 0.02

    @property
    def is_empty(self) -> bool:
        return self.pool.empty()

    @property
    def is_stopped(self) -> bool:
        return self.stopped

    def _loop(self) -> None:
        while not (self.stopped and self.is_empty):
            time.sleep(self._wait)
            try:
                strf, lv, string = self.pool.get(timeout=self._wait)
            except queue.Empty:
                continue
            line = f"{strf}{LEVEL_HEADER[lv]}: {string}"
            if lv == LV_FATAL:
                sys.stderr.write(line + "\n")
                sys.stderr.flush()
            else:
                self.print(line, flush=self.flush)

    def log(self, level: int, string: str) -> None:
        if level < self.log_level:
            return
        head = ""
        if self.with_strf:
            now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
            head = f"[{now}] - "
        self.pool.put((head, level, string))

    def start(self) -> None:
        if not self.stopped:
            return
        self.stopped = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.stopped = True
        if hasattr(self, "thread"):
            self.thread.join(timeout=10)


_default_logger = ThreadMetLog()


def set_default_logger(debug_mode: bool, work_mode: str) -> int:
    """Configure the process-wide logger.

    - debug_mode: emit everything incl. Dropped, with timestamps.
    - backend: emit everything, force flush, and rename the Dropped header to
      "Meteor" so a GUI can parse both streams uniformly
      (reference MetLib/metlog.py:139-156).
    """
    global _default_logger
    if not _default_logger.is_stopped:
        _default_logger.log(LV_ERROR, "Can not set a running logger.")
        return -1
    if debug_mode:
        _default_logger.log_level = LV_DROPPED
        _default_logger.with_strf = True
    elif work_mode == "backend":
        _default_logger.flush = True
        _default_logger.log_level = LV_DROPPED
        LEVEL_HEADER[LV_DROPPED] = "Meteor"
    else:
        _default_logger.log_level = LV_INFO
    return 0


def get_default_logger() -> ThreadMetLog:
    return _default_logger


def get_useable_logger(logger: Optional[BaseMetLog]) -> BaseMetLog:
    return logger if logger is not None else BaseMetLog()
