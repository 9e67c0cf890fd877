"""Image loaders for the still-image (MetDetPhoto) pipeline.

API parity with reference MetLib/imgloader.py:29-325: ``pop()`` yields
``(filename, image)`` pairs; the multi-threaded variant decodes in parallel
with ordered output and a bounded in-flight budget. Decode stays host-side
(cv2 / rawpy-gated); the heavy inference is batched on device downstream.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from abc import ABCMeta, abstractmethod
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional, Union

import numpy as np

from ..log import BaseMetLog, get_default_logger
from .fileio import (SUPPORT_COMMON_FORMAT, SUPPORT_RAW_FORMAT, is_ext_within,
                     load_8bit_image, load_raw_with_preprocess)

ImgPair = tuple[Union[str, None], Union[np.ndarray, None]]

IMG_GET_TIMEOUT = 10
DEFAULT_WORKER_NUM = max(1, mp.cpu_count() // 2)


class BaseImgLoader(metaclass=ABCMeta):

    def __init__(self, img_fn_list: list[str]) -> None:
        self.img_fn_list = img_fn_list

    @property
    def num_images(self) -> int:
        return len(self.img_fn_list)

    def start(self):
        pass

    def stop(self):
        pass

    @abstractmethod
    def pop(self) -> ImgPair:
        ...

    def summary(self) -> str:
        return f"{self.__class__.__name__} with {self.num_images} images."


class VanillaImgLoader(BaseImgLoader):
    """Synchronous loader: decodes inside pop()."""

    def __init__(self, img_fn_list: list[str], raw_power: float = 2.222,
                 target_nl_mean: float = 0.3, contrast_alpha: float = 1.2,
                 output_bps: int = 8,
                 logger: Optional[BaseMetLog] = None, **kwargs: Any) -> None:
        super().__init__(img_fn_list)
        self.output_bps = output_bps
        self.raw_power = raw_power
        self.target_nl_mean = target_nl_mean
        self.contrast_alpha = contrast_alpha
        self.logger = logger or get_default_logger()
        self.current_idx = -1

    def _load_at(self, idx: int) -> ImgPair:
        if idx < 0 or idx >= self.num_images:
            return (None, None)
        fname = self.img_fn_list[idx]
        try:
            if is_ext_within(fname, SUPPORT_RAW_FORMAT):
                img = load_raw_with_preprocess(
                    fname, power=self.raw_power,
                    target_nl_mean=self.target_nl_mean,
                    contrast_alpha=self.contrast_alpha,
                    output_bps=8 if self.output_bps == 8 else 16)
            elif is_ext_within(fname, SUPPORT_COMMON_FORMAT):
                img = load_8bit_image(fname)
            else:
                self.logger.error(f"Unsupported image format: {fname}.")
                return (fname, None)
        except (Exception, KeyboardInterrupt) as e:
            self.logger.error(f"Failed to load image {fname}: {e!r}.")
            if isinstance(e, KeyboardInterrupt):
                raise
            return (fname, None)
        return (fname, img)

    def pop(self) -> ImgPair:
        self.current_idx += 1
        return self._load_at(self.current_idx)


class ThreadImgLoader(VanillaImgLoader):
    """Single decode thread + bounded queue."""

    def __init__(self, img_fn_list: list[str], maxsize: int = 1,
                 **kwargs: Any) -> None:
        super().__init__(img_fn_list, **kwargs)
        self.queue: "queue.Queue[ImgPair]" = queue.Queue(maxsize=maxsize)
        self.stopped = False

    def _load_loop(self):
        try:
            while not self.stopped:
                self.current_idx += 1
                pair = self._load_at(self.current_idx)
                self.queue.put(pair, timeout=IMG_GET_TIMEOUT)
                if pair[0] is None:
                    break
        except Exception as e:
            self.logger.error(f"{self.__class__.__name__} terminated: {e!r}")
        finally:
            self.stopped = True

    def start(self):
        while not self.queue.empty():
            self.queue.get()
        self.stopped = False
        self.current_idx = -1
        self.thread = threading.Thread(target=self._load_loop, daemon=True)
        self.thread.start()

    def pop(self) -> ImgPair:
        try:
            if not (self.stopped and self.queue.empty()):
                return self.queue.get(timeout=IMG_GET_TIMEOUT)
        except queue.Empty:
            pass
        return (None, None)

    def stop(self):
        self.stopped = True
        if hasattr(self, "thread"):
            self.thread.join()


class MultiThreadImgLoader(VanillaImgLoader):
    """Pool loader: decodes ahead on an executor while ``pop()`` consumes a
    bounded window of futures in submission order.

    Functional parity with reference MetLib/imgloader.py:158-325 (parallel
    decode, strictly ordered output, bounded in-flight prefetch), but a
    different construction: instead of free-running workers coordinating
    through a shared index/semaphore/result-map, submission order IS the
    output order — ``pop()`` takes the oldest future and tops the window
    back up, so ordering and backpressure both fall out of one deque and
    no cross-thread bookkeeping exists to race.
    """

    def __init__(self, img_fn_list: list[str],
                 num_workers: int = DEFAULT_WORKER_NUM,
                 max_prefetch: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(img_fn_list, **kwargs)
        self.num_workers = max(1, int(num_workers))
        # in-flight decode budget: bounds peak memory (RAW decodes are
        # ~100MB each) while keeping every worker fed
        self.window = max(1, int(max_prefetch if max_prefetch is not None
                                 else max(2, self.num_workers * 2)))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: "deque[Future[ImgPair]]" = deque()
        self._submitted = 0

    def _top_up(self) -> None:
        assert self._pool is not None
        while (self._submitted < self.num_images
               and len(self._inflight) < self.window):
            self._inflight.append(
                self._pool.submit(self._load_at, self._submitted))
            self._submitted += 1

    def start(self):
        self.stop()
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                        thread_name_prefix="imgdecode")
        self._submitted = 0
        self._top_up()

    def pop(self) -> ImgPair:
        if self._pool is None and self._submitted == 0:
            self.start()  # pop() before start(): begin from the first image
        while self._inflight:
            oldest = self._inflight.popleft()
            try:
                pair = oldest.result(timeout=IMG_GET_TIMEOUT * self.window)
            except Exception as e:  # decode errors are handled in _load_at;
                self.logger.error(f"decode future failed: {e!r}")
                self._top_up()
                continue
            # refill only after delivery so `window` strictly bounds
            # concurrent decodes (RAW frames are ~100MB each)
            self._top_up()
            return pair
        return (None, None)

    def stop(self):
        if self._pool is not None:
            for fut in self._inflight:
                fut.cancel()
            self._pool.shutdown(wait=True)
            self._pool = None
        self._inflight.clear()
