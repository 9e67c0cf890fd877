"""A block step as one device program a block: a CUDA graph of it.

Counterpart of the JAX package's ``jax.jit(..., static_argnames=...)`` on
its block steps (``metdetpy_tpu/detectors/m3det.py::_m3_block_step``, the
same under ``shard_map(vmap(...))`` for S feeds in
``parallel/multistream.py``, and ``_classic_block_step``): there a step is one
compiled executable a shape, its carries (window, sub-ROI and
dynamic-mask histories, the EMA state and the frame timer) stay on the
device, and a block costs one dispatch. Here ``StepGraph`` captures the
step once a key (the step's static keywords, the block's shape, the
device) in a ``torch.cuda.CUDAGraph`` and replays it for every block. The
step's EMA schedule and window lengths are device data computed from the
timer tensor, so the one graph is valid for every block.

Protocol:

- The graph's static buffers are the detector's carries (given at
  construction; they are updated in place, never replaced) and a frames
  buffer a key.
- The body runs the step on the static buffers, then copies each new
  carry into its buffer, after every read of the old one. Where the
  window's new gray history is a view of the frames buffer (n-1 <= T on
  the card), the copy takes it out of that buffer before the next call
  overwrites it.
- A call copies the block into the frames buffer, replays the graph and
  returns fresh tensors (clones of the graph's ``packed`` and ``dst``): the
  block loop keeps handles of many blocks, and the next replay overwrites
  the graph's own outputs.
- The first call of a key runs two eager warm-ups of the step on a side
  stream, on scratch copies of the carries (they fill the step's cached
  device tables, such as the peak find's cut ladder and the trig tables,
  and bind the kernels outside the capture, and the detector's state
  advances by exactly one step a block), then captures.
- The warm-ups, the capture and every replay run with the carries' card
  as the current device, whichever card the caller made current, and the
  capture on a stream of that card: the kernels' stream and a replay's
  stream are each the current device's, and ``torch.cuda.graph``'s
  default capture stream is made once a process on the card current at
  its first capture, so a graph over carries on another card would miss
  its work or fail to capture.
- On the CPU there is nothing to capture: a call runs the body directly,
  with the same buffers and copies (the tests hold this protocol to the
  functional step).

Like jit's cache, the graphs outlive the detector that captured them: a
dropped detector gives its ``StepGraph`` back (``release``), and the next
detector whose carries have the same shapes adopts it (``acquire``), its
values copied into the buffers, so that a later run in the process
replays without a capture. At most one idle ``StepGraph`` is kept a
carry signature; another one given back is dropped with its graphs and
their memory pools, and ``clear_idle`` drops them all.

There is no eager fallback: a capture that fails raises with the key and
the launches reached. ``ops.kernels.LAUNCHES`` counts in Python where a
wrapper launches, so a replay would add nothing to it: the launches
recorded at capture are taken off the counts (nothing ran) and added once
at each replay.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Callable, Optional

import torch

from ..ops import kernels
from ..profiling import StageTimer

# every capture of this process, oldest first: the step's name, key, the
# two warm-ups' seconds, the capture's seconds, the growth of the card's
# reserved memory over the capture (the graph's pool), the kernel launches
# of a replay
CAPTURES: list[dict] = []


# one idle StepGraph a (step, carry shapes, dtypes, device), for the next
# acquire of that signature
_IDLE: dict = {}
_IDLE_LOCK = threading.Lock()


def _signature(step: Callable, carries) -> tuple:
    return (step, tuple((tuple(t.shape), t.dtype, str(t.device))
                        for t in _tensors(carries)))


def clear_idle() -> None:
    """Drop every idle StepGraph, and with it its graphs and their memory
    pools (the counterpart of ``jax.clear_caches()``): the next detector
    of any shape captures anew."""
    with _IDLE_LOCK:
        _IDLE.clear()


def _tensors(carries) -> list:
    """The tensors of a carry list, an EMA state's six in field order."""
    out = []
    for c in carries:
        out.extend(c.tensors() if hasattr(c, "tensors") else [c])
    return out


def _clone(carries) -> list:
    return [c.clone() for c in carries]


@dataclasses.dataclass
class _Entry:
    """One key's frames buffer and, on a card, its graph."""
    frames: torch.Tensor
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: tuple = ()
    launches: dict = dataclasses.field(default_factory=dict)


class StepGraph:
    """One captured step a key over fixed carries.

    ``step(*carries[:-1], frames, carries[-1], **static)`` returns
    ``(packed, dst, *new_carries)``, the new carries in the order of
    ``carries``, whose last is the frame timer (a 0-dim int32 tensor):
    ``_m3_block_step``'s signature."""

    def __init__(self, step: Callable, carries: list) -> None:
        self.step = step
        self.carries = list(carries)
        self._entries: dict = {}

    @classmethod
    def acquire(cls, step: Callable, carries: list) -> "StepGraph":
        """A StepGraph whose buffers hold the values of ``carries``: the
        idle one of their signature, if one was given back (its graphs
        kept, the values copied into its buffers, so the caller takes its
        ``carries`` as its own), else a new one over ``carries``."""
        with _IDLE_LOCK:
            graph = _IDLE.pop(_signature(step, carries), None)
        if graph is None:
            return cls(step, carries)
        for buf, value in zip(_tensors(graph.carries), _tensors(carries)):
            buf.copy_(value)
        return graph

    def release(self) -> None:
        """Give this StepGraph back for a later ``acquire``; where one of
        its signature is idle already, it is dropped instead (and with
        its last reference, its graphs and their pools)."""
        with _IDLE_LOCK:
            _IDLE.setdefault(_signature(self.step, self.carries), self)

    def body(self, frames: torch.Tensor, static: dict):
        """The step on the static buffers, each new carry copied into its
        buffer after the step (a carry the step returns as it is, as an
        unused dynamic mask's history, is left alone)."""
        packed, dst, *new = self.step(*self.carries[:-1], frames,
                                      self.carries[-1], **static)
        for buf, value in zip(_tensors(self.carries), _tensors(new)):
            if value is not buf:
                buf.copy_(value)
        return packed, dst

    def __call__(self, block: torch.Tensor, spans: Optional[StageTimer] = None,
                 **static):
        """One block ([T, H, W] u8, on the carries' device or a CPU
        tensor, which is uploaded): returns (packed, dst) as new tensors;
        the carries advance by one step. On a card the call's parts are
        spans of ``spans`` (the caller's recorder, where it gives one):
        ``step_graph.frames_copy``, ``step_graph.capture``
        (the first call of a key), ``step_graph.replay`` and
        ``step_graph.out_clone``."""
        dev = self.carries[-1].device
        key = (tuple(sorted(static.items())), tuple(block.shape), str(dev))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(torch.empty(
                tuple(block.shape), dtype=torch.uint8, device=dev))
        if dev.type != "cuda":
            entry.frames.copy_(block)
            packed, dst = self.body(entry.frames, static)
            return packed.clone(), dst.clone()
        if spans is None:
            spans = StageTimer()
        # on the carries' card, whichever card is current (module docstring)
        with torch.cuda.device(dev):
            with spans.span("step_graph.frames_copy"):
                entry.frames.copy_(block)
            if entry.graph is None:
                with spans.span("step_graph.capture"):
                    self._capture(entry, key, static)
            with spans.span("step_graph.replay"):
                entry.graph.replay()
            for name, n in entry.launches.items():
                kernels.LAUNCHES[name] += n
            packed, dst = entry.out
            with spans.span("step_graph.out_clone"):
                return packed.clone(), dst.clone()

    def _capture(self, entry: _Entry, key, static: dict) -> None:
        """Two eager warm-ups, then the capture; on the frames' card, which
        the caller has made the current device."""
        dev = entry.frames.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            scratch = _clone(self.carries)
            for _ in range(2):
                _, _, *scratch = self.step(*scratch[:-1], entry.frames,
                                           scratch[-1], **static)
        cur.wait_stream(side)
        del scratch
        torch.cuda.synchronize(dev)
        warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no automatic collection inside the capture: one that finds a
        # dropped detector in a reference cycle gives its StepGraph back,
        # and where one of its signature is idle already, frees its graphs,
        # a call the capture forbids (it fails the capture)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # "thread_local": the loader's uploader thread (its own stream)
            # and the exporter's recheck may use the card while this thread
            # captures; only this thread's work on the capture stream is
            # captured, and only its allocations go to the graph's pool.
            # The capture stream is the warm-ups' stream on this card:
            # torch.cuda.graph's default one is made once a process, on the
            # card current at the first capture
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = self.body(entry.frames, static)
        except Exception as exc:
            reached = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
            raise RuntimeError(
                f"CUDA graph capture of the step failed (key {key}; kernel "
                f"launches captured before the failure: {reached}): "
                f"{type(exc).__name__}: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
            launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
            for k, n in launched.items():
                kernels.LAUNCHES[k] -= n  # captured, not run
        entry.graph, entry.out, entry.launches = graph, tuple(out), launched
        CAPTURES.append({
            "step": self.step.__name__, "key": key,
            "warmup_seconds": warmup_s,
            "seconds": time.perf_counter() - t0,
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
            "launches": dict(launched)})
