"""One run of one cell: set up, warm up, measure a window of calls, judge
every call against the plain reference, and print the result's line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (a file there) and its traffic
mix (``traffic/<mix>.json``, whose ``generator`` names
``traffic/<generator>.py``); ``workloads/<cell>.json`` names the entry
(``entries/<entry>.py``), the control and the limit of each number
compared (``judge.BUILT_IN`` or ``comparisons/<number>.py``); each metric
is ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def bench_file() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(bench: dict, name: str) -> dict:
    """The cell's BENCHMARK.json entry, configuration, traffic mix and
    workload file (``spec``), each found by name; KeyError for an unknown
    cell."""
    wl = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    return {"workload": wl,
            "config": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic",
                                              wl["traffic"] + ".json")),
            "spec": load_json(os.path.join(HERE, "workloads",
                                           name + ".json"))}


def metric_module(name: str):
    """``metrics/<name>.py``, loaded by its path (names hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metrics of one kind: ``end_to_end`` with --trace 0,
    ``per_layer`` with --trace 1, each where its ``workloads`` holds the
    cell or it has none."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Call:
    t0: float
    t1: float
    frames: int = 0
    records: list = field(default_factory=list)
    perf: dict = field(default_factory=dict)
    outputs: list = field(default_factory=list)
    traced: bool = False
    error: str = ""
    reserved: int = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Run:
    """The state of one run, which the metric readers read."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, bench: dict | None = None,
                 traffic: dict | None = None, model_hw: str | None = None
                 ) -> None:
        self.name, self.seed, self.seconds = name, int(seed), float(seconds)
        self.trace_on, self.t_start = bool(trace), t_start
        self.root = ROOT
        self.bench = bench or bench_file()
        files = cell_files(self.bench, name)
        self.workload, self.config = files["workload"], files["config"]
        if model_hw:
            # a smaller model input for both sides (the CPU tests)
            for model in (self.config["detector"]["cfg"].get("model"),
                          self.config["collector"]["recheck_cfg"]["model"]):
                if model:
                    model["input_hw"] = model_hw
        self.spec = files["spec"]
        self.traffic = dict(files["traffic"])
        self.traffic.update(traffic or {})
        self.device_name = device
        self.warm: Call | None = None
        self.calls: list[Call] = []
        self.trace = None
        self.trace_read_s = 0.0
        self.ref_stats: dict = {}
        self.peak_bytes = 0
        self.window_s = self.setup_s = self.reference_s = 0.0

    # -- the parts of a run ----------------------------------------------

    def _make_inputs(self) -> None:
        import torch
        self.device = torch.device(self.device_name)
        gen = importlib.import_module(
            "benchmark.traffic." + self.traffic["generator"])
        self.clips = gen.make(self.traffic, self.seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            # the generator's memory is not the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.entry = importlib.import_module(
            "benchmark.entries." + self.spec["entry"]).Entry(self)

    def _call(self, traced: bool = False) -> Call:
        from benchmark.trace import Tracer
        c = Call(time.perf_counter(), 0.0, traced=traced)
        tracer = Tracer(self.device) if traced else None
        if tracer is not None:
            tracer.__enter__()
        try:
            c.frames, c.records, c.perf, c.outputs = self.entry.call()
        except Exception as exc:  # a failed call is judged, not hidden
            c.error = f"{type(exc).__name__}: {exc}"
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)
                self.trace, self.trace_read_s = tracer.trace, tracer.read_s
        c.t1 = time.perf_counter()
        if self.device.type == "cuda":
            import torch
            c.reserved = torch.cuda.memory_reserved(self.device)
        return c

    def _window(self) -> None:
        # --trace 1 profiles the window's second call
        traced_at = 1 if self.trace_on else -1
        t_w0 = time.perf_counter()
        self.setup_s = time.time() - self.t_start
        while True:
            c = self._call(traced=len(self.calls) == traced_at)
            self.calls.append(c)
            if c.error:
                break
            if (c.t1 - t_w0 >= self.seconds
                    and len(self.calls) > traced_at):
                break
        self.window_s = self.calls[-1].t1 - t_w0
        self.frames_total = sum(c.frames for c in self.calls)
        if self.device.type == "cuda":
            import torch
            # the peak of live tensors: the allocator's reserved memory
            # grows with every call (each loader uploads on a new stream,
            # whose cached blocks no later stream reuses), so its peak
            # reads the window's length, not the program's need
            # (``allocator.reserved_gib_per_call`` reads that growth)
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)

    def gaps(self, c: Call, names=None) -> dict:
        """The cell's numbers (or ``names``) of call ``c`` against the
        reference; a failed call reads ``MISSING`` in each."""
        from benchmark import judge
        names = list(names or self.spec["limits"])
        if c.error:
            return {k: judge.MISSING for k in names}
        out = judge.numbers(
            [k for k in names if k in judge.BUILT_IN],
            judge.targets(c.records, self.entry.px_scale),
            judge.frame_outputs(c.outputs), self.ref_targets,
            self.ref_frames, self.entry.score_threshold)
        for k in names:
            if k not in out:
                out[k] = float(judge.comparison(k)(c, self.ref, self.entry))
        return {k: out[k] for k in names}

    def reference(self) -> None:
        from benchmark import judge
        gc.collect()
        if self.device.type == "cuda":
            import torch
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self.ref = self.entry.reference()
        ref_records, self.ref_stats, rows = self.ref
        self.reference_s = time.perf_counter() - t0
        self.ref_targets = judge.targets(ref_records, self.entry.px_scale)
        self.ref_frames = judge.frame_outputs(rows)

    def _judge(self, warm: Call) -> dict:
        from benchmark import judge
        self.reference()
        limits = {k: float(v) for k, v in self.spec["limits"].items()}
        per_call = [self.gaps(c) for c in [warm] + self.calls]
        self.failed = sum(judge.failed(g, limits) for g in per_call[1:])
        self.warm_ok = not judge.failed(per_call[0], limits)
        worst = {k: max(g[k] for g in per_call) for k in limits}
        return judge.check(worst, limits)

    def execute(self) -> dict:
        """The result's line as a dict (``checks`` last)."""
        from benchmark import guard, judge
        self._make_inputs()
        self.warm = warm = self._call()
        self._window()
        checks = self._judge(warm)
        correct = (self.failed == 0 and self.warm_ok
                   and judge.within(checks))
        metrics = {}
        for m in metrics_of(self.bench, self.name, self.trace_on):
            value = metric_module(m["name"]).read(self)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
                  "kind": self._kind(), "count": int(
                      self.workload.get("chips", 1)),
                  "memory_peak_bytes": int(self.peak_bytes)}
        if self.device.type == "cuda":
            device["power_limit"] = power_limit()
        if self.trace_on and self.trace is not None:
            device["busy_s"] = self.trace.busy_s()
            device["window_s"] = self.trace.window_s
        out = {"correct": bool(correct), "attempted": len(self.calls),
               "failed": int(self.failed), "metrics": metrics,
               "device": device}
        if self.trace_on and self.trace is not None:
            out["breakdown"] = self.trace.breakdown()
        self.notes = {"window_s": self.window_s, "calls": len(self.calls),
                      "reference_s": self.reference_s,
                      "trace_read_s": self.trace_read_s,
                      "errors": [c.error for c in [warm] + self.calls
                                 if c.error][:3]}
        out["checks"] = checks
        bad = guard.loaded()
        if bad:
            raise ImportError("the run loaded " + ", ".join(bad))
        return out

    def _kind(self) -> str:
        import torch
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"


def main(args, t_start: float) -> int:
    bench = bench_file()
    try:
        chips = int(cell_files(bench, args.workload)["workload"]["chips"])
    except KeyError:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    try:
        import metdetpy_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as exc:
        print(f"the program is missing: {exc}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda", t_start, bench)
    # the program's log lines go to standard error: the result's line is
    # the last of standard output
    real_stdout = sys.stdout
    sys.stdout = sys.stderr
    try:
        out = run.execute()
    except ImportError as exc:
        print(str(exc), file=sys.stderr)
        return 3
    finally:
        sys.stdout = real_stdout
    print("run " + json.dumps(run.notes), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
