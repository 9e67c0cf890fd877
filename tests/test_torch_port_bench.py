"""The port's benchmark harness, ``python -m metdetpy_tpu_torch.bench``, on
the CPU against ``bench.py`` (the JAX package's harness).

The same modes (read from ``bench.py``'s source, which is not run); the
same ``build_cfg`` and ``_chained_slope``; ``run`` gives ``bench.run``'s
records on a synthetic clip, and one active-sky worst-case block gives
the JAX M3 step's packed buffer and occupancy, bit for bit; every mode
prints one JSON line with the JAX mode's keys at a tiny size on the CPU;
the entry point without a card raises and prints nothing.
"""

import ast
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from metdetpy_tpu.detectors import m3det as jm3
from metdetpy_tpu.log import BaseMetLog as JBaseMetLog
from metdetpy_tpu.structs import MainDetectCfg as JMainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import bench
from metdetpy_tpu_torch.detectors import m3det as tm3

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(REPO, "metdetpy_tpu_torch", "bench.py")

# top-level keys of each mode's JSON line: the JAX mode's, and "device"
COMMON = {"metric", "value", "unit", "vs_baseline", "device"}
PASSES = {"protocol", "value_best", "passes_fps"}
SHARDED = COMMON | {"streams_with_meteor", "n_streams", "backend"}
MULTISTREAM = COMMON | PASSES | {
    "input_resolution", "analysis_resolution", "streams_with_meteor_lines",
    "n_streams", "stages", "stages_all_passes"}
KEYS = {
    None: COMMON | PASSES | {
        "vs_baseline_best", "device_only_fps", "device_only_vs_baseline",
        "device_hbm", "device_worstcase_fps", "device_worstcase_occupancy",
        "device_with_readback_fps", "readback_mbps", "host_memcpy_gbps",
        "stages"},
    "probe": {"metric", "h2d_mbps", "d2h_mbps", "probe_wall_s", "device"},
    "multistream": MULTISTREAM,
    "multistream_4k": MULTISTREAM | {"decode_provisioning"},
    "multistream_sharded": SHARDED,
    "dldet_sharded": SHARDED,
    "yolo": COMMON | {"batch"},
    "dldet": COMMON | PASSES | {"meteor_found", "detector", "note",
                                "stages"},
    "high_mask": COMMON | PASSES | {"meteor_found", "config"},
    "photo": COMMON | {"protocol", "value_best", "n_images",
                       "result_records"},
    "denoise": COMMON | {
        "protocol", "value_best", "t_max_export_s", "t_mfnr_export_s",
        "t_max_passes_s", "t_mfnr_passes_s", "device_pixel_math", "stages",
        "clip"},
    "recheck": COMMON | PASSES | {
        "recheck_off_fps_best", "recheck_off_fps_median",
        "recheck_off_passes_fps", "recheck_overhead_pct_best",
        "recheck_overhead_pct_median", "meteor_found", "n_meteors",
        "n_rechecked_targets", "n_demoted_targets", "target_categories",
        "clip_events", "note"},
}
NESTED = {
    "device_hbm": {"copy_roofline_gbps", "hbm_peak_gbps", "copy_us_per_block",
                   "step_us_per_block", "step_cost_in_block_copies",
                   "fetch_rtt_s"},
    "device_worstcase_occupancy": {"mean_npix", "min_npix", "max_points",
                                   "overflow_rate"},
    "stages": {"pass_index", "wall_s", "decode_wait_s", "dispatch_s",
               "collect_s", "loader_h2d_s", "loader_host_s", "loader_qput_s",
               "loader_loop_wall_s", "h2d_bytes", "d2h_bytes",
               "h2d_probe_gbps", "loader_h2d_gbps", "collect_effective_mbps",
               "projected_fps_local_pcie", "projected_bound_stage",
               "projected_fps_probe_link"},
}


def _jax_modes() -> set:
    """The ``mode == "..."`` literals of bench.py's source."""
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {node.comparators[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Compare)
            and isinstance(node.left, ast.Name) and node.left.id == "mode"
            and isinstance(node.ops[0], ast.Eq)
            and isinstance(node.comparators[0], ast.Constant)}


def test_mode_set_equals_jax_main():
    jax_modes = _jax_modes()
    assert len(jax_modes) == 10
    assert {m for m in bench.MODES if m is not None} == jax_modes
    assert None in bench.MODES  # BENCH_MODE unset: the default mode


def test_build_cfg_equals_jax():
    assert bench.build_cfg().to_dict() == jbench.build_cfg().to_dict()


@pytest.mark.parametrize("counts,reps", [((16, 272), 3), ((3, 11), 2),
                                         ((8, 40), 3)])
def test_chained_slope_equals_jax(counts, reps):
    def fake():
        # a deterministic run_n: affine in n plus a jitter per call
        calls = iter(range(1000))

        def run_n(n):
            return 0.0371 + 0.00213 * n + 0.0007 * ((next(calls) * 7) % 5)
        return run_n
    assert (bench._chained_slope(fake(), counts, reps)
            == jbench._chained_slope(fake(), counts, reps))


def test_run_gives_jax_records(monkeypatch):
    """``run`` on a 2 s 640x360 clip (analysed at 960x540, as build_cfg
    sets it) gives ``bench.run``'s records."""
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    w, h = 640, 360
    frames = generate_meteor_video(
        width=w, height=h, fps=25.0, duration_sec=2.0,
        meteors=[SynthMeteor(start_sec=0.4, end_sec=1.6,
                             pt1=(int(w * 0.45), int(h * 0.25)),
                             pt2=(int(w * 0.30), int(h * 0.55)))],
        n_stars=150, noise_sigma=4.0)
    _, want = jbench.run(frames.copy(), jbench.build_cfg())
    _, got = bench.run(frames.copy(), bench.build_cfg(), device="cpu")
    want = [r.to_dict() for r in want.results]
    assert any(t["category"] == "METEOR" for r in want for t in r["target"])
    assert [r.to_dict() for r in got.results] == want


def _masked(packed, k):
    """The packed buffer with the line slots of invalid peaks zeroed (the
    port zeroes them, the JAX package leaves what the walk wrote)."""
    p = np.array(packed, dtype=np.float32)
    valid = p[:, k * 4:k * 5] > 0.5
    lines = p[:, :k * 4].reshape(p.shape[0], k, 4)
    lines[~valid] = 0
    p[:, :k * 4] = lines.reshape(p.shape[0], k * 4)
    return p


def test_worstcase_block_equals_jax():
    """Two active-sky blocks of 256x144 (12 blobs a frame, max_points
    2048) from the port's ``worstcase_frames``: the JAX M3 step and the port's
    give the same packed buffers, and the second block's occupancy is the
    JAX harness's dict, dense (npix > 1024) and without overflow."""
    h, w, max_points = 144, 256, 2048
    frames = bench.worstcase_frames(2 * bench.BLOCK_FRAMES, h, w, n_blobs=12)
    jcfg = JMainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    jcfg.detector.cfg.binary.adaptive_bi_thre = False
    jcfg.detector.cfg.binary.init_value = 30
    tcfg = bench.worstcase_cfg()
    assert tcfg.to_dict() == jcfg.to_dict()
    mask = np.ones((h, w), np.uint8)
    jd = jm3.M3Detector(1.0, 25.0, mask, 10, jcfg.detector.cfg,
                        JBaseMetLog(), max_points=max_points)
    td = tm3.M3Detector(1.0, 25.0, mask, 10, tcfg.detector.cfg,
                        bench.BaseMetLog(), max_points=max_points,
                        device="cpu")
    for b in range(2):
        block = frames[b * bench.BLOCK_FRAMES:(b + 1) * bench.BLOCK_FRAMES]
        jp = np.asarray(jd.process_block_async(block)[0])
        tp = td.process_block_async(block)[0].numpy()
        np.testing.assert_array_equal(_masked(tp, td.max_peaks),
                                      _masked(jp, jd.max_peaks))
    _, _, je = jm3._unpack(jp, jd.max_peaks)
    want = {"mean_npix": round(float(je[:, 1].mean()), 1),
            "min_npix": int(je[:, 1].min()),
            "max_points": jd.max_points,
            "overflow_rate": round(float((je[:, 2] > 0.5).mean()), 3)}
    got = bench.occupancy(tp, td.max_peaks, td.max_points)
    assert got == want
    assert 1024 < got["min_npix"] and got["mean_npix"] < max_points
    assert got["overflow_rate"] == 0.0


# -- every mode's JSON line on the CPU, at a tiny size ------------------------

SMALL = {"width": 192, "height": 108}
TINY = {
    None: dict(SMALL, n_blocks=(1, 1, 1), worst_hw=(54, 96), worst_blobs=2),
    "probe": {},
    "multistream": {"width": 96, "height": 54},
    "multistream_4k": {"width": 96, "height": 54},
    "multistream_sharded": {},
    "dldet_sharded": {},
    "yolo": {"counts": (1, 2)},
    "dldet": SMALL,
    "high_mask": SMALL,
    "photo": SMALL,
    "denoise": dict(SMALL, n_frames=16),
    "recheck": SMALL,
}
ENV = {"BENCH_SECONDS": "3", "BENCH_PASSES": "1", "BENCH_STREAMS": "2",
       "BENCH_PHOTO_IMGS": "2", "BENCH_YOLO_BATCH": "2",
       "BENCH_SHARDED_W": "96", "BENCH_SHARDED_H": "54",
       "METDETPY_TPU_MAX_POINTS": "512", "METDETPY_TPU_YOLO_HW": "96x96"}


def _string_literals(path) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_expected_keys_are_literals_of_the_port():
    literals = _string_literals(PORT_SRC)
    for keys in (*KEYS.values(), *NESTED.values()):
        assert keys <= literals, sorted(keys - literals)


@pytest.mark.parametrize("case", list(TINY), ids=lambda c: str(c))
def test_mode_prints_one_json_line_with_jax_keys(case, monkeypatch, capsys):
    """``main(["--device", "cpu"])`` with BENCH_MODE set: exactly one line
    on stdout, a JSON object with the mode's keys. Sizes shrink through the
    mode's own arguments, the M3 presets run at the clip's size, and the
    chained slopes time chains of 1 and 2 steps once."""
    mode = "multistream" if case == "multistream_4k" else case
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    if case == "multistream_4k":
        monkeypatch.setenv("BENCH_INPUT", "4k")
    if mode is None:
        monkeypatch.delenv("BENCH_MODE", raising=False)
    else:
        monkeypatch.setenv("BENCH_MODE", mode)
    preset = bench._preset

    def at_clip_size(name):
        cfg = preset(name)
        if name.startswith("m3det"):
            cfg.loader.resize = None
        return cfg
    monkeypatch.setattr(bench, "_preset", at_clip_size)
    slope = bench._chained_slope
    monkeypatch.setattr(bench, "_chained_slope",
                        lambda run_n, counts=None, reps=3: slope(
                            run_n, counts=(1, 2), reps=1))
    monkeypatch.setitem(bench.MODES, mode,
                        functools.partial(bench.MODES[mode], **TINY[case]))
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    record = json.loads(lines[0])
    assert set(record) == KEYS[case]
    assert record["device"] == "cpu"
    for key, sub in NESTED.items():
        if key in record and mode is None:
            assert set(record[key]) == sub
    if mode is None:
        assert record["metric"] == "1080p_detect_fps_per_chip"
        assert record["device_hbm"]["hbm_peak_gbps"] == 3350
    if case == "multistream_4k":
        assert record["input_resolution"] == "384x216"
        assert record["metric"] == "2x216p_multistream_agg_fps_per_chip"


@pytest.mark.parametrize("real", [None, "1"])
def test_sharded_modes_mesh(real, monkeypatch):
    """The sharded modes' streams lie on the one device as shards of a
    mesh; BENCH_SHARDED_REAL=1 asks for a device a shard, which on the
    CPU is the same mesh."""
    if real is None:
        monkeypatch.delenv("BENCH_SHARDED_REAL", raising=False)
    else:
        monkeypatch.setenv("BENCH_SHARDED_REAL", real)
    mesh = bench._stream_mesh(3, torch.device("cpu"))
    assert mesh.size == 3 and mesh.axis_name == "stream"
    assert mesh.groups() == [(torch.device("cpu"), 0, 3)]


def test_unknown_mode_raises(monkeypatch):
    monkeypatch.setenv("BENCH_MODE", "tpu_only")
    with pytest.raises(ValueError, match="unknown BENCH_MODE 'tpu_only'"):
        bench.main(["--device", "cpu"])


def test_entry_point_without_card_raises_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    env = {k: v for k, v in os.environ.items() if k != "BENCH_MODE"}
    res = subprocess.run([sys.executable, "-m", "metdetpy_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device is available" in res.stderr
