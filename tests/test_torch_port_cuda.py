"""PyTorch port on the card: each CUDA kernel against its plain version,
the model and its device functions against the CPU, and the MDRF on the
card against the MDRF on the CPU.

Every test here carries the ``cuda`` marker and skips without a GPU (a
CUDA kernel has no CPU mode). The file imports nothing of JAX, so it runs
on a machine without it; ``tests/conftest.py`` imports JAX, so there run
it without the conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.ops import hough, kernels
from metdetpy_tpu_torch.ops.kernel_cases import (
    PEAK_CASES, PEAK_MAX, PICK_CASES, VOTE_CASES, WALK_CASES,
    WINDOW_DIFF_STREAM_CASES, peak_case, pick_case, vote_case, walk_case,
    window_diff_stream_case)
from metdetpy_tpu_torch.structs import MainDetectCfg
from metdetpy_tpu_torch.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu_torch.utils import relative2abs_path

SEED = 20261016


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_cases(dev):
    """Small inputs with ragged edges (37x150 frames, partial and empty
    point lists, walks that leave the plane) for each kernel."""
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    h, w = 37, 150
    n_rho = hough._round_up(2 * (w + h) + 1, 128)
    s = hough._round_up(max(h, w) + 1, 128)
    n_steps = hough._round_up(max(h, w) + 4, 128)
    imgs = t((rng.random((3, h, w)) < 0.1).astype(np.uint8))
    planes = hough.corner_planes(imgs, s)
    th, rh = (t(rng.integers(0, 180, (3, 16))),
              t(rng.integers(0, n_rho, (3, 16))))
    geom = hough.walk_geom(th, rh, w + h, n_steps, h, w, s)
    v = kernels.walk_pick_plain(planes, geom.r.contiguous(), geom.xmaj)
    return {
        "window_diff": (
            (t(rng.integers(0, 256, (4, h, w), dtype=np.uint8)),
             t(rng.integers(0, 256, (9, h, w), dtype=np.uint8)), 5, 2),
            kernels.window_diff_plain),
        "median_binarize_close": (
            (t(rng.integers(0, 30, (5, h, w), dtype=np.uint8)),
             t(rng.integers(2, 12, 5, dtype=np.uint8))),
            kernels.median_binarize_close_plain),
        "hough_vote": (
            (t(rng.integers(0, w, (3, 512)).astype(np.float32)),
             t(rng.integers(0, h, (3, 512)).astype(np.float32)),
             t(np.arange(512)[None] < np.array([512, 100, 0])[:, None]),
             n_rho, w + h),
            kernels.hough_vote_plain),
        "walk_pick": ((planes, geom.r.contiguous(), geom.xmaj),
                      kernels.walk_pick_plain),
        "peak_ladder": (
            (t(np.where(rng.random((3, 180, n_rho)) < 0.02,
                        rng.integers(0, 9000, (3, 180, n_rho)),
                        rng.integers(0, 14, (3, 180, n_rho))
                        ).astype(np.int32)),
             10, hough._peak_cuts(10, dev)),
            kernels.peak_ladder_plain),
        "corner_planes": ((imgs, s), kernels.corner_planes_plain),
        "walk_geom": ((th, rh, w + h, n_steps, h, w, s),
                      kernels.walk_geom_plain),
        "walk_finish": ((v, th, rh, t(rng.random((3, 16)) < 0.8),
                         t(np.array([0.0, 3.0, 1e7], np.float32)), w + h,
                         n_steps, h, w, 1),
                        kernels.walk_finish_plain),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(kernels.SOURCES))
def test_kernel_on_card_matches_plain(cuda_device, name):
    args, plain = _card_cases(cuda_device)[name]
    kernels.reset_launch_counts()
    got = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ragged shapes of the two streaming kernels: (h, w, n, T, timer0, offset);
# offset 1 hands the kernel a contiguous input whose data pointer is not
# 16-byte aligned
WINDOW_DIFF_CASES = [
    (540, 960, 25, 64, 10, 0), (540, 960, 25, 64, 0, 0),
    (37, 150, 1, 64, 0, 0), (37, 150, 2, 1, 0, 0), (2, 961, 25, 64, 5, 0),
    (1, 3, 60, 64, 0, 0), (1, 1, 100, 1, 0, 0), (37, 150, 100, 64, 10**6, 0),
    (2, 960, 60, 1, 10**6, 0), (540, 960, 100, 1, 0, 0),
    (37, 960, 25, 64, 3, 1), (2, 150, 2, 64, 10**6, 1),
]
# (T, h, w, offset)
MEDIAN_CASES = [
    (64, 540, 960, 0), (5, 37, 150, 0), (3, 1, 1, 0), (3, 2, 3, 0),
    (2, 540, 961, 0), (4, 37, 960, 0), (3, 2, 150, 0), (2, 1, 960, 0),
    (2, 540, 1, 0), (2, 37, 960, 1), (3, 37, 150, 1),
]


def _on_card(a, dev, offset):
    """A contiguous card tensor holding ``a``, starting ``offset`` bytes
    into its storage."""
    flat = torch.empty(a.size + offset, dtype=torch.uint8, device=dev)
    view = flat[offset:].view(a.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n,t_block,timer0,offset", WINDOW_DIFF_CASES)
def test_window_diff_on_card_ragged(cuda_device, h, w, n, t_block, timer0,
                                    offset):
    rng = np.random.default_rng([SEED, h, w, n, t_block])
    history = _on_card(rng.integers(0, 256, (n - 1, h, w), dtype=np.uint8),
                       cuda_device, offset)
    frames = _on_card(rng.integers(0, 256, (t_block, h, w), dtype=np.uint8),
                      cuda_device, offset)
    kernels.reset_launch_counts()
    diff, new_hist = kernels.window_diff(history, frames, n, timer0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_diff"] == 1
    want, want_hist = kernels.window_diff_plain(history, frames, n, timer0)
    assert torch.equal(diff, want) and torch.equal(new_hist, want_hist)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_DIFF_STREAM_CASES,
                         ids=[c[0] for c in WINDOW_DIFF_STREAM_CASES])
def test_window_diff_stream_axis_on_card(cuda_device, case):
    """S streams in one launch, against the plain version; the history a
    strided view of a previous block in the "view" cases."""
    args = window_diff_stream_case(case, cuda_device, SEED)
    if case[-1] == "view":
        assert not args[0].is_contiguous() and args[0][0].is_contiguous()
    kernels.reset_launch_counts()
    diff, new_hist = kernels.window_diff(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_diff"] == 1
    want, want_hist = kernels.window_diff_plain(*args)
    assert torch.equal(diff, want) and torch.equal(new_hist, want_hist)
    # the next block takes the new history (a view where n-1 <= T)
    nxt = torch.randint(0, 256, args[1].shape, dtype=torch.uint8,
                        device=cuda_device)
    got2 = kernels.window_diff(new_hist, nxt, *args[2:])
    want2 = kernels.window_diff_plain(want_hist, nxt, *args[2:])
    assert torch.equal(got2[0], want2[0]) and torch.equal(got2[1], want2[1])


@pytest.mark.cuda
def test_window_diff_streams_equal_single_streams_on_card(cuda_device):
    """The stream launch equals one launch per stream."""
    args = window_diff_stream_case(WINDOW_DIFF_STREAM_CASES[5], cuda_device,
                                   SEED)
    hist, frames, n, timer0, step = args
    diff, _ = kernels.window_diff(*args)
    for i in range(frames.shape[0]):
        one, _ = kernels.window_diff(hist[i], frames[i], n,
                                     timer0 + i * step)
        assert torch.equal(diff[i], one)


@pytest.mark.cuda
@pytest.mark.parametrize("t_block,h,w,offset", MEDIAN_CASES)
def test_median_binarize_close_on_card_ragged(cuda_device, t_block, h, w,
                                              offset):
    rng = np.random.default_rng([SEED, t_block, h, w])
    diff = rng.integers(0, 30, (t_block, h, w), dtype=np.uint8)
    diff[rng.random(diff.shape) < 0.01] = 255
    thr = rng.integers(2, 12, t_block, dtype=np.uint8)
    thr[0], thr[-1] = 0, 255
    diff = _on_card(diff, cuda_device, offset)
    thr = torch.from_numpy(thr).to(cuda_device)
    kernels.reset_launch_counts()
    got = kernels.median_binarize_close(diff, thr)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["median_binarize_close"] == 1
    assert torch.equal(got, kernels.median_binarize_close_plain(diff, thr))


# VOTE_CASES and PICK_CASES (ops/kernel_cases.py): odd and long point lists,
# none or one bin's worth of valid points, n_rho from 128 to the largest,
# T = 1 and 64, K = 1..64, S = 128..1024, rows all outside the plane, inputs
# 4 bytes into their storage


@pytest.mark.cuda
@pytest.mark.parametrize("case", VOTE_CASES, ids=[c[0] for c in VOTE_CASES])
def test_hough_vote_on_card_ragged(cuda_device, case):
    args = vote_case(case, cuda_device, SEED)
    kernels.reset_launch_counts()
    got = kernels.hough_vote(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hough_vote"] == 1
    want = kernels.hough_vote_plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PICK_CASES, ids=[c[0] for c in PICK_CASES])
def test_walk_pick_on_card_ragged(cuda_device, case):
    args = pick_case(case, cuda_device, SEED)
    kernels.reset_launch_counts()
    got = kernels.walk_pick(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["walk_pick"] == 1
    want = kernels.walk_pick_plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_hough_vote_refuses_too_many_rho_bins(cuda_device):
    args = vote_case(("n100", 1, 100, kernels.MAX_VOTE_RHO + 1, "prefix", 0),
                     cuda_device, SEED)
    with pytest.raises(ValueError):
        kernels.hough_vote(*args)


# PEAK_CASES (ops/kernel_cases.py): crafted planes (ties, borders and
# corners, exactly 64 and 65 peaks, votes at the cuts, every rung over 64,
# no peak) and random ones at [8, 180, 3072], T = 1 and 64, n_rho 128, 3071
# and the largest, votes 4 bytes into their storage


@pytest.mark.cuda
@pytest.mark.parametrize("case", PEAK_CASES, ids=[c[0] for c in PEAK_CASES])
def test_peak_ladder_on_card_ragged(cuda_device, case):
    """The kernel's mask and rung counts equal the plain version's bit for
    bit, and so does find_peaks on the card."""
    votes, threshold, cuts = peak_case(case, cuda_device, SEED)
    kernels.reset_launch_counts()
    got = kernels.peak_ladder(votes, threshold, cuts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["peak_ladder"] == 1
    want = kernels.peak_ladder_plain(votes, threshold, cuts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    got = hough.find_peaks(votes, threshold, PEAK_MAX)
    want = hough.find_peaks_plain(votes, threshold, PEAK_MAX)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_find_peaks_in_a_graph_equals_plain(cuda_device):
    """find_peaks captured in a CUDA graph and replayed on two other vote
    planes equals the eager plain op each time: the rung counts are zeroed
    again on every replay."""
    planes = [peak_case(("random", 8, 3072, "random", 0), cuda_device,
                        SEED + i)[0] for i in range(3)]
    votes = planes[0].clone()
    hough.find_peaks(votes, 10, PEAK_MAX)        # build, cache the cuts
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = hough.find_peaks(votes, 10, PEAK_MAX)
    for plane in planes[1:]:
        votes.copy_(plane)
        graph.replay()
        want = hough.find_peaks_plain(plane, 10, PEAK_MAX)
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_find_peaks_on_card_makes_no_rung_tensor(cuda_device):
    """At the main path's shape, [8, 180, 3072], find_peaks raises the
    card's allocation peak by under 64 MB: no [B, C, N] comparison and no
    [B, N] int64 (the plain route's peak is ~0.9 GiB)."""
    votes = peak_case(("random", 8, 3072, "random", 0), cuda_device,
                      SEED)[0]
    hough.find_peaks(votes, 10, PEAK_MAX)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    hough.find_peaks(votes, 10, PEAK_MAX)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 64 * 2 ** 20


# WALK_CASES (ops/kernel_cases.py): drawn segments and their peaks, crafted
# axis and diagonal walks both ways with rho at both ends, empty and dense
# frames, T = 1..8, S from 128 to 4096 and 200, portrait frames, peaks not
# ok, max_gap 0 and 1e7, inputs 8 bytes into their storage


@pytest.mark.cuda
@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_walk_kernels_on_card_ragged(cuda_device, case):
    """corner_planes, walk_geom and walk_finish each equal their plain
    versions bit for bit, one launch each."""
    c = walk_case(case, cuda_device, SEED)
    _, h, w = c.imgs01.shape
    geom = (c.rho_offset, c.n_steps, h, w)
    kernels.reset_launch_counts()
    planes = kernels.corner_planes(c.imgs01, c.s_dim)
    r, xmaj = kernels.walk_geom(c.theta_idx, c.rho_idx, *geom, c.s_dim)
    v = kernels.walk_pick(planes, r, xmaj)
    lines, ok = kernels.walk_finish(v, c.theta_idx, c.rho_idx, c.peak_ok,
                                    c.gaps, *geom, c.min_len)
    torch.cuda.synchronize()
    assert {name: kernels.LAUNCHES[name] for name in (
        "corner_planes", "walk_geom", "walk_pick", "walk_finish")} == {
        "corner_planes": 1, "walk_geom": 1, "walk_pick": 1, "walk_finish": 1}
    assert torch.equal(planes, kernels.corner_planes_plain(c.imgs01,
                                                           c.s_dim))
    want_r, want_x = kernels.walk_geom_plain(c.theta_idx, c.rho_idx, *geom,
                                             c.s_dim)
    assert torch.equal(r, want_r) and torch.equal(xmaj, want_x)
    want_lines, want_ok = kernels.walk_finish_plain(
        v, c.theta_idx, c.rho_idx, c.peak_ok, c.gaps, *geom, c.min_len)
    assert torch.equal(ok, want_ok) and torch.equal(lines, want_lines)
    if case[6] in ("lines", "crafted"):
        assert bool(ok.any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_walk_segments_on_card_equals_cpu(cuda_device, case):
    """hough.walk_segments on the card (four launches) equals its plain
    composition on the CPU."""
    got = walk_case(case, cuda_device, SEED)
    want = walk_case(case, "cpu", SEED)
    kw = dict(rho_offset=got.rho_offset, n_steps=got.n_steps,
              s_dim=got.s_dim, min_len=got.min_len)
    lines, ok = hough.walk_segments(*got[:5], **kw)
    want_lines, want_ok = hough.walk_segments(*want[:5], **kw)
    assert torch.equal(ok.cpu(), want_ok)
    assert torch.equal(lines.cpu(), want_lines)


@pytest.mark.cuda
def test_step_replay_launches_the_walk_kernels(cuda_device):
    """A replay of the main path's step graph (960x540 analysed, 64-frame
    blocks) launches each segment-walk kernel and walk_pick 8 times, once
    a chunk of 8 frames."""
    from metdetpy_tpu_torch import bench
    from metdetpy_tpu_torch.detectors import step_graph
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    det = bench._m3_detector(cfg, 540, 960, "cuda")
    block = torch.zeros((64, 540, 960), dtype=torch.uint8, device="cuda")
    det.process_block_async(block)            # the capture
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    det.process_block_async(block)            # one replay
    torch.cuda.synchronize()
    want = {"corner_planes": 8, "walk_geom": 8, "walk_pick": 8,
            "walk_finish": 8}
    assert {k: step_graph.CAPTURES[-1]["launches"][k] for k in want} == want
    assert {k: kernels.LAUNCHES[k] for k in want} == want


@pytest.mark.cuda
def test_mdrf_on_card_equals_cpu(cuda_device):
    w, h = 256, 144
    frames = generate_meteor_video(
        width=w, height=h, fps=25.0, duration_sec=6.5,
        meteors=[SynthMeteor(start_sec=2.4, end_sec=4.4,
                             pt1=(int(w * 0.45), int(h * 0.25)),
                             pt2=(int(w * 0.30), int(h * 0.55)))],
        n_stars=40, noise_sigma=3.0)
    got = {}
    for dev in ("cuda", "cpu"):
        cfg = MainDetectCfg.from_json_file(
            relative2abs_path("./config/m3det_normal.json"))
        cfg.loader.wrapper = "NumpyVideoWrapper"
        cfg.loader.resize = None
        cfg.loader.exp_time = "real-time"
        cfg.collector.recheck_cfg.switch = False
        got[dev] = [r.to_dict() for r in detect_video(
            frames, None, cfg, work_mode="backend", device=dev).results]
    assert any(t["category"] == "METEOR"
               for rec in got["cuda"] for t in rec["target"])
    assert got["cuda"] == got["cpu"]


# -- the deep-learning path on the card -------------------------------------

def _shipped_net(dtype, device):
    from metdetpy_tpu_torch.models import yolov5
    from metdetpy_tpu_torch.models.weights import params_from_flax
    with np.load(relative2abs_path("./weights/yolov5s_v5.flax.npz")) as data:
        sd = params_from_flax({k: data[k] for k in data.files})
    net = yolov5.YOLOv5(nc=8, dtype=dtype).eval()
    net.load_state_dict(sd, strict=True)
    return net.to(device)


@pytest.mark.cuda
def test_model_heads_on_card_match_cpu_float32(cuda_device, monkeypatch):
    """bfloat16 on the card against the port's float32 on the CPU: 99% of
    the values within 5% of the head's standard deviation, none beyond
    50%. float32 on the card (TF32 off) against the CPU: rtol 2e-4, atol
    2e-4 x max|head|."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(
        0, 1, (4, 320, 320, 3)).astype(np.float32))
    with torch.inference_mode():
        want = _shipped_net(torch.float32, "cpu")(x)
        got16 = _shipped_net(torch.bfloat16, cuda_device)(x.to(cuda_device))
        got32 = _shipped_net(torch.float32, cuda_device)(x.to(cuda_device))
    for g16, g32, w in zip(got16, got32, want):
        rel = (g16.cpu() - w).abs() / max(float(w.abs().std()), 1e-3)
        assert float(torch.quantile(rel.flatten(), 0.99)) < 0.05
        assert float(rel.max()) < 0.5
        torch.testing.assert_close(g32.cpu(), w, rtol=2e-4,
                                   atol=2e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_resize_on_card_in_full_float32_matches_cpu(cuda_device,
                                                    monkeypatch):
    """The cubic resize is two float32 products that follow the process's
    float32 matmul setting; with TF32 off (torch's default, set here for the
    test alone) the card agrees with the CPU to atol 1e-5, down and up."""
    from metdetpy_tpu_torch.models import yolo
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(
        0, 1, (3, 136, 120, 3)).astype(np.float32))
    for hw in ((80, 80), (160, 200)):
        want = yolo._resize_to(x, hw)
        got = yolo._resize_to(x.to(cuda_device), hw).cpu()
        assert tuple(got.shape) == (3, *hw, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_nms_compaction_orientation_on_card_equal_cpu(cuda_device):
    """``_sel_nms_device`` and ``_compact_kept_device`` exact; the
    orientation's ``ok`` exact and its sums rtol 1e-4 (atol 1e-4 x the
    weight total)."""
    from metdetpy_tpu_torch.detectors import mldet
    from metdetpy_tpu_torch.models import yolo
    rng = np.random.default_rng(SEED)
    sel = torch.from_numpy(np.concatenate([
        rng.uniform(0, 320, (16, 64, 2)), rng.uniform(2, 80, (16, 64, 2)),
        np.round(rng.uniform(0, 1, (16, 64, 1)), 2),
        rng.uniform(0, 1, (16, 64, 8))], axis=-1).astype(np.float32))
    want = yolo._sel_nms_device(sel, pos_thre=0.25, nms_thre=0.45)
    got = yolo._sel_nms_device(sel.to(cuda_device), pos_thre=0.25,
                               nms_thre=0.45)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for cap in (512, 16):
        want_c = yolo._compact_kept_device(sel, *want, cap)
        got_c = yolo._compact_kept_device(sel.to(cuda_device), *got, cap)
        for g, w in zip(got_c, want_c):
            assert torch.equal(g.cpu(), w)
    stacks = torch.from_numpy(rng.integers(0, 255, (8, 144, 256, 3),
                                           dtype=np.uint8))
    packed = yolo._compact_kept_device(sel, *want, 64)[0].clone()
    packed[:, 0] = packed[:, 0] % 8
    o_want = mldet._orient_from_packed(stacks, packed, 0.8, 0.45, 96)
    o_got = mldet._orient_from_packed(stacks.to(cuda_device),
                                      packed.to(cuda_device), 0.8, 0.45,
                                      96).cpu()
    assert torch.equal(o_got[:, 3], o_want[:, 3])
    ok = o_want[:, 3] > 0
    assert int(ok.sum()) > 8
    tol = 1e-4 * o_want[ok, :3].abs() + 1e-4 * o_want[ok, 2:3]
    assert bool(((o_got[ok, :3] - o_want[ok, :3]).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["dldet", "m3det_normal"])
def test_preset_with_recheck_on_card_matches_cpu(cuda_device, monkeypatch,
                                                 preset):
    """The shipped preset, recheck on, on a small colour clip: the card's
    targets against the CPU's (category and frames equal, points within
    2 px, scores within 0.03)."""
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    w, h = 256, 144
    frames = generate_meteor_video(
        width=w, height=h, fps=25.0, duration_sec=6.5,
        meteors=[SynthMeteor(start_sec=2.4, end_sec=4.4,
                             pt1=(int(w * 0.45), int(h * 0.25)),
                             pt2=(int(w * 0.30), int(h * 0.55)))],
        n_stars=40, noise_sigma=3.0, color=True)
    got = {}
    for dev in ("cuda", "cpu"):
        cfg = MainDetectCfg.from_json_file(
            relative2abs_path(f"./config/{preset}.json"))
        cfg.loader.wrapper = "NumpyVideoWrapper"
        cfg.loader.resize = None
        if cfg.loader.grayscale:
            cfg.loader.exp_time = "real-time"
        mdrf = detect_video(frames.copy(), None, cfg, work_mode="backend",
                            device=dev)
        got[dev] = [t for rec in mdrf.results for t in rec.target]
    assert got["cpu"] and len(got["cuda"]) == len(got["cpu"])
    for a, b in zip(got["cuda"], got["cpu"]):
        assert a.category == b.category
        assert (a.start_frame, a.last_activate_frame) == \
            (b.start_frame, b.last_activate_frame)
        assert max(abs(p - q) for p, q in zip([*a.pt1, *a.pt2],
                                              [*b.pt1, *b.pt2])) <= 2
        assert abs(a.score - b.score) <= 0.03
        assert a.recheck_score is not None
        assert abs(a.recheck_score - b.recheck_score) <= 0.03


# -- the loader's device feed and the photo batch upload ----------------------

def _feed_blocks(frames, device_put):
    from metdetpy_tpu_torch.io.videoloader import BlockVideoLoader
    from metdetpy_tpu_torch.io.videowrapper import NumpyVideoWrapper
    ld = BlockVideoLoader(NumpyVideoWrapper, frames, resize_option=[48, 32],
                          exp_option="real-time", merge_func="max",
                          grayscale=True, block_frames=8,
                          device_put=device_put, device="cuda")
    ld.start()
    out = []
    while (item := ld.pop_block()) is not None:
        if device_put:
            t, n = item
            assert t.is_cuda and t.shape[0] == 8
            assert bool((t[n:] == t[n - 1]).all())
            out.append(t[:n].cpu().numpy())
        else:
            out.append(np.array(item))
    stats = {**ld.spans.summary(), **ld.stage_stats}
    pinned = ld._pinned
    ld.release()
    return np.concatenate(out), stats, pinned


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["gray", "colour"])
def test_device_feed_on_card_equals_host_blocks(cuda_device, source):
    """The loader's uploads (a gray source at twice the runtime size: raw
    blocks and the device 2:1 preprocess; a colour source: pinned pool and
    side stream with the host preprocess) give the host path's blocks, the
    tail padded on the card."""
    shape = (21, 64, 96) + ((3,) if source == "colour" else ())
    frames = np.random.default_rng(SEED).integers(0, 255, shape, np.uint8)
    want, _, _ = _feed_blocks(frames, False)
    got, stats, pinned = _feed_blocks(frames, True)
    np.testing.assert_array_equal(got, want)
    assert stats["loader_h2d_bytes"] > 0
    assert stats["placement"] == ("device" if source == "gray" else "host")
    assert pinned


def _host_to_device_copies(prof, tmp_path):
    """(kind, bytes) of every host-to-device copy in a profile's trace."""
    import json
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], int(e.get("args", {}).get("bytes", 0)))
            for e in events if e.get("cat") == "gpu_memcpy"
            and e.get("name", "").startswith("Memcpy HtoD")]


@pytest.mark.cuda
@pytest.mark.parametrize("feed", ["gray_1080p", "dldet_colour"])
def test_detect_video_on_card_uploads_only_pinned_memory(
        cuda_device, monkeypatch, tmp_path, feed):
    """``detect_video`` on an in-memory 1920x1080 gray clip with a ragged
    tail (m3det_normal, the staged in-memory feed) and on a colour clip
    (dldet, one tail block out of the pool). In a profile of the card's
    call every host-to-device copy of a frame or more reads pinned memory
    and together they carry the loader's bytes, the gray clip's all
    staged from the caller's array, the colour clip's none; the M3 call
    copies nothing else from pageable memory (dldet's call does: the
    model's warm-up input and a few scalars). The records equal the CPU
    run's (dldet's as the recheck test holds them: category and frames
    equal, points within 2 px, scores within 0.03)."""
    from torch.profiler import ProfilerActivity, profile
    gray = feed == "gray_1080p"
    if gray:   # the raw upload and the device 2:1 preprocess
        w, h, secs, preset = 1920, 1080, 4.36, "m3det_normal"   # 64 + 45
    else:
        monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
        w, h, secs, preset = 320, 180, 6.5, "dldet"
    frames = generate_meteor_video(
        width=w, height=h, fps=25.0, duration_sec=secs,
        meteors=[SynthMeteor(start_sec=1.2, end_sec=2.6,
                             pt1=(int(w * 0.45), int(h * 0.25)),
                             pt2=(int(w * 0.30), int(h * 0.55)))],
        n_stars=60, noise_sigma=3.0, color=not gray)
    assert frames.shape[0] % 64

    def run(dev):
        cfg = MainDetectCfg.from_json_file(
            relative2abs_path(f"./config/{preset}.json"))
        cfg.loader.wrapper = "NumpyVideoWrapper"
        cfg.loader.resize = 960 if gray else None
        cfg.loader.exp_time = "real-time" if gray else cfg.loader.exp_time
        cfg.collector.recheck_cfg.switch = False
        return detect_video(frames.copy(), None, cfg, work_mode="backend",
                            device=dev)

    run("cuda")     # the kernels built, the step captured, the ring leased
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = run("cuda")
        torch.cuda.synchronize()
    copies = _host_to_device_copies(prof, tmp_path)
    perf = got.performance
    blocks = [(k, n) for k, n in copies if n >= frames[0].nbytes]
    assert blocks and all("Pinned" in k for k, _ in blocks), copies
    assert sum(n for _, n in blocks) == perf["loader_h2d_bytes"]
    if gray:
        assert not [c for c in copies if "Pageable" in c[0]], copies
    # dldet's exposure merges 12 frames (0.5 s at 25 fps) into one
    assert perf["loader_h2d_bytes"] == (
        frames.nbytes if gray else perf["frames"] // 12 * frames[0].nbytes)
    assert perf.get("loader_stage_bytes", 0) == (frames.nbytes if gray
                                                 else 0)
    want = run("cpu")
    if gray:
        assert got.results and [r.to_dict() for r in got.results] == \
            [r.to_dict() for r in want.results]
        return
    a_t = [t for rec in got.results for t in rec.target]
    b_t = [t for rec in want.results for t in rec.target]
    assert b_t and len(a_t) == len(b_t)
    for a, b in zip(a_t, b_t):
        assert a.category == b.category
        assert (a.start_frame, a.last_activate_frame) == \
            (b.start_frame, b.last_activate_frame)
        assert max(abs(p - q) for p, q in zip([*a.pt1, *a.pt2],
                                              [*b.pt1, *b.pt2])) <= 2
        assert abs(a.score - b.score) <= 0.03


@pytest.mark.cuda
def test_staging_ring_on_card_under_a_slow_consumer(cuda_device,
                                                    monkeypatch):
    """A staging ring of the least depth (two pinned slots under a queue
    of three) with a consumer that keeps the card busy and sleeps, over 44
    blocks of 16 MB: every block on the card equals its source frames, so
    no slot was refilled before the copy out of it had completed."""
    import time
    from metdetpy_tpu_torch.io import videoloader as tvl
    from metdetpy_tpu_torch.io.videowrapper import NumpyVideoWrapper
    monkeypatch.setattr(tvl, "_STAGE_RING_BYTES", 1)
    frames = np.random.default_rng(SEED).integers(
        0, 255, (44 * 16 - 5, 1080, 960), dtype=np.uint8)
    ld = tvl.BlockVideoLoader(NumpyVideoWrapper, frames, resize_option=None,
                              exp_option="real-time", merge_func="max",
                              grayscale=True, block_frames=16,
                              device_put=True, device="cuda")
    assert ld._pinned
    ld.start()
    n, a = 0, 0
    busy = torch.zeros((4096, 4096), device=cuda_device)
    while (item := ld.pop_block()) is not None:
        t, n_real = item
        busy @ busy   # the default stream busy while the next copies run
        time.sleep(0.003)
        assert torch.equal(t[:n_real].cpu(),
                           torch.from_numpy(frames[a:a + n_real]))
        n, a = n + 1, a + n_real
    perf = ld.spans.summary()
    assert ld._leased_pool[0][0] == 2
    ld.release()
    assert n == 44 and a == len(frames)
    assert perf["loader_stage_bytes"] == perf["loader_h2d_bytes"] \
        == frames.nbytes


@pytest.mark.cuda
def test_batch_pipeline_on_card_matches_forward_batch(cuda_device):
    """The photo batch through the pinned upload and the device path gives
    forward_batch's records on the same card."""
    from metdetpy_tpu_torch.models.pipeline import BatchPipeline
    from metdetpy_tpu_torch.models.yolo import YOLOModel
    m = YOLOModel(weight_path=relative2abs_path(
        "./weights/yolov5s_v5.flax.npz"), nms=True, input_hw=(96, 96),
        multiscale_pred=1, device="cuda")
    imgs = generate_meteor_video(width=160, height=128, fps=25.0,
                                 duration_sec=0.16, n_stars=30, color=True,
                                 seed=3)
    pipe = BatchPipeline(m, inflight=1)
    assert pipe.submit(list(range(len(imgs))), imgs) == []
    got = pipe.drain()
    want = m.forward_batch(imgs)
    assert len(got) == len(imgs)
    for (_, (gb, gc)), (wb, wc) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gb), np.asarray(wb))
        np.testing.assert_allclose(np.asarray(gc), np.asarray(wc),
                                   atol=1e-6)


def _mfnr_clip(seed=SEED, n=18, h=96, w=128):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, h, w, 3), np.uint8)
    for t in range(4, min(12, n)):
        x, y = 10 + 8 * (t - 4), 20 + 5 * (t - 4)
        frames[t, y:y + 3, x:x + 12] = 250
    return frames


@pytest.mark.cuda
@pytest.mark.parametrize("bg,host_reduce", [
    ("mean", "0"), ("mean", "1"), ("median", None),
    ("sigma-clipping", None), ("med-of-med", None)])
def test_device_mfnr_on_card_matches_cpu(cuda_device, monkeypatch, bg,
                                         host_reduce):
    """Device MFNR on the card against the same code on the CPU: within
    +/-1 in at most 0.1% of pixels (the scalar sums are float64 on both,
    in the two devices' orders), the same placement and bytes uploaded."""
    from metdetpy_tpu_torch.io.videoloader import ThreadVideoLoader
    from metdetpy_tpu_torch.io.videowrapper import NumpyVideoWrapper
    from metdetpy_tpu_torch.ops import stack_device
    from metdetpy_tpu_torch.structs import ClipCfg
    dn = ClipCfg.from_json_file(
        relative2abs_path("./global/clip_cfg.json")).image_denoise
    dn.mfnr_param.bg_algorithm = bg
    if host_reduce is not None:
        monkeypatch.setenv("METDETPY_TPU_MFNR_HOST_REDUCE", host_reduce)
    frames = _mfnr_clip()
    out, stats = {}, {}
    for dev in ("cuda", "cpu"):
        loader = ThreadVideoLoader(NumpyVideoWrapper, frames.copy(),
                                   exp_option="real-time", merge_func="max",
                                   grayscale=False)
        out[dev] = stack_device.mfnr_mix_device(loader, dn, device=dev)
        stats[dev] = dict(stack_device.last_run_stats)
    d = np.abs(out["cuda"].astype(np.int16) - out["cpu"].astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 0.001
    for key in ("placement", "h2d_bytes"):
        assert stats["cuda"][key] == stats["cpu"][key]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 8])
def test_device_median_on_card_equals_host(cuda_device, monkeypatch, n):
    from metdetpy_tpu_torch.ops import stack
    rng = np.random.default_rng(SEED)
    frames = list(rng.integers(0, 256, (n, 40, 56, 3), np.uint8))
    got = stack.median_frames(torch.from_numpy(np.stack(frames)).cuda())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  stack._host_median(frames))
    monkeypatch.setattr(stack, "DEVICE_MEDIAN_MIN_ELEMS", 1)
    monkeypatch.setenv("METDETPY_TPU_DEVICE_MEDIAN", "force")
    np.testing.assert_array_equal(stack.stack_median(frames, device="cuda"),
                                  stack._host_median(frames))


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """One float32 training step (TF32 off) of full-width YOLOv5s from the
    shipped weights on a 96x96 batch of 2: the loss within rtol 1e-5 and
    every gradient within rtol 2e-4, atol 2e-4 x max|g| of the CPU's; the
    bfloat16 body's backward runs on the card (finite loss within 1% of
    the float32 one); the optimiser fed the CPU's gradients for 3 updates
    on both devices: rtol 1e-6, atol 1e-6 x max|p|."""
    from metdetpy_tpu_torch.models import train, yolov5
    from metdetpy_tpu_torch.models.weights import params_from_flax
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    with np.load(relative2abs_path("./weights/yolov5s_v5.flax.npz")) as d:
        sd = params_from_flax({k: d[k] for k in d.files})
    imgs, targets = train.synth_batch(np.random.default_rng(4), 2, (96, 96),
                                      8)
    got = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                       ("cuda", torch.bfloat16)):
        net = yolov5.YOLOv5(nc=8, dtype=dtype)
        net.load_state_dict(sd)
        net = net.to(dev)
        x, tg = train._place(imgs, targets, torch.device(dev))
        loss = train.yolo_loss(net(x), tg, 8)
        loss.backward()
        got[dev, dtype] = (float(loss), {k: p.grad.cpu() for k, p in
                                         net.named_parameters()})
    want_loss, want = got["cpu", torch.float32]
    loss, grads = got["cuda", torch.float32]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for k, g in want.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=2e-4,
                                   atol=2e-4 * float(g.abs().max()),
                                   err_msg=k)
    bf16_loss = got["cuda", torch.bfloat16][0]
    assert np.isfinite(bf16_loss)
    np.testing.assert_allclose(bf16_loss, want_loss, rtol=0.01)
    params = {}
    for dev in ("cpu", "cuda"):
        ps = [sd[k].clone().to(dev).requires_grad_() for k in want]
        opt = train.Adam(ps, train.cosine_decay_schedule(1e-3, 3, 0.05),
                         max_norm=5.0)
        for i in range(3):
            for p, k in zip(ps, want):
                p.grad = (want[k] * (1 + 50 * i)).to(dev)
            opt.step()
        params[dev] = [p.detach().cpu() for p in ps]
    for k, a, b in zip(want, params["cuda"], params["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=k)


@pytest.mark.cuda
def test_evaluate_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                      capsys):
    """``python -m metdetpy_tpu_torch.evaluate --metric`` on the annotated
    synthetic clip (m3det_normal, Block loader at the raw size, real-time,
    recheck off) on the card and on the CPU: recall 1.0 and the same
    printed summary and mismatches."""
    import json
    from metdetpy_tpu_torch import evaluate
    from metdetpy_tpu_torch.synth import write_annotated_clip
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    anno = write_annotated_clip(str(tmp_path))
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = "BlockVideoLoader"
    cfg.loader.resize = None
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = False
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    outs = {}
    for dev in ("cuda", "cpu"):
        cwd = tmp_path / dev
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        evaluate.main([anno, "--cfg", str(cfg_path), "--metric",
                       "--device", dev])
        out = capsys.readouterr().out
        table = out.index("PRED\\BASE")
        summary = out[out.rindex("{'", 0, table):table]
        outs[dev] = (summary,
                     json.loads((cwd / "mismatch.json").read_text())[
                         "results"])
    assert "'recall': 1.0" in outs["cuda"][0]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("timer0,timer_step", [(0, 0), (3, 0), (4, 0),
                                               (100, 0), (2, 3), (0, 9)])
def test_window_diff_reads_the_timer_on_the_card(cuda_device, timer0,
                                                 timer_step):
    """The kernel reads the frame timer from a device int32 and clamps it
    to n itself: equal to the plain version for timers below, at and past
    n, with a stream axis whose streams start timer_step frames apart."""
    rng = np.random.default_rng(SEED + timer0)
    n, t_block, h, w = 5, 6, 37, 150
    hist = torch.from_numpy(rng.integers(0, 256, (3, n - 1, h, w),
                                         dtype=np.uint8)).to(cuda_device)
    frames = torch.from_numpy(rng.integers(0, 256, (3, t_block, h, w),
                                           dtype=np.uint8)).to(cuda_device)
    timer = torch.tensor(timer0, dtype=torch.int32, device=cuda_device)
    got = kernels.window_diff(hist, frames, n, timer, timer_step)
    want = kernels.window_diff_plain(hist, frames, n, timer, timer_step)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 12])
def test_step_graph_on_card_equals_cpu_step(cuda_device, n):
    """M3Detector's graph on the card, block after block from stream
    start (the history within and beyond the 8-frame block), equals the
    port's functional step on the CPU: packed, dst and every carry; each
    replay adds its kernels to the launch counts."""
    from metdetpy_tpu_torch.detectors import m3det, step_graph
    from metdetpy_tpu_torch.log import BaseMetLog
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json")).detector.cfg
    h, w, t = 64, 96, 8
    frames = generate_meteor_video(
        width=w, height=h, fps=25.0, duration_sec=7 * t / 25.0,
        meteors=[SynthMeteor(start_sec=0.6, end_sec=1.6, pt1=(70, 12),
                             pt2=(20, 50))], n_stars=12, noise_sigma=2.5)
    dets = {d: m3det.M3Detector((n + 0.5) / 25.0, 25.0,
                                np.ones((h, w), np.uint8), 4,
                                cfg, BaseMetLog(), max_points=1024,
                                device=d) for d in ("cuda", "cpu")}
    step_graph.clear_idle()
    n_caps = len(step_graph.CAPTURES)
    for b in range(7):
        block = frames[b * t:(b + 1) * t]
        kernels.reset_launch_counts()
        got = dets["cuda"].process_block_async(block)
        torch.cuda.synchronize()
        if b:
            assert kernels.LAUNCHES == step_graph.CAPTURES[-1]["launches"]
        want = dets["cpu"].process_block_async(block)
        for a, e in zip(got, want):
            assert torch.equal(a.cpu(), e)
        for name in ("_gray_hist", "_sub_hist", "_dy_hist", "_timer_dev"):
            assert torch.equal(getattr(dets["cuda"], name).cpu(),
                               getattr(dets["cpu"], name)), name
        for a, e in zip(dets["cuda"]._ema.tensors(),
                        dets["cpu"]._ema.tensors()):
            assert torch.equal(a.cpu(), e)
    assert len(step_graph.CAPTURES) == n_caps + 1


@pytest.mark.cuda
def test_step_graph_captures_with_the_collector_off(cuda_device,
                                                    monkeypatch):
    """No automatic collection runs inside a capture (one could free a
    dropped detector's graph there, which fails the capture): the
    collector is off while the step is captured and on again after."""
    import gc
    from metdetpy_tpu_torch.detectors import m3det, step_graph
    from metdetpy_tpu_torch.log import BaseMetLog
    seen = []
    pick = kernels.walk_pick

    def spy(*args):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return pick(*args)

    monkeypatch.setattr(kernels, "walk_pick", spy)
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json")).detector.cfg
    step_graph.clear_idle()
    det = m3det.M3Detector(0.4, 25.0, np.ones((40, 72), np.uint8), 4, cfg,
                           BaseMetLog(), max_points=1024, device="cuda")
    assert gc.isenabled()
    det.process_block_async(np.zeros((8, 40, 72), np.uint8))
    torch.cuda.synchronize()
    assert seen and not any(seen) and gc.isenabled()


@pytest.mark.cuda
def test_step_graph_on_another_card_than_the_current(cuda_device):
    """With cuda:0 current, an M3Detector on cuda:1 captures its step's
    graph on cuda:1 and replays it there: the timer advances, and every
    block's packed buffer, dst and carries equal the eager step's on
    cuda:1 bit for bit; cuda:0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    from metdetpy_tpu_torch.detectors import m3det, step_graph
    from metdetpy_tpu_torch.log import BaseMetLog
    cfg = MainDetectCfg.from_json_file(
        relative2abs_path("./config/m3det_normal.json")).detector.cfg
    h, w, t = 64, 96, 8
    frames = generate_meteor_video(
        width=w, height=h, fps=25.0, duration_sec=5 * t / 25.0,
        meteors=[SynthMeteor(start_sec=0.6, end_sec=1.6, pt1=(70, 12),
                             pt2=(20, 50))], n_stars=12, noise_sigma=2.5)
    card = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    det, ref = (m3det.M3Detector(0.4, 25.0, np.ones((h, w), np.uint8), 4,
                                 cfg, BaseMetLog(), max_points=1024,
                                 device=card) for _ in range(2))
    kw = det._step_static_kwargs()
    step_graph.clear_idle()
    n_caps = len(step_graph.CAPTURES)
    carry = [ref._gray_hist, ref._sub_hist, ref._dy_hist, ref._ema,
             ref._timer_dev]
    for b in range(5):
        block = torch.from_numpy(frames[b * t:(b + 1) * t]).to(card)
        got = det.process_block_async(block)
        out = m3det._m3_block_step(*carry[:4], block, carry[4], **kw)
        carry = list(out[2:])
        torch.cuda.synchronize(card)
        assert torch.cuda.current_device() == 0
        assert got[0].device == card and det._timer_dev.device == card
        assert int(det._timer_dev) == (b + 1) * t
        for a, e in zip(got, out[:2]):
            assert torch.equal(a, e)
        for a, e in zip(step_graph._tensors(
                [det._gray_hist, det._sub_hist, det._dy_hist, det._ema,
                 det._timer_dev]), step_graph._tensors(carry)):
            assert torch.equal(a, e)
    caps = step_graph.CAPTURES[n_caps:]
    assert len(caps) == 1 and caps[0]["key"][2] == "cuda:1"
