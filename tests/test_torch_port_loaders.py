"""PyTorch port's loader layer on the CPU: the frames of every loader
against the JAX package's loaders, the device-put mode (staging, the tail
block, the uploader's EOS order, the device preprocess and the placement
its input decides), the per-frame loop, the process loader's host-only worker, the
recheck's second loader, and ``detect_video`` in each feed mode against
the JAX package's MDRF.

Each package gets its own copy of an in-memory clip (the JAX loader writes
colour stacks into a numpy source).
"""

import time

import numpy as np
import pytest
import torch

from metdetpy_tpu.api import detect_video as jax_detect_video
from metdetpy_tpu.io import videoloader as jvl
from metdetpy_tpu.io.videowrapper import NumpyVideoWrapper as JNumpy
from metdetpy_tpu.structs import MainDetectCfg
from metdetpy_tpu.synth import SynthMeteor, generate_meteor_video
from metdetpy_tpu.utils import relative2abs_path
from metdetpy_tpu_torch import get_loader, get_model, get_writer
from metdetpy_tpu_torch.api import detect_video
from metdetpy_tpu_torch.io import videoloader as tvl
from metdetpy_tpu_torch.io.videowrapper import NumpyVideoWrapper as TNumpy
from metdetpy_tpu_torch.structs import MainDetectCfg as TMainDetectCfg

torch.set_num_threads(2)


def _slow_shutter_video(n_exposures=24, exp_frames=2, h=32, w=48, seed=5,
                        color=False):
    rng = np.random.default_rng(seed)
    frames = []
    shape = (h, w, 3) if color else (h, w)
    for _ in range(n_exposures):
        img = rng.integers(20, 200, shape).astype(np.int16)
        for _ in range(exp_frames):
            frames.append(np.clip(img + rng.normal(0, 2, img.shape), 0,
                                  255).astype(np.uint8))
    return np.stack(frames)


def _blocks(loader):
    """Every block of a started loader, as host arrays (device-put pairs
    cut to their real frames)."""
    loader.start()
    out = []
    while True:
        item = loader.pop_block()
        if item is None:
            break
        if isinstance(item, tuple):
            t, n_real = item
            out.append(t[:n_real].numpy().copy())
        else:
            out.append(np.array(item))
    loader.release()
    return out


def _frames(loader):
    loader.start()
    out = []
    for _ in range(loader.iterations):
        f = loader.pop()
        if f is None:
            break
        out.append(np.array(f))
        if loader.stopped:
            break
    loader.release()
    return out


def test_registry_resolves_every_loader_and_the_model():
    for name in ("VanillaVideoLoader", "ThreadVideoLoader",
                 "BlockVideoLoader", "ProcessVideoLoader"):
        assert get_loader(name).__name__ == name
    assert get_model("YOLOModel").__name__ == "YOLOModel"
    assert get_writer("OpenCVVideoWriter").__name__ == "OpenCVVideoWriter"


@pytest.mark.parametrize("case", ["gray_merge", "color_to_gray_resize",
                                  "color_out"])
def test_block_loader_frames_match_jax(case):
    frames = {"gray_merge": _slow_shutter_video(),
              "color_to_gray_resize": _slow_shutter_video(color=True),
              "color_out": _slow_shutter_video(color=True)}[case]
    kw = dict(exp_option=2 / 25, merge_func="max", block_frames=8,
              grayscale=case != "color_out")
    if case != "gray_merge":
        kw["resize_option"] = [24, 16]
    want = _blocks(jvl.BlockVideoLoader(JNumpy, frames.copy(), **kw))
    got = _blocks(tvl.BlockVideoLoader(TNumpy, frames.copy(), **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_block_loader_color_stacks_match_jax():
    frames = np.random.default_rng(0).integers(0, 255, (48, 24, 32, 3),
                                               dtype=np.uint8)
    kw = dict(exp_option="real-time", merge_func="max", grayscale=True,
              keep_color_stacks=True, block_frames=16)
    stacks = []
    for mod, wrap in ((jvl, JNumpy), (tvl, TNumpy)):
        ld = mod.BlockVideoLoader(wrap, frames.copy(), **kw)
        _blocks(ld)
        stacks.append([ld.recheck_stack(a, b) for a, b in
                       ((0, 47), (3, 20), (16, 31), (40, 47))])
    for a, b in zip(*stacks):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["VanillaVideoLoader", "ThreadVideoLoader"])
def test_frame_loaders_match_jax(name):
    frames = _slow_shutter_video(color=True)
    kw = dict(exp_option=2 / 25, merge_func="max", grayscale=True,
              resize_option=[24, 16])
    want = _frames(getattr(jvl, name)(JNumpy, frames.copy(), **kw))
    got = _frames(getattr(tvl, name)(TNumpy, frames.copy(), **kw))
    assert len(got) == len(want) >= 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_thread_loader_survives_stalled_consumer(monkeypatch):
    monkeypatch.setattr(tvl, "PUT_TIMEOUT", 0.05)
    frames = np.arange(12, dtype=np.uint8).reshape(12, 1, 1) \
        * np.ones((12, 8, 8), np.uint8)
    ld = tvl.ThreadVideoLoader(TNumpy, frames, maxsize=1,
                               exp_option="real-time", merge_func="max",
                               grayscale=True)
    ld.start()
    got = []
    import time
    for i in range(12):
        if i == 2:
            time.sleep(0.5)
        got.append(int(ld.pop()[0, 0]))
    ld.stop()
    assert got == list(range(12))


@pytest.mark.parametrize("keep_color", [False, True])
def test_process_loader_matches_block_loader_and_stays_off_cuda(keep_color):
    """The process loader's blocks (and colour stacks) equal the in-process
    loader's and the JAX process loader's; its worker reports that it
    never initialised CUDA."""
    frames = _slow_shutter_video(color=True)
    kw = dict(exp_option=2 / 25, merge_func="max", grayscale=True,
              block_frames=8, resize_option=[24, 16],
              keep_color_stacks=keep_color)
    ref = tvl.BlockVideoLoader(TNumpy, frames.copy(), **kw)
    want = _blocks(ref)
    ld = tvl.ProcessVideoLoader(TNumpy, frames.copy(), **kw)
    got = _blocks(ld)
    assert ld.worker_cuda_initialized is False
    jld = jvl.ProcessVideoLoader(JNumpy, frames.copy(), **kw)
    jgot = _blocks(jld)
    assert len(got) == len(want) == len(jgot)
    for a, b, c in zip(got, want, jgot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if keep_color:
        np.testing.assert_array_equal(ld.recheck_stack(0, 23),
                                      ref.recheck_stack(0, 23))


# (source frames, resize option, the placement the input decides)
PUT_SOURCES = {
    "gray_runtime_size": ((32, 48), None, "device"),
    "gray_2to1": ((32, 48), [24, 16], "device"),
    "gray_other_resize": ((32, 48), [30, 20], "host"),
    "colour": ((32, 48, 3), [24, 16], "host"),
}


@pytest.mark.parametrize("source", list(PUT_SOURCES))
def test_device_put_mode_stages_padded_tensors(source):
    """On the CPU the staging is a copy into a fresh tensor: pairs of
    (block_frames-frame tensor, n_real), the tail padded with its last
    frame, in order, the EOS behind the last upload; the bytes counted.
    The input decides the placement: a gray frame at the runtime size or
    twice it takes the raw loop (an in-memory source staged into the
    ring's slots, the device preprocess after the upload), another
    resize and a colour source the host preprocess."""
    hw, resize, placement = PUT_SOURCES[source]
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (21,) + hw, dtype=np.uint8)
    kw = dict(exp_option="real-time", merge_func="max", grayscale=True,
              block_frames=8, resize_option=resize)
    host = _blocks(tvl.BlockVideoLoader(TNumpy, frames, **kw))
    ld = tvl.BlockVideoLoader(TNumpy, frames, device_put=True, **kw)
    assert ld.device_put_mode and not ld._pinned
    ld.start()
    pairs = []
    while (item := ld.pop_block()) is not None:
        pairs.append((item[0].clone(), item[1]))
    stats = dict(ld.stage_stats)
    perf = ld.spans.summary()
    with pytest.raises(AssertionError, match="device_put"):
        ld.pop()
    ld.release()
    assert [n for _, n in pairs] == [8, 8, 5]
    for (t, n), h in zip(pairs, host):
        assert isinstance(t, torch.Tensor) and t.shape[0] == 8
        np.testing.assert_array_equal(t[:n].numpy(), h)
        assert bool((t[n:] == t[n - 1]).all())
    assert perf["loader_h2d_bytes"] == (
        frames.nbytes if placement == "device"
        else sum(h.nbytes for h in host))
    assert perf["loader_h2d_s"] > 0
    assert stats["placement"] == placement


def test_device_preproc_gate_conditions():
    gray = np.zeros((8, 32, 48), np.uint8)

    def gate(**kw):
        kw.setdefault("exp_option", "real-time")
        kw.setdefault("merge_func", "max")
        kw.setdefault("grayscale", True)
        kw.setdefault("device_put", True)
        kw.setdefault("block_frames", 8)
        return tvl.BlockVideoLoader(TNumpy, gray, **kw)._device_preproc_gate()

    assert gate(resize_option=[24, 16]) is True
    assert gate(resize_option=None) is False
    assert gate(resize_option=[30, 20]) is None
    assert gate(resize_option=[24, 16], grayscale=False) is None
    assert gate(resize_option=[24, 16], keep_color_stacks=True) is None
    assert gate(resize_option=[24, 16], device_put=False) is None
    slow = _slow_shutter_video(exp_frames=2, n_exposures=8)
    assert tvl.BlockVideoLoader(
        TNumpy, slow, resize_option=[24, 16], exp_option=2 / 25,
        merge_func="max", grayscale=True, device_put=True,
        block_frames=8)._device_preproc_gate() is None


def test_placement_follows_the_gate_at_every_start(monkeypatch):
    """The placement is the gate's, with no probe: each start of a
    loader takes the same loop and gives the same blocks, a gray feed
    at twice the runtime size the device preprocess, and the host one
    where the gate is made to refuse it."""
    frames = np.random.default_rng(3).integers(0, 255, (21, 32, 48),
                                               dtype=np.uint8)
    kw = dict(resize_option=[24, 16], exp_option="real-time",
              merge_func="max", grayscale=True, block_frames=8)
    want = np.concatenate(_blocks(tvl.BlockVideoLoader(TNumpy, frames,
                                                       **kw)))
    for refused in (False, True):
        ld = tvl.BlockVideoLoader(TNumpy, frames, device_put=True, **kw)
        if refused:
            monkeypatch.setattr(ld, "_device_preproc_gate", lambda: None)
        for _ in range(3):
            ld.start()
            got = []
            while (item := ld.pop_block()) is not None:
                got.append(item[0][:item[1]].numpy().copy())
            np.testing.assert_array_equal(np.concatenate(got), want)
            assert ld.stage_stats == {
                "placement": "host" if refused else "device"}
            assert not any("probe" in k for k in ld.spans.summary())
        ld.release()


@pytest.mark.parametrize("source", ["gray_memory", "gray_frames", "color"])
def test_device_preprocess_stream_equals_host_path(source):
    """The raw-block loop with the device preprocess gives the host path's
    blocks: the staged in-memory gray source and a gray source read frame
    by frame; a colour source, seen in its first frames, goes to the host
    loop and gives them too."""
    rng = np.random.default_rng(11)
    color = source == "color"
    shape = (21, 32, 48, 3) if color else (21, 32, 48)
    frames = rng.integers(0, 255, shape, dtype=np.uint8)
    if source == "gray_frames":
        frames = np.asfortranarray(frames)     # not the staged layout
    kw = dict(resize_option=[24, 16], exp_option="real-time",
              merge_func="max", grayscale=True, block_frames=8)
    host = np.concatenate(_blocks(tvl.BlockVideoLoader(TNumpy, frames,
                                                       **kw)))
    ld = tvl.BlockVideoLoader(TNumpy, frames, device_put=True, **kw)
    dev = np.concatenate(_blocks(ld))
    np.testing.assert_array_equal(dev, host)
    assert ld.stage_stats["placement"] == ("host" if color else "device")


def _raw_feed(frames, **kw):
    """A device-put block loader on the CPU over an in-memory gray clip at
    its own size (the raw loop, device preprocess), 8-frame blocks."""
    kw = dict(dict(resize_option=None, exp_option="real-time",
                   merge_func="max", grayscale=True, block_frames=8,
                   device_put=True), **kw)
    return tvl.BlockVideoLoader(TNumpy, frames, **kw)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("n_frames", [16, 21, 1])
def test_in_memory_feed_stages_blocks_equal_to_the_source(n_frames,
                                                          threads):
    """An in-memory gray feed in device-put mode is staged block by block
    into the leased ring (whole blocks, a ragged tail, a one-frame clip;
    the copy on one thread or several), and uploads what it staged: every
    block equals the source's frames, and the staged bytes are the
    uploaded bytes, the clip's."""
    frames = np.random.default_rng(n_frames).integers(
        0, 255, (n_frames, 64, 96), dtype=np.uint8)  # > torch's copy grain
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        ld = _raw_feed(frames)
        blocks = _blocks(ld)
    finally:
        torch.set_num_threads(before)
    perf = ld.spans.summary()
    assert [len(b) for b in blocks] == [min(8, n_frames - a)
                                        for a in range(0, n_frames, 8)]
    np.testing.assert_array_equal(np.concatenate(blocks), frames)
    assert perf["loader_h2d_bytes"] == perf["loader_stage_bytes"] \
        == frames.nbytes
    assert perf["loader_stage_calls"] == len(blocks)
    assert ld.stage_stats["placement"] == "device"
    # one lease of UPLOAD_DEPTH + 2 slots, back in the cache
    key = ((tvl.BlockVideoLoader.UPLOAD_DEPTH + 2, 8, 64, 96), False)
    assert tvl._POOL_CACHE.get(key)


@pytest.mark.parametrize("slots", [2, tvl.BlockVideoLoader.UPLOAD_DEPTH + 2])
def test_staging_ring_refills_a_slot_only_after_its_upload(monkeypatch,
                                                           slots):
    """A ring of the least depth (two slots, under a queue of three) and
    one of the full depth, with a slow upload and a slow consumer, over
    44 blocks: every uploaded block equals its source frames, so no slot
    was refilled before the copy out of it had completed, and no slot was
    handed out twice."""
    if slots == 2:
        monkeypatch.setattr(tvl, "_STAGE_RING_BYTES", 1)
    frames = np.random.default_rng(7).integers(0, 255, (44 * 8 - 3, 16, 24),
                                               dtype=np.uint8)
    ld = _raw_feed(frames)
    held, fault = set(), []
    take, freer = tvl._StagingRing.take, tvl._StagingRing.freer
    stage = ld._stage_block

    def checked_take(ring, stopped):
        i = take(ring, stopped)
        if i in held:
            fault.append(i)
        held.add(i)
        return i

    def checked_freer(ring, i):
        free = freer(ring, i)

        def f():
            held.discard(i)
            free()
        return f

    def slow_stage(block):
        time.sleep(0.002)
        return stage(block)

    monkeypatch.setattr(tvl._StagingRing, "take", checked_take)
    monkeypatch.setattr(tvl._StagingRing, "freer", checked_freer)
    ld._stage_block = slow_stage
    ld.start()
    got = []
    while (item := ld.pop_block()) is not None:
        time.sleep(0.001)
        got.append(item[0][:item[1]].clone().numpy())
    assert len(ld._leased_pool[1][0]) == slots
    ld.release()
    assert ld._leased_pool is None
    assert len(got) == 44 and not fault
    np.testing.assert_array_equal(np.concatenate(got), frames)


def test_decoded_colour_feed_stages_nothing_and_sends_its_tail_from_the_pool(
        monkeypatch):
    """A colour feed (the host loop) stages nothing from the caller's
    memory; its ragged tail block goes to the upload as a view of its pool
    slot, not a copy, and arrives equal to the host path's."""
    frames = _slow_shutter_video(n_exposures=21, exp_frames=1, color=True)
    kw = dict(exp_option="real-time", merge_func="max", grayscale=False,
              block_frames=8)
    host = _blocks(tvl.BlockVideoLoader(TNumpy, frames, **kw))
    ld = tvl.BlockVideoLoader(TNumpy, frames, device_put=True, **kw)
    sent = []
    put = ld._put_block

    def record(block, free=None):
        sent.append((block, [np.shares_memory(block, s)
                             for s in ld._leased_pool[1]]))
        put(block, free)

    ld._put_block = record
    got = _blocks(ld)
    perf = ld.spans.summary()
    assert perf.get("loader_stage_bytes", 0) == 0
    assert perf["loader_h2d_bytes"] == frames.nbytes
    assert [len(b) for b, _ in sent] == [8, 8, 5]
    assert all(any(shared) for _, shared in sent)
    for a, b in zip(got, host):
        np.testing.assert_array_equal(a, b)


def test_host_mode_tail_block_does_not_alias_the_pool():
    """In host mode pop_block hands out the blocks themselves: the whole
    ones are views of the pool, but the ragged tail is a copy, since the
    next lease of the pool overwrites it."""
    frames = _slow_shutter_video(n_exposures=21, exp_frames=1)
    kw = dict(exp_option="real-time", merge_func="max", grayscale=True,
              block_frames=8)
    ld = tvl.BlockVideoLoader(TNumpy, frames, **kw)
    ld.start()
    blocks = []
    while (item := ld.pop_block()) is not None:
        blocks.append(item)
    pool = ld._leased_pool[1]
    ld.release()
    tail = blocks[-1]
    assert len(tail) == 5
    assert not any(np.shares_memory(tail, s) for s in pool)
    again = tvl.BlockVideoLoader(TNumpy, 255 - frames, **kw)
    _blocks(again)   # leases and overwrites the same pool
    np.testing.assert_array_equal(tail, frames[16:])


W, H, FPS = 256, 144, 25.0


@pytest.fixture(scope="module")
def clip_2x():
    """A gray clip at twice the runtime size (512x288 -> 256x144)."""
    return generate_meteor_video(
        width=2 * W, height=2 * H, fps=FPS, duration_sec=4.0,
        meteors=[SynthMeteor(1.0, 2.2, (int(2 * W * .7), int(2 * H * .3)),
                             (int(2 * W * .35), int(2 * H * .7)))],
        n_stars=40, noise_sigma=3.0, seed=9)


def _cfg(cls, loader="BlockVideoLoader", resize=W, recheck=False):
    cfg = cls.from_json_file(relative2abs_path("./config/m3det_normal.json"))
    cfg.loader.name = loader
    cfg.loader.wrapper = "NumpyVideoWrapper"
    cfg.loader.resize = resize
    cfg.loader.exp_time = "real-time"
    cfg.collector.recheck_cfg.switch = recheck
    return cfg


def _dicts(mdrf):
    return [r.to_dict() for r in mdrf.results]


@pytest.mark.parametrize("mode", ["device_put", "host", "gate_refused"])
def test_detect_video_feed_modes_match_jax(clip_2x, monkeypatch, mode):
    """detect_video on a 2:1 gray clip: the loader's device-put mode (the
    default, where the input puts the preprocess on the device), the
    detector uploading (the loader's upload off through the api's
    decision), and device-put mode at a resize the gate refuses (the host
    preprocess): the same MDRF as the JAX package; which placement ran is
    in the performance."""
    from metdetpy_tpu_torch import api as tapi
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    resize = 320 if mode == "gate_refused" else W
    want = jax_detect_video(clip_2x.copy(), None,
                            _cfg(MainDetectCfg, resize=resize),
                            work_mode="backend")
    if mode == "host":
        monkeypatch.setattr(tapi, "_loader_uploads", lambda *a: False)
    got = detect_video(clip_2x.copy(), None,
                       _cfg(TMainDetectCfg, resize=resize),
                       work_mode="backend", device="cpu")
    assert any(t.category == "METEOR" for r in want.results
               for t in r.target)
    assert _dicts(got) == _dicts(want)
    perf = got.performance
    assert perf["loader_placement"] == (
        "device" if mode == "device_put" else "host")
    if mode == "host":
        assert "loader_h2d_bytes" not in perf
    elif mode == "device_put":
        assert perf["loader_h2d_bytes"] == clip_2x.nbytes
    else:
        assert perf["loader_h2d_bytes"] == perf["frames"] * 320 * 180


@pytest.fixture(scope="module")
def clip():
    return generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=6.5,
        meteors=[SynthMeteor(2.4, 4.4, (int(W * 0.45), int(H * 0.25)),
                             (int(W * 0.30), int(H * 0.55)))],
        n_stars=40, noise_sigma=3.0)


@pytest.mark.parametrize("loader", ["VanillaVideoLoader", "ThreadVideoLoader",
                                    "ProcessVideoLoader"])
def test_detect_video_loaders_match_block_loader_and_jax(clip, monkeypatch,
                                                         loader):
    """The per-frame loop (Vanilla, Thread) and the process loader give the
    block loader's MDRF, and the JAX package's with the same loader."""
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    block = detect_video(clip.copy(), None,
                         _cfg(TMainDetectCfg, resize=None),
                         work_mode="backend", device="cpu")
    got = detect_video(clip.copy(), None,
                       _cfg(TMainDetectCfg, loader, resize=None),
                       work_mode="backend", device="cpu")
    want = jax_detect_video(clip.copy(), None,
                            _cfg(MainDetectCfg, loader, resize=None),
                            work_mode="backend")
    assert any(t.category == "METEOR" for r in got.results for t in r.target)
    assert _dicts(got) == _dicts(block) == _dicts(want)


def _targets(mdrf):
    return [t for rec in mdrf.results for t in rec.target]


def test_recheck_through_a_second_loader_matches_jax(monkeypatch):
    """A per-frame loader with the recheck on re-reads each clip through a
    second, colour loader: the records agree with the JAX package's
    (category and frames equal, points exact, scores within 0.03)."""
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    colour = generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=6.5,
        meteors=[SynthMeteor(2.4, 4.4, (int(W * 0.45), int(H * 0.25)),
                             (int(W * 0.30), int(H * 0.55)))],
        n_stars=40, noise_sigma=3.0, color=True)
    want = _targets(jax_detect_video(
        colour.copy(), None,
        _cfg(MainDetectCfg, "VanillaVideoLoader", None, recheck=True),
        work_mode="backend"))
    got = _targets(detect_video(
        colour.copy(), None,
        _cfg(TMainDetectCfg, "VanillaVideoLoader", None, recheck=True),
        work_mode="backend", device="cpu"))
    assert want and len(got) == len(want)
    assert any(t.recheck_score is not None for t in got)
    for a, b in zip(got, want):
        assert (a.category, a.start_frame, a.last_activate_frame,
                a.pt1, a.pt2) == (b.category, b.start_frame,
                                  b.last_activate_frame, b.pt1, b.pt2)
        assert abs(a.score - b.score) <= 0.03
        assert abs((a.recheck_score or 0) - (b.recheck_score or 0)) <= 0.03


def test_second_loader_failure_ends_detect_video(monkeypatch):
    """An exception while the recheck reads its second loader propagates
    (it used to become 'no stack' and an unchecked clip) and ends the
    run; only a range with no frame gives no stack."""
    from metdetpy_tpu_torch.track.exporter import _loader_stack_provider
    monkeypatch.setenv("METDETPY_TPU_YOLO_HW", "96x96")
    monkeypatch.setenv("METDETPY_TPU_MAX_POINTS", "2048")
    colour = generate_meteor_video(
        width=W, height=H, fps=FPS, duration_sec=6.5,
        meteors=[SynthMeteor(2.4, 4.4, (int(W * 0.45), int(H * 0.25)),
                             (int(W * 0.30), int(H * 0.55)))],
        n_stars=40, noise_sigma=3.0, color=True)
    cfg = _cfg(TMainDetectCfg, "ThreadVideoLoader", None, recheck=True)
    orig_pop = tvl.ThreadVideoLoader.pop

    def pop(self):
        if not self.grayscale:            # only the recheck's loader
            raise OSError("injected read failure")
        return orig_pop(self)

    monkeypatch.setattr(tvl.ThreadVideoLoader, "pop", pop)
    with pytest.raises(OSError, match="injected read failure"):
        detect_video(colour, None, cfg, work_mode="backend", device="cpu")
    empty = tvl.VanillaVideoLoader(TNumpy, colour[:10],
                                   exp_option="real-time")
    provider = _loader_stack_provider(empty, None)
    assert provider(5, 5) is None


def test_checkpoint_and_resume_options_are_checked(clip):
    with pytest.raises(ValueError, match="checkpoint_path"):
        detect_video(clip, None, _cfg(TMainDetectCfg, resize=None),
                     resume=True, device="cpu")
    with pytest.raises(ValueError, match="block loader"):
        detect_video(clip, None,
                     _cfg(TMainDetectCfg, "VanillaVideoLoader", None),
                     checkpoint_path="x.npz", device="cpu")


def test_auto_exposure_with_device_put():
    """An "auto" exposure pops host frames while the constructor estimates
    it; device-put mode starts after that, with the exposure the JAX
    loader estimates on the same frames with ``device_put=False``. (With
    ``device_put=True`` the JAX loader's constructor asserts, or not, by a
    race in its estimate: ROADMAP.md section 3.)"""
    frames = _slow_shutter_video(n_exposures=50, exp_frames=4)
    kw = dict(exp_option="auto", exp_upper_bound=0.5, merge_func="max",
              grayscale=True)
    ld = tvl.BlockVideoLoader(TNumpy, frames, device_put=True, **kw)
    assert ld.device_put_mode and 3 <= ld.exp_frame <= 5
    want = jvl.BlockVideoLoader(JNumpy, frames.copy(), device_put=False,
                                **kw)
    assert ld.exp_frame == want.exp_frame
    ld.release()
    want.release()
