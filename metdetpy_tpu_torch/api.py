"""The main detection API of the port: ``detect_video``, and
``detect_video_temporal`` (time-sharded batch detection).

Counterpart of ``metdetpy_tpu/api.py`` (orchestration parity with
reference MetDetPy.py:24-250: loader -> detector -> collector loop, work
modes, live mode, time windows, checkpoint/resume, MDRF result). A
BlockVideoLoader feeds whole ``[T, H, W]`` frame blocks through the
detector's device block step, uploaded by the loader itself where the
detector takes device blocks; results are collected with one device->host
copy per group of blocks. The per-frame loaders (Vanilla, Thread) drive
the detector frame by frame.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from . import get_detector, get_loader, get_wrapper, resolve_device
from .detectors.base import BaseDetector
from .detectors.m3det import DiffAreaGuidingDetecor, LineDetector, M3Detector
from .io.videoloader import BlockVideoLoader
from .log import get_default_logger, set_default_logger
from .profiling import StageTimer
from .structs import MDRF, ClipCfg, MainDetectCfg, RuntimeParams
from .utils import (LIVE_MODE_SPEED_CTRL_CONST, VERSION, frame2time, frame2ts,
                    get_clip_config_path, get_num_class)
from .visu import OpenCVMetVisu, TextColorPair, TextVisu

# blocks dispatched before a deferred collection; each keeps its small
# packed result on the device until then (METDETPY_TPU_COLLECT_HORIZON
# overrides; a detector's max_deferred_horizon caps it)
COLLECT_HORIZON = 128


def detect_video(video_name: str, mask_name: Optional[str],
                 cfg: MainDetectCfg, debug_mode: bool = False,
                 visual_mode: bool = False, work_mode: str = "frontend",
                 time_range: tuple[Optional[str], Optional[str]] = (None,
                                                                    None),
                 live_mode: bool = False,
                 provider_key: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_interval_sec: float = 60.0,
                 resume: bool = False, device: str = "cuda") -> MDRF:
    """Detect meteors (and other events) in a video; returns an MDRF.

    ``device`` is ``"cuda"`` (the default; raises without a card) or
    ``"cpu"``; the detector and the recheck model both run there.
    With ``checkpoint_path`` set, the detector and collector state is saved
    every ``checkpoint_interval_sec`` and at the end (the JAX package's
    file format); ``resume=True`` restores it and continues at the saved
    frame cursor. Both need a block loader. ``provider_key`` is recorded in
    the recheck model's config as in the JAX package (it names a compute
    provider of the reference's runtime and selects nothing here). A
    recheck model that cannot be built (a missing weight file) ends the
    call with that exception.
    """
    dev = resolve_device(device)
    set_default_logger(debug_mode, work_mode)
    logger = get_default_logger()
    logger.start()

    try:
        t0 = time.time()
        LoaderCls = get_loader(cfg.loader.name)
        WrapperCls = get_wrapper(cfg.loader.wrapper)
        DetectorCls = get_detector(cfg.detector.name)
        grayscale = cfg.loader.grayscale
        start_time, end_time = time_range

        if issubclass(DetectorCls, (LineDetector, DiffAreaGuidingDetecor)):
            assert grayscale, ("Require grayscale ON when using a "
                               "LineDetector subclass.")
        else:
            assert not grayscale, ("Require grayscale OFF when using "
                                   "MLDetector.")

        global_config = ClipCfg.from_json_file(get_clip_config_path())
        recheck_on = cfg.collector.recheck_cfg.switch

        loader_kwargs = dict(
            mask_name=mask_name, resize_option=cfg.loader.resize,
            hwaccel=cfg.loader.hwaccel, start_time=start_time,
            end_time=end_time, grayscale=grayscale,
            exp_option=cfg.loader.exp_time,
            exp_upper_bound=cfg.loader.upper_bound,
            merge_func=cfg.loader.merge_func,
            continue_on_err=cfg.loader.continue_on_err)
        block_loader = issubclass(LoaderCls, BlockVideoLoader)
        if resume and not checkpoint_path:
            raise ValueError("resume=True needs a checkpoint_path")
        if (checkpoint_path or resume) and not block_loader:
            raise ValueError("checkpoint/resume needs a block loader; "
                             f"{cfg.loader.name} delivers single frames")
        if block_loader:
            # the recheck reads the loader's in-memory colour max-stacks
            loader_kwargs["keep_color_stacks"] = recheck_on
            # detectors with a device block step take blocks the loader
            # has uploaded itself, so the copy overlaps dispatch and
            # collect (visual mode needs host frames)
            loader_kwargs["device_put"] = (
                hasattr(DetectorCls, "process_block_async")
                and not visual_mode)
            loader_kwargs["device"] = dev
        video_loader = LoaderCls(WrapperCls, video_name, **loader_kwargs)
        video_info = video_loader.summary()
        logger.info(repr(video_loader))

        start_frame = video_loader.start_frame
        end_frame = video_loader.end_frame
        rt_param = RuntimeParams(
            fps=video_loader.fps, exp_frame=video_loader.exp_frame,
            eq_fps=video_loader.eq_fps, eq_int_fps=video_loader.eq_int_fps,
            exp_time=video_loader.exp_time,
            runtime_size=video_loader.runtime_size,
            raw_size=video_loader.raw_size,
            positive_category_list=(
                global_config.export.positive_category_list))
        logger.info(f"Preprocessing finished. Time cost: "
                    f"{time.time() - t0:.1f}s.")

        if issubclass(DetectorCls, M3Detector) and (
                cfg.detector.window_sec * rt_param.eq_fps < 3):
            if video_loader.fps < 3:
                raise ValueError(
                    "M3Detector cannot work below 3 FPS; increase FPS or "
                    "use the deep-learning detector (dldet.json).")
            logger.info(f"Equivalent FPS {rt_param.eq_fps:.2f} may be too "
                        f"slow for {DetectorCls.__name__}.")

        detector: BaseDetector = DetectorCls(
            window_sec=cfg.detector.window_sec, fps=rt_param.eq_fps,
            mask=video_loader.mask, num_cls=get_num_class(),
            cfg=cfg.detector.cfg, logger=logger, device=dev)

        # recheck stack source: a block loader's colour max-stacks (no
        # second decode), addressed in merged frames; the per-frame loaders
        # re-read the clip through a second, colour loader, as the
        # reference does (MetDetPy.py:147-156)
        stack_provider = None
        recheck_loader = None
        if recheck_on:
            if block_loader:
                e = rt_param.exp_frame

                def stack_provider(s_raw, e_raw, _vl=video_loader, _e=e,
                                   _s0=start_frame):
                    return _vl.recheck_stack((s_raw - _s0) // _e,
                                             (e_raw - _s0) // _e)
            else:
                recheck_loader = LoaderCls(
                    WrapperCls, video_name, mask_name=mask_name,
                    resize_option=cfg.loader.resize,
                    hwaccel=cfg.loader.hwaccel, grayscale=False,
                    exp_option="real-time",
                    merge_func=cfg.loader.merge_func, continue_on_err=True)

        from .track.collector import MeteorCollector
        if provider_key:
            cfg.collector.recheck_cfg.model.providers_key = provider_key
        collector = MeteorCollector(cfg.collector, rt_param,
                                    video_loader=recheck_loader,
                                    logger=logger,
                                    stack_provider=stack_provider,
                                    device=dev)

        visual_manager = OpenCVMetVisu(exp_time=rt_param.exp_time,
                                       resolution=video_loader.runtime_size,
                                       flag=visual_mode)
    except Exception as e:
        logger.error(repr(e))
        logger.error("Fatal error occured when initializing.")
        logger.stop()
        raise e

    timer = StageTimer()
    t1 = time.time()
    recovered_blocks = 0
    resume_idx = 0
    try:
        if resume:
            from .checkpoint import load_checkpoint
            resume_idx = load_checkpoint(checkpoint_path, detector,
                                         collector)
            video_loader.reset(
                start_frame=start_frame + resume_idx * rt_param.exp_frame)
            logger.info(f"Resumed from {checkpoint_path} at merged frame "
                        f"{resume_idx}.")
        video_loader.start()
        if block_loader:
            recovered_blocks = _run_block_loop(
                video_loader, detector, collector, rt_param, start_frame,
                work_mode, live_mode, visual_mode, visual_manager, logger,
                t0, timer=timer, resume_idx=resume_idx,
                checkpoint_path=checkpoint_path,
                checkpoint_interval_sec=checkpoint_interval_sec)
        else:
            _run_frame_loop(video_loader, detector, collector, rt_param,
                            start_frame, end_frame, work_mode, live_mode,
                            visual_mode, visual_manager, logger, t0)
        if not visual_manager.manual_stop:
            logger.info("VideoLoader-stop detected.")
    except Exception as e:
        logger.error(repr(e))
        raise e
    finally:
        video_loader.release()
        try:
            # joins the exporter's thread; an exception of the recheck
            # raised there ends the call here
            collector.clear()
        finally:
            if recheck_loader is not None:
                recheck_loader.release()
            visual_manager.stop()
            logger.info("Time cost: %.4fs." % (time.time() - t1))
            timer.log_summary(logger)
            logger.stop()

    perf = {k: v for k, v in timer.summary().items()}
    # blocks whose results were dropped by the loop's failure recovery
    # (0 in a healthy run)
    perf["recovered_blocks"] = recovered_blocks
    # decode-thread stage accounting (the uploads and the preprocess
    # placement included), so consumers can decompose decode_wait into
    # host work and transfer
    for k, v in getattr(video_loader, "stage_stats", {}).items():
        perf[f"loader_{k}"] = round(v, 4) if isinstance(v, float) else v
    # detector-internal collect decomposition (e.g. MLDetector's stacked
    # copy vs host postprocess split), so collect_s is attributable
    for k, v in getattr(detector, "last_collect_stats", {}).items():
        perf[f"collect_{k}"] = round(v, 4) if isinstance(v, float) else v
    return MDRF(version=VERSION, basic_info=video_info, config=cfg,
                type="prediction", anno_size=video_info.resolution,
                results=collector.met_exporter.meteor_list,
                performance=perf)


def _zero_results(detector, n_real):
    return [(np.zeros((0, 4), int),
             np.zeros((0, detector.num_cls)))] * n_real


def detect_video_temporal(video_name: str, mask_name: Optional[str],
                          cfg: MainDetectCfg, n_shards: Optional[int] = None,
                          work_mode: str = "backend",
                          time_range: tuple[Optional[str],
                                            Optional[str]] = (None, None),
                          super_block_sec: Optional[float] = None,
                          device: str = "cuda") -> MDRF:
    """Batch detection with the time axis sharded over a device mesh of
    ``n_shards`` cards (default: all; ``"cpu"``: that many shards on the
    CPU); raises where there are fewer cards.

    Default mode decodes and preprocesses the whole (windowed) video into
    one in-memory [T, H, W] array, then runs the complete M3 step
    time-sharded (``parallel.temporal.detect_frames_temporal``). With
    ``super_block_sec`` set, the clip is processed in super-blocks of that
    many seconds with the state carried on the device between sharded
    steps (``detect_frames_temporal_streaming``): host memory is bounded
    by one super-block, and the results equal the whole-clip mode's.

    Accepts a grayscale line-detector config (the M3 step,
    ``parallel.temporal``) or a colour MLDetector (dldet) config (sharded
    window-max and batched YOLO, ``parallel.temporal_dldet``). The
    collector has no stack source, so a recheck switched on in the config
    is switched off by it, as in the JAX package.
    """
    from .parallel.mesh import build_mesh
    from .parallel.temporal import (detect_frames_temporal,
                                    detect_frames_temporal_streaming)
    from .parallel.temporal_dldet import (
        detect_frames_temporal_dldet,
        detect_frames_temporal_dldet_streaming)

    dev = resolve_device(device)
    set_default_logger(False, work_mode)
    logger = get_default_logger()
    logger.start()
    try:
        LoaderCls = get_loader(cfg.loader.name)
        WrapperCls = get_wrapper(cfg.loader.wrapper)
        dldet = cfg.detector.name == "MLDetector"
        if cfg.loader.grayscale == dldet:
            raise ValueError(
                "temporal batch detection requires a grayscale classic-"
                "detector config, or a color MLDetector (dldet) config")
        start_time, end_time = time_range
        video_loader = LoaderCls(
            WrapperCls, video_name, mask_name=mask_name,
            resize_option=cfg.loader.resize, hwaccel=cfg.loader.hwaccel,
            start_time=start_time, end_time=end_time,
            grayscale=not dldet,
            exp_option=cfg.loader.exp_time,
            exp_upper_bound=cfg.loader.upper_bound,
            merge_func=cfg.loader.merge_func,
            continue_on_err=cfg.loader.continue_on_err)
        video_info = video_loader.summary()
        logger.info(repr(video_loader))
        rt_param = RuntimeParams(
            fps=video_loader.fps, exp_frame=video_loader.exp_frame,
            eq_fps=video_loader.eq_fps, eq_int_fps=video_loader.eq_int_fps,
            exp_time=video_loader.exp_time,
            runtime_size=video_loader.runtime_size,
            raw_size=video_loader.raw_size,
            positive_category_list=ClipCfg.from_json_file(
                get_clip_config_path()).export.positive_category_list)

        mesh = build_mesh(n_shards, axis_name="time", device=dev)
        n = mesh.size
        mask = video_loader.mask if mask_name else None
        video_loader.start()

        def iter_blocks():
            # BlockVideoLoader recycles a fixed pool of block buffers; a
            # retained reference would be overwritten once the producer
            # laps the pool, so copy
            if hasattr(video_loader, "pop_block"):
                while True:
                    blk = video_loader.pop_block()
                    if blk is None:
                        return
                    yield np.array(blk, copy=True)
            else:
                while not video_loader.stopped:
                    f = video_loader.pop()
                    if f is None:
                        return
                    yield np.array(f[None], copy=True)

        if super_block_sec is not None:
            super_frames = max(int(super_block_sec * rt_param.eq_fps), n)
            stream_fn = (detect_frames_temporal_dldet_streaming if dldet
                         else detect_frames_temporal_streaming)
            try:
                records, used = stream_fn(
                    iter_blocks(), cfg, fps=rt_param.eq_fps, mask=mask,
                    mesh=mesh, super_block_frames=super_frames,
                    logger=logger, rt_params=rt_param)
            finally:
                video_loader.release()
            if dldet:  # temporal_dldet's super-block sizing
                n_win = max(int(cfg.detector.window_sec
                                * rt_param.eq_fps), 1)
                sb_frames = max(super_frames // n, n_win - 1, 1) * n
            else:
                sb_frames = max(super_frames // n * n, n)
            logger.info(f"Streaming temporal detection: {used} merged "
                        f"frames over {n} shards in "
                        f"{-(-used // sb_frames)} super-blocks.")
        else:
            try:
                chunks = list(iter_blocks())
            finally:
                video_loader.release()
            if not chunks:
                raise ValueError("no frames decoded")
            frames = np.concatenate(chunks, axis=0)
            del chunks
            batch_fn = (detect_frames_temporal_dldet if dldet
                        else detect_frames_temporal)
            records, used = batch_fn(
                frames, cfg, fps=rt_param.eq_fps, mask=mask, mesh=mesh,
                logger=logger, rt_params=rt_param)
            logger.info(f"Temporal batch detection: {used} merged frames "
                        f"over {n} shards.")
    finally:
        logger.stop()
    return MDRF(version=VERSION, basic_info=video_info, config=cfg,
                type="prediction", anno_size=video_info.resolution,
                results=records)


def _run_block_loop(video_loader, detector: BaseDetector, collector,
                    rt_param, start_frame, work_mode, live_mode,
                    visual_mode, visual_manager, logger, t0,
                    timer=None, resume_idx: int = 0,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_interval_sec: float = 60.0) -> int:
    # One block shape per run: the tail block is padded by repeating its
    # last frame and the padded positions' results are dropped.
    # In the loader's device-put mode each block arrives uploaded and
    # padded, as a (device tensor, n_real) pair; otherwise it is padded
    # here and the detector uploads it. The device step is enqueued on the
    # main thread; the results are read back either per block by worker
    # threads (incremental mode: live and visual runs) or for a whole
    # horizon of blocks at once (deferred mode, the default). A detector
    # without process_block_async (the host-side DiffAreaGuidingDetecor),
    # or one that says it cannot run it (supports_async False: MLDetector
    # on a model without NMS), is driven through process_block. Which of
    # the two it is, is settled here, once: an exception of the device
    # step moves the run to no other path (it propagates, or goes to the
    # failure recovery below, which counts the blocks it drops).
    import collections
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    if timer is None:
        timer = StageTimer()
    merged_idx = resume_idx
    last_ckpt = time.time()
    e = rt_param.exp_frame
    eq_int_fps = max(rt_param.eq_int_fps, 1)
    block_frames = getattr(video_loader, "block_frames", 64)
    use_async = (hasattr(detector, "process_block_async")
                 and getattr(detector, "supports_async", True))
    pipeline_depth = int(_os.environ.get("METDETPY_TPU_PIPELINE_DEPTH", 6))
    executor = ThreadPoolExecutor(max_workers=pipeline_depth)
    inflight: "collections.deque" = collections.deque()

    # device_epoch tags each dispatched block with the device-state
    # generation it was issued under; a reset bumps it so that failures
    # of blocks dispatched BEFORE the reset (poisoned by the same fault)
    # are zero-filled without counting toward the consecutive-failure
    # abort limit.
    device_epoch = 0
    device_mode = getattr(video_loader, "device_put_mode", False)

    def dispatch(raw_block, submit=True):
        """Enqueue the device step for one block. In device-put mode the
        block is the loader's (device tensor, n_real) pair, taken as it
        is; otherwise it is padded here and the detector uploads it (the
        copy completes before process_block_async returns, so the loader
        may reuse its buffer). With submit=False (deferred collection) the
        raw handle is returned instead of a collect future."""
        if device_mode:
            blk, n_real = raw_block
        else:
            n_real = raw_block.shape[0]
            if n_real < block_frames:
                pad = np.repeat(raw_block[-1:], block_frames - n_real,
                                axis=0)
                blk = np.concatenate([raw_block, pad], axis=0)
            else:
                blk = raw_block
        if use_async:
            handle = detector.process_block_async(blk)
            if not submit:
                return handle, blk, n_real, device_epoch
            fut = executor.submit(detector.collect, handle)
            return fut, blk, n_real, device_epoch
        # processed when consumed; the loader may reuse its buffer by then
        return (None, blk if device_mode else np.array(blk), n_real,
                device_epoch)

    progress = None
    if work_mode == "frontend":
        try:
            import tqdm
            total = max(video_loader.iterations // e - resume_idx, 0)
            progress = tqdm.tqdm(total=total, ncols=100, unit="frame")
        except ImportError:
            pass

    consecutive_failures = 0
    recovered_blocks = 0

    def recover(exc, epoch, n_real, what):
        """Device failure recovery: drop the block's results, reset the
        detector's device state (window/EMA warmup restarts; collector
        history is host-side and survives) and keep going. Failures of
        blocks dispatched before the last reset are zero-filled without
        counting; three consecutive post-reset failures abort."""
        nonlocal consecutive_failures, device_epoch, recovered_blocks
        recovered_blocks += 1
        if epoch < device_epoch:
            logger.warning(f"{exc!r} on a pre-reset inflight block; "
                           f"dropped.")
        else:
            consecutive_failures += 1
            logger.error(
                f"{exc!r} while {what} a frame block; resetting device "
                f"state and continuing ({consecutive_failures} "
                f"consecutive failure(s)).")
            if consecutive_failures >= 3 or not hasattr(
                    detector, "reset_device_state"):
                raise exc
            detector.reset_device_state()
            device_epoch += 1
        return _zero_results(detector, n_real)

    def consume(entry):
        nonlocal consecutive_failures
        fut, block, n_real, epoch = entry
        try:
            with timer.stage("collect"):
                if fut is not None:
                    results = fut.result()[:n_real]
                else:
                    results = detector.process_block(block)[:n_real]
            consecutive_failures = 0
        except Exception as exc:
            results = recover(exc, epoch, n_real, "processing")
        timer.add_frames(n_real * e)
        if progress is not None:
            progress.update(n_real)
        return emit_results(results, block, heartbeat=True)

    def emit_results(results, block, heartbeat):
        """Feed one block's per-frame results through the collector (and
        visu/live pacing); shared by the incremental and deferred paths.
        With heartbeat=False the Processing log lines are assumed to have
        been emitted at dispatch time."""
        nonlocal merged_idx
        for j, (lines, cates) in enumerate(results):
            i = start_frame + merged_idx * e
            if (heartbeat and work_mode == "backend"
                    and merged_idx % eq_int_fps == 0):
                logger.processing(str(frame2time(i, rt_param.fps)))
            if len(lines) or merged_idx % eq_int_fps == 0:
                with timer.stage("collector_update"):
                    collector.update(i, lines=lines, cates=cates)
            if visual_mode:
                visu_info = [TextVisu(
                    "timestamp",
                    text_list=[TextColorPair(frame2ts(i, rt_param.fps))],
                    position="left-bottom", color="white")]
                visu_info.extend(detector.visu())
                visu_info.extend(collector.visu(frame_num=i))
                visual_manager.display_a_frame(block[j], visu_info)
                if visual_manager.manual_stop:
                    logger.info("Manual interrupt signal detected.")
                    return False
            merged_idx += 1
        if live_mode:
            expect = (merged_idx * e / rt_param.fps
                      ) * LIVE_MODE_SPEED_CTRL_CONST
            elapsed = time.time() - t0
            if elapsed < expect:
                time.sleep(expect - elapsed)
        return True

    # Deferred collection (default for offline block runs): dispatch every
    # block of a horizon without any device->host read, then collect the
    # horizon with one stacked copy per group (detector.collect_many).
    # Live mode needs pacing and visual mode per-block host frames, so
    # both keep the incremental path. Override with
    # METDETPY_TPU_DEFERRED_COLLECT=0.
    deferred_env = _os.environ.get("METDETPY_TPU_DEFERRED_COLLECT")
    deferred = (use_async and not live_mode and not visual_mode
                and hasattr(detector, "collect_many")
                and deferred_env != "0")
    logger.debug(
        f"Deferred collection: {'on' if deferred else 'off'} "
        f"({'env override' if deferred_env is not None else 'default'})")
    # horizon bound: detectors whose handles pin big device arrays
    # (MLDetector's color stacks) declare a tighter cap
    horizon = max(1, int(_os.environ.get("METDETPY_TPU_COLLECT_HORIZON",
                                         COLLECT_HORIZON)))
    horizon = min(horizon, getattr(detector, "max_deferred_horizon",
                                   horizon))
    pending: list = []
    dispatched_merged = resume_idx

    def flush_deferred():
        """Collect every pending handle (one copy per group), then emit in
        order. On a horizon-collect failure, fall back to per-block
        collection with the same epoch-tagged recovery as the incremental
        path."""
        nonlocal consecutive_failures
        if not pending:
            return True
        entries = list(pending)
        pending.clear()
        try:
            with timer.stage("collect"):
                many = detector.collect_many([en[0] for en in entries])
            consecutive_failures = 0
        except Exception as exc:
            logger.error(f"{exc!r} during horizon collect "
                         f"({len(entries)} blocks); falling back to "
                         f"per-block collection.")
            many = []
            for handle, n_real, epoch in entries:
                try:
                    with timer.stage("collect"):
                        many.append(detector.collect(handle))
                    consecutive_failures = 0
                except Exception as exc2:
                    many.append(recover(exc2, epoch, n_real, "collecting"))
        for (handle, n_real, epoch), results in zip(entries, many):
            timer.add_frames(n_real * e)
            if progress is not None:
                progress.update(n_real)
            if emit_results(results[:n_real], None,
                            heartbeat=False) is False:
                return False
        return True

    stopped = False
    try:
        while not stopped:
            with timer.stage("decode_wait"):
                raw_block = video_loader.pop_block()
            if raw_block is None:
                break
            if deferred:
                with timer.stage("dispatch"):
                    entry = dispatch(raw_block, submit=False)
                handle, _blk, n_real, epoch = entry
                if hasattr(detector, "handle_slim"):
                    handle = detector.handle_slim(handle)
                if work_mode == "backend":
                    # heartbeat at dispatch granularity (results arrive
                    # in a burst at the horizon collect)
                    logger.processing(str(frame2time(
                        start_frame + dispatched_merged * e,
                        rt_param.fps)))
                dispatched_merged += n_real
                pending.append((handle, n_real, epoch))
                if len(pending) >= horizon and not flush_deferred():
                    stopped = True
            else:
                with timer.stage("dispatch"):
                    inflight.append(dispatch(raw_block))
                while len(inflight) >= pipeline_depth:
                    if consume(inflight.popleft()) is False:
                        stopped = True
                        break
            if (checkpoint_path and not stopped
                    and time.time() - last_ckpt >= checkpoint_interval_sec):
                # drain the pipeline before the snapshot: the detector's
                # carries advance at dispatch, so a snapshot taken with
                # blocks in flight would be ahead of the collector and the
                # frame cursor
                if deferred:
                    stopped = flush_deferred() is False
                while inflight and not stopped:
                    if consume(inflight.popleft()) is False:
                        stopped = True
                if not stopped:
                    from .checkpoint import save_checkpoint
                    with timer.stage("checkpoint"):
                        save_checkpoint(checkpoint_path, detector,
                                        collector, merged_idx)
                    last_ckpt = time.time()
        if not stopped and deferred:
            stopped = flush_deferred() is False
        while inflight and not stopped:
            if consume(inflight.popleft()) is False:
                break
    finally:
        executor.shutdown(wait=True)
        if progress is not None:
            progress.close()
        if checkpoint_path:
            from .checkpoint import save_checkpoint
            save_checkpoint(checkpoint_path, detector, collector, merged_idx)
    return recovered_blocks


def _run_frame_loop(video_loader, detector, collector, rt_param, start_frame,
                    end_frame, work_mode, live_mode, visual_mode,
                    visual_manager, logger, t0) -> None:
    """The per-frame loop of the Vanilla and Thread loaders: one merged
    frame at a time through the detector's ``update``/``detect``."""
    eq_int_fps = max(rt_param.eq_int_fps, 1)
    for prog_int, i in enumerate(
            range(start_frame, end_frame, rt_param.exp_frame)):
        if work_mode == "backend" and prog_int % eq_int_fps == 0:
            logger.processing(str(frame2time(i, rt_param.fps)))
        x = video_loader.pop()
        if video_loader.stopped or x is None:
            break
        detector.update(x)
        lines, cates = detector.detect()
        if len(lines) or prog_int % eq_int_fps == 0:
            collector.update(i, lines=lines, cates=cates)
        if visual_mode:
            visu_info = [TextVisu(
                "timestamp",
                text_list=[TextColorPair(frame2ts(i, rt_param.fps))],
                position="left-bottom", color="white")]
            visu_info.extend(detector.visu())
            visu_info.extend(collector.visu(frame_num=i))
            visual_manager.display_a_frame(x, visu_info)
            if visual_manager.manual_stop:
                logger.info("Manual interrupt signal detected.")
                return
        if live_mode:
            expect = (prog_int * rt_param.exp_frame / rt_param.fps
                      ) * LIVE_MODE_SPEED_CTRL_CONST
            elapsed = time.time() - t0
            if elapsed < expect:
                time.sleep(expect - elapsed)

