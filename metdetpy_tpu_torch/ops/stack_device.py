"""Device-side MFNR mixed stacking (PyTorch, on any ``device``).

The host path (ops.stack.mfnr_mix_stacker) implements the reference's
pixel math (reference MetLib/stacker.py:296-403) in numpy/cv2; this module
runs the same math as [T, H, W, 3] tensor programs on the device,
streaming decode blocks into accumulators that live there:

  per block:   max, sum, square-sum accumulate on the device (int64 sums:
               the streaming FastGaussianParam analog, reference
               MetLib/utils.py:418-513); each 16-frame block is uploaded
               from pinned memory
  at export:   background estimate (mean / median / sigma-clipping),
               Gumbel expected-max correction, foreground mask +
               separable Gaussian feather (cv2.getGaussianKernel
               coefficients, REFLECT_101 borders), highlight-protected
               brightness fix, max/mean blend.

``connect_lines`` (contour-based trail reconnection) stays host-side: it
is a single-image OpenCV findContours pass, so the device program splits
around it when enabled.

The JAX package runs these programs through XLA; on its CPU backend XLA
contracts some multiply-adds into fused multiply-adds, turns divisions by
constants into multiplications by f32 reciprocals and folds chains of
constants. The functions below write those forms out (``fma_f32``, the
folded constants), so that on the CPU the port's elementwise arithmetic
is XLA's. Scalar reductions (the mean background std, the highlight
average) are summed in float64 and rounded to f32 once: XLA sums them in
f32 in its own order, so they can differ from it in the last bits, and
with them a rounding of the u8 output now and then. The JAX package's
sums and square sums are uint32; the port's are int64 (equal until the
uint32 square sum wraps, beyond 66,052 frames of 255).

Output parity with the host path is within +/-1 gray level (f32 vs f64
reductions). A failure raises; the caller does not fall back to the host.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..log import BaseMetLog, get_useable_logger
from ..structs import DenoiseOption
from .f32 import fma_f32

DEVICE_BLOCK = 16  # frames uploaded per accumulator update

# stage accounting of the most recent mfnr_mix_device run (placement
# mode, per-stage seconds, uploaded bytes), as the JAX package keeps it
last_run_stats: dict = {}

F32 = torch.float32


def _f32(x) -> float:
    """A Python float holding the f32 value of ``x`` (an f32 constant)."""
    return float(np.float32(x))


def _gaussian_kernel_f32(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel coefficients (the exact taps GaussianBlur
    uses), as f32 [ksize]."""
    import cv2
    return cv2.getGaussianKernel(ksize, sigma).astype(np.float32).ravel()


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of an axis of ``n`` padded by ``r`` on each side with
    REFLECT_101 (numpy's and jnp's ``mode="reflect"``, for any ``n``)."""
    return torch.as_tensor(np.pad(np.arange(n), r, mode="reflect"),
                           device=device)


def _tap_chain(taps: torch.Tensor, parts) -> torch.Tensor:
    """sum(taps[i] * parts[i]) as XLA's CPU backend evaluates the chain:
    the first two terms as fma(t0, p0, t1 * p1), then one fused
    multiply-add per tap."""
    acc = fma_f32(taps[0], parts[0], taps[1] * parts[1])
    for i in range(2, taps.shape[0]):
        acc = fma_f32(taps[i], parts[i], acc)
    return acc


def _blur_reflect101(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of a [H, W] f32 image with cv2's default
    BORDER_REFLECT_101 padding: horizontal, then vertical 1-D convolutions
    by explicit taps."""
    k = taps.shape[0]
    r = k // 2
    h, w = img.shape
    x = img[_reflect_index(h, r, img.device)][:, _reflect_index(w, r,
                                                                img.device)]
    horiz = _tap_chain(taps, [x[:, i:i + w] for i in range(k)])
    return _tap_chain(taps, [horiz[i:i + h, :] for i in range(k)])


def _acc_update(mx, s, sq, block: torch.Tensor) -> None:
    """Fold a [T, H, W, C] u8 block into the max and the int64 sum and
    square sum, in place."""
    torch.maximum(mx, block.amax(dim=0), out=mx)
    b32 = block.to(torch.int32)
    s += b32.sum(dim=0, dtype=torch.int64)
    sq += (b32 * b32).sum(dim=0, dtype=torch.int64)


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    """Sum of an f32 tensor, accumulated in float64, as a 0-dim f32."""
    return x.sum(dtype=torch.float64).to(F32)


def _std_terms(s, sq, nf):
    """(sf, per-pixel std) of the full-stack statistics, f32."""
    sf = s.to(F32)
    var = (sq.to(F32) - sf * sf / nf) / (nf - 1.0)
    return sf, torch.sqrt(torch.clamp(var, min=0.0))


def _stage1(mx, s, sq, n, bg_mu, bg_var, taps, *, hp, gumbel,
            bg_fix_factor):
    """Stats + foreground mask + feather. ``bg_mu`` (an f32 or u8 plane)
    and ``bg_var`` (a 0-dim f32) replace the full-stack mean and std
    where given. Returns (est_bg_mu f32, est_bg_var 0-dim f32, max_bias
    f32, fg_blur f32 [H, W, 1])."""
    nf = torch.tensor(float(n), dtype=F32, device=mx.device)
    if bg_mu is not None:
        est_bg_mu = bg_mu.to(F32)
    else:
        # FastGaussianParam.mu = round(sum / n), round-half-to-even like
        # np.round (reference MetLib/utils.py:442-447)
        est_bg_mu = torch.round(s.to(F32) / nf)
    gf = _f32(np.float32(gumbel) * np.float32(bg_fix_factor))
    if bg_var is not None:
        est_bg_var = bg_var
        bg_lift = bg_var * gf
    else:
        # mean(std) = sum(std) * f32(1/N); XLA folds the lift's constants
        # into sum(std) * f32(f32(f32(1/N) * gumbel) * bg_fix_factor)
        inv_n = np.float32(1) / np.float32(mx.numel())
        std_sum = _sum_f32(_std_terms(s, sq, nf)[1])
        est_bg_var = std_sum * float(inv_n)
        bg_lift = std_sum * _f32(np.float32(inv_n * np.float32(gumbel))
                                 * np.float32(bg_fix_factor))
    max_f = mx.to(F32)
    max_bias = max_f - est_bg_mu - bg_lift
    pos = max_bias > 0
    count = torch.clamp(pos.sum(), min=1).to(F32)
    highlight_avg = _sum_f32(torch.where(pos, max_bias, 0.0)) / count
    fg_any = ((max_bias > highlight_avg) | (max_f > _f32(255.0 * hp))
              ).any(dim=-1).to(F32)
    fg_blur = _blur_reflect101(fg_any, taps)[..., None]
    return est_bg_mu, est_bg_var, max_bias, fg_blur


def _stage2(mx, est_bg_mu, est_bg_var, fg_blur, *, hp, gumbel):
    """Highlight-protected brightness fix + max/mean blend -> u8.

    XLA's CPU form: ``max_f / 255`` is a multiplication by f32(1/255) fused
    with ``- hp``, ``/ (1 - hp)`` a multiplication by its f32 reciprocal,
    the brightness fix one fused multiply-add; the blend's add is fused
    with the max's product in channels 0 and 1 and with the mean's in
    channel 2 (how XLA's CPU loop, unrolled over the three channels,
    contracts it)."""
    max_f = mx.to(F32)
    inv255 = _f32(np.float32(1) / np.float32(255))
    inv_1mhp = _f32(np.float32(1) / np.float32(1.0 - hp))
    over = torch.clamp(fma_f32(max_f, inv255, -_f32(hp)), 0.0, 1.0)
    fix_factor = fma_f32(-over, inv_1mhp, 1.0)
    lift = est_bg_var * _f32(gumbel)
    fixed_max = torch.clamp(fma_f32(-lift, fix_factor, max_f), 0.0, 255.0)
    keep = 1.0 - fg_blur
    mixed = torch.cat([
        fma_f32(fixed_max[..., :2], fg_blur, est_bg_mu[..., :2] * keep),
        fma_f32(est_bg_mu[..., 2:], keep, fixed_max[..., 2:] * fg_blur)],
        dim=-1)
    return torch.round(mixed).to(torch.uint8)


def _clipped_stats(stack, s, sq, n, sigma_high, sigma_low):
    """Sigma-clipped background (host parity: single_sigma_clipping
    rejects against the full-stack mu/std, then BOTH the bg mean and the
    bg std come from the clipped stats, reference MetLib/stacker.py:91-111
    + 335-341). Returns (mu f32 plane, std 0-dim f32)."""
    nf = torch.tensor(float(n), dtype=F32, device=stack.device)
    sf, std = _std_terms(s, sq, nf)
    mu = torch.round(sf / nf)
    hi = torch.clamp(torch.round(fma_f32(_f32(sigma_high), std, mu)),
                     0, 255).to(torch.uint8)
    lo = torch.clamp(torch.round(fma_f32(-_f32(sigma_low), std, mu)),
                     0, 255).to(torch.uint8)
    reject = (stack > hi[None]) | (stack < lo[None])
    rej = torch.where(reject, stack, 0).to(torch.int32)
    rs = (s - rej.sum(dim=0, dtype=torch.int64)).to(F32)
    rsq = (sq - (rej * rej).sum(dim=0, dtype=torch.int64)).to(F32)
    rn = nf - reject.sum(dim=0).to(F32)
    rn1 = torch.clamp(rn, min=1.0)
    cmu = torch.round(rs / rn1)
    cvar = (rsq - rs * rs / rn1) / torch.clamp(rn - 1.0, min=1.0)
    inv_n = float(np.float32(1) / np.float32(cvar.numel()))
    cstd = _sum_f32(torch.sqrt(torch.clamp(cvar, min=0.0))) * inv_n
    return cmu, cstd


def _blur_blend(packed, bg_var, taps, *, hp, gumbel):
    """Host-reduced placement's device program: feather blur of the
    host-computed fg mask + the stage-2 blend. ``packed`` is one [H, W, 7]
    u8 tensor (ch 0-2 max, 3-5 mu, 6 fg mask): one upload."""
    fg_blur = _blur_reflect101(packed[..., 6].to(F32), taps)[..., None]
    return _stage2(packed[..., 0:3], packed[..., 3:6].to(F32), bg_var,
                   fg_blur, hp=hp, gumbel=gumbel)


class _BlockUploader:
    """Uploads stacks of frames to ``device``: on a card from two pinned
    host buffers in turn (non-blocking copies; a buffer is refilled only
    after its previous copy's event), on the CPU as they are."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.bufs: list = [None, None]
        self.events: list = [None, None]
        self.turn = 0

    def __call__(self, frames) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(np.stack(frames))
        i, self.turn = self.turn, 1 - self.turn
        shape = (len(frames),) + tuple(frames[0].shape)
        buf = self.bufs[i]
        if buf is None or buf.shape[0] < shape[0] \
                or tuple(buf.shape[1:]) != shape[1:]:
            buf = self.bufs[i] = torch.empty(shape, dtype=torch.uint8,
                                             pin_memory=True)
        elif self.events[i] is not None:
            self.events[i].synchronize()
        host = buf[:shape[0]]
        np.stack(frames, out=host.numpy())
        out = host.to(self.device, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()
        return out


def mfnr_mix_device(video_loader, denoise_cfg: DenoiseOption,
                    start_frame=None, end_frame=None,
                    logger: Optional[BaseMetLog] = None, device="cuda"
                    ) -> Optional[np.ndarray]:
    """Device MFNR export: stream decode blocks into accumulators on
    ``device`` (``cuda``, the default, raises without a card), run the
    pixel math there. Same semantics as ops.stack.mfnr_mix_stacker
    (reference MetLib/stacker.py:296-403); output within +/-1 gray level
    of the host path. Raises on a device or transport failure.

    The ``median``, ``med-of-med`` and ``sigma-clipping`` backgrounds keep
    the whole clip on the device (a clip that does not fit raises); the
    ``mean`` background keeps three planes, or, host-reduced, uploads
    only the fg window of (max, mu, fg mask).
    """
    from . import stack as hs  # host-side helpers shared verbatim

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    logger = get_useable_logger(logger)
    hp, blur_ksize = denoise_cfg.highlight_preserve, denoise_cfg.blur_ksize
    connect_cfg, mfnr = denoise_cfg.connect_lines, denoise_cfg.mfnr_param
    assert mfnr.bg_algorithm in hs.SUPPORT_BG_ALGO, \
        f"unsupported bg algo {mfnr.bg_algorithm}"
    keep_stack = mfnr.bg_algorithm not in ("mean",)

    if start_frame is not None or end_frame is not None:
        video_loader.reset(start_frame=start_frame, end_frame=end_frame)
    mx = s = sq = None
    n = 0
    dev_blocks: list[torch.Tensor] = []
    pend: list[np.ndarray] = []
    upload = _BlockUploader(dev)

    # For the "mean" background the stack itself is never needed on the
    # device -- and neither are the raw sum/sqsum planes: the pixel math
    # consumes only the ROUNDED MEAN plane (u8, FastGaussianParam.mu
    # semantics) and the SCALAR bg std. Streaming the reduction on the
    # HOST during decode and uploading just (max u8, mu u8) + one scalar
    # (2 B/px, ~12 MB at 64x1080p color) instead of every frame
    # (3 B/px/frame, ~398 MB) can win on a slow link. Decided per run
    # from a measured host-accumulate pilot vs the probed link rate.
    host_reduce = False
    hr_env = os.environ.get("METDETPY_TPU_MFNR_HOST_REDUCE")
    if not keep_stack and hr_env is not None:
        host_reduce = hr_env != "0"
    elif not keep_stack:
        h2d, _ = hs._probe_link_bps(dev)
        w_, h_ = video_loader.runtime_size
        frames_total = video_loader.iterations
        full_bytes = frames_total * h_ * w_ * 3
        red_bytes = 2 * h_ * w_ * 3
        # pilot: accumulate 2 synthetic frames at runtime size
        pf = np.zeros((h_, w_, 3), np.uint8)
        pmx = np.zeros_like(pf)
        ps = np.zeros((h_, w_, 3), np.uint32)
        psq = np.zeros((h_, w_, 3), np.uint32)
        ptmp = np.empty((h_, w_, 3), np.uint32)
        t0 = time.perf_counter()
        for _ in range(2):
            np.maximum(pmx, pf, out=pmx)
            ptmp[:] = pf
            ps += ptmp
            ptmp *= ptmp
            psq += ptmp
        t_acc_frame = (time.perf_counter() - t0) / 2
        t_full = full_bytes / h2d
        t_red = red_bytes / h2d + frames_total * t_acc_frame
        host_reduce = t_red < t_full
        logger.debug(
            f"MFNR placement: host-accumulate pilot "
            f"{t_acc_frame * 1e3:.1f} ms/frame, link "
            f"{h2d / 1e6:.0f} MB/s -> "
            f"{'host-reduced' if host_reduce else 'full'} upload "
            f"(est {min(t_red, t_full):.2f}s vs "
            f"{max(t_red, t_full):.2f}s).")
    hmx = hs_ = hsq = htmp = None
    last_run_stats.clear()
    last_run_stats["placement"] = ("host-reduced-upload" if host_reduce
                                   else "full-upload")

    def flush():
        nonlocal mx, s, sq, n
        if not pend:
            return
        block = upload(pend)
        if keep_stack:
            dev_blocks.append(block)
        if mx is None:
            shape = tuple(pend[0].shape)
            mx = torch.zeros(shape, dtype=torch.uint8, device=dev)
            s = torch.zeros(shape, dtype=torch.int64, device=dev)
            sq = torch.zeros(shape, dtype=torch.int64, device=dev)
        _acc_update(mx, s, sq, block)
        n += len(pend)
        pend.clear()

    t_loop0 = time.perf_counter()
    try:
        video_loader.start()
        for _ in range(video_loader.iterations):
            frame = video_loader.pop()
            if frame is None:
                break
            if host_reduce:
                f = np.asarray(frame)
                if hmx is None:
                    hmx = np.zeros_like(f)
                    hs_ = np.zeros(f.shape, np.uint32)
                    hsq = np.zeros(f.shape, np.uint32)
                    htmp = np.empty(f.shape, np.uint16)
                np.maximum(hmx, f, out=hmx)
                # u16 staging: sum increments and u8 squares (<= 255^2)
                # both fit u16
                np.multiply(f, f, out=htmp, dtype=np.uint16, casting="unsafe")
                np.add(hsq, htmp, out=hsq, casting="unsafe")
                np.add(hs_, f, out=hs_, casting="unsafe")
                n += 1
                continue
            pend.append(np.asarray(frame))
            if len(pend) >= DEVICE_BLOCK:
                flush()
        flush()
        if cuda:
            torch.cuda.synchronize(dev)
    finally:
        video_loader.stop()
    last_run_stats["decode_acc_s"] = round(
        time.perf_counter() - t_loop0, 3)
    t_up0 = time.perf_counter()
    if host_reduce and hmx is not None:
        # fold sum/sqsum down on host: the device blend only consumes
        # the rounded mean plane and the scalar bg std (host math
        # mirrors the device ops -- f32 sum cast, f32 divide, round
        # half-to-even -- so mu is bit-equal to the full-upload path;
        # the scalar differs by reduction-order ULPs only). Stage-1's
        # bias/fg-mask stats (and the optional contour reconnection)
        # also run here: every input is already host-resident. The
        # device keeps the feather blur + blend.
        nf = np.float32(n)
        sf = hs_.astype(np.float32)
        host_bg = np.round(sf / nf).astype(np.uint8)
        var = hsq.astype(np.float32)
        var -= sf * sf / nf
        var /= nf - 1.0
        host_var = float(np.mean(np.sqrt(np.maximum(var, 0.0, out=var))))
        gumbel = hs.get_gumbel_mean(n)
        max_f = hmx.astype(np.float32)
        max_bias = max_f - host_bg.astype(np.float32)
        max_bias -= np.float32(host_var * gumbel
                               * float(mfnr.bg_fix_factor))
        pos_bias = max_bias[max_bias > 0]
        highlight_avg = np.float32(pos_bias.mean() if pos_bias.size
                                   else 0.0)
        fg_any = np.any((max_bias > highlight_avg)
                        | (max_f > 255.0 * float(hp)),
                        axis=-1).astype(np.uint8)
        if connect_cfg.switch:
            hmx = hs.connect_highlight_area(
                hmx, max_bias, rep_times=1,
                ksize_multiplier=connect_cfg.ksize_multiplier,
                clip_threshold=connect_cfg.threshold,
                gamma=connect_cfg.gamma, logger=logger)
        last_run_stats["host_stage_s"] = round(
            time.perf_counter() - t_up0, 3)
        t_up0 = time.perf_counter()
        # Outside the feathered fg support, the blend reduces to
        # round(mu * 1.0) == the mu plane itself (bit-exact: mu is u8),
        # so the device only ever needs the fg bounding box padded by
        # the blur radius. fg beyond the window is impossible (the box
        # covers all fg pixels + radius), so window-reflect blur ==
        # full-frame blur there.
        h_, w_ = fg_any.shape
        ys, xs = np.nonzero(fg_any)
        if ys.size == 0:
            last_run_stats["h2d_bytes"] = 0
            last_run_stats["upload_s"] = 0.0
            last_run_stats["device_math_fetch_s"] = 0.0
            last_run_stats["window_px_frac"] = 0.0
            return host_bg
        r = int(blur_ksize) // 2
        y0 = max(int(ys.min()) - r, 0)
        y1 = min(int(ys.max()) + 1 + r, h_)
        x0 = max(int(xs.min()) - r, 0)
        x1 = min(int(xs.max()) + 1 + r, w_)
        # pad window dims up to multiples of 64 (the JAX package's bound
        # on its compile count), sliding the origin back so the padded
        # window stays inside the frame
        wh = min(-(-(y1 - y0) // 64) * 64, h_)
        ww = min(-(-(x1 - x0) // 64) * 64, w_)
        y0 = min(y0, h_ - wh)
        x0 = min(x0, w_ - ww)
        y1, x1 = y0 + wh, x0 + ww
        frac = (wh * ww) / float(h_ * w_)
        last_run_stats["window_px_frac"] = round(frac, 4)
        full_frame = frac >= 0.98   # whole frame anyway: skip the paste
        packed = np.empty((wh, ww, 7), np.uint8)
        packed[..., 0:3] = hmx[y0:y1, x0:x1]
        packed[..., 3:6] = host_bg[y0:y1, x0:x1]
        packed[..., 6] = fg_any[y0:y1, x0:x1]
        taps = torch.from_numpy(_gaussian_kernel_f32(blur_ksize,
                                                     3.0)).to(dev)
        packed_dev = upload([packed])[0]
        bg_var = torch.tensor(host_var, dtype=F32, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        last_run_stats["h2d_bytes"] = packed.nbytes
        last_run_stats["upload_s"] = round(time.perf_counter() - t_up0, 3)
        t_math0 = time.perf_counter()
        win_mixed = _blur_blend(packed_dev, bg_var, taps, hp=float(hp),
                                gumbel=gumbel).cpu().numpy()
        last_run_stats["device_math_fetch_s"] = round(
            time.perf_counter() - t_math0, 3)
        if full_frame:
            mixed = win_mixed
        else:
            mixed = host_bg.copy()
            mixed[y0:y1, x0:x1] = win_mixed
        logger.debug(f"MFNR-stacked SNR (device, host-reduced): "
                     f"{hs.estimate_snr_smooth_residual(mixed):.2f} db.")
        return mixed
    if n:
        last_run_stats["h2d_bytes"] = n * int(
            np.prod(video_loader.runtime_size)) * 3
    last_run_stats["upload_s"] = round(time.perf_counter() - t_up0, 3)
    if n == 0 or mx is None:
        return None
    t_math0 = time.perf_counter()

    # -- background estimate -------------------------------------------
    bg_mu = bg_var = None
    if mfnr.bg_algorithm in ("median", "med-of-med"):
        stack = torch.cat(dev_blocks, dim=0)
        # host parity (stack.mfnr_mix_stacker): exact median for
        # "median" or short stacks; the memory-bounded median-of-medians
        # approximation otherwise (reference MetLib/stacker.py:62-78);
        # est_bg_var still comes from the full-stack stats
        if mfnr.bg_algorithm == "median" or n <= 16:
            bg_mu = hs.median_frames(stack)
        else:
            bs = int(n ** 0.5)
            medians = [hs.median_frames(stack[i:i + bs])
                       for i in range(0, n, bs)]
            bg_mu = hs.median_frames(torch.stack(medians))
    elif mfnr.bg_algorithm == "sigma-clipping":
        stack = torch.cat(dev_blocks, dim=0)
        bg_mu, bg_var = _clipped_stats(stack, s, sq, n, mfnr.sigma_high,
                                       mfnr.sigma_low)
    dev_blocks.clear()

    gumbel = hs.get_gumbel_mean(n)
    taps = torch.from_numpy(_gaussian_kernel_f32(blur_ksize, 3.0)).to(dev)
    est_bg_mu, est_bg_var, max_bias, fg_blur = _stage1(
        mx, s, sq, n, bg_mu, bg_var, taps, hp=float(hp), gumbel=gumbel,
        bg_fix_factor=float(mfnr.bg_fix_factor))

    if connect_cfg.switch:
        # contour-based reconnection is host OpenCV work on ONE image;
        # fetch max + bias, reconnect, re-upload the corrected max
        max_host = hs.connect_highlight_area(
            mx.cpu().numpy(), max_bias.cpu().numpy(), rep_times=1,
            ksize_multiplier=connect_cfg.ksize_multiplier,
            clip_threshold=connect_cfg.threshold,
            gamma=connect_cfg.gamma, logger=logger)
        mx = torch.from_numpy(max_host).to(dev)

    mixed = _stage2(mx, est_bg_mu, est_bg_var, fg_blur, hp=float(hp),
                    gumbel=gumbel).cpu().numpy()
    last_run_stats["device_math_fetch_s"] = round(
        time.perf_counter() - t_math0, 3)
    logger.debug(f"MFNR-stacked SNR (device): "
                 f"{hs.estimate_snr_smooth_residual(mixed):.2f} db.")
    return mixed
