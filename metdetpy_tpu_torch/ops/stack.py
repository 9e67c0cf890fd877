"""Frame stackers and stacked-image denoise algorithms.

Behavior parity with reference MetLib/stacker.py:16-482 plus the streaming
FastGaussianParam statistics (reference MetLib/utils.py:418-513): streaming
max/all/mean-var containers, MFNR mixed stacking with Gumbel expected-max
correction, simple dust&scratches + bilateral denoise, and morphological
line re-connection.

These run in the offline export path (``python -m metdetpy_tpu_torch.clip``);
the pixel math uses numpy/cv2 on host over single stacked images. The
host parts are copies of the JAX package's ``ops/stack.py``; the device
parts (the large-stack median, the MFNR placement and its link probe)
take an explicit ``device`` and run PyTorch there.

Failures propagate: a device median or a device MFNR that raises is not
replaced by the host result, a placement probe that raises is not read
as "host", and a loader that raises mid-stack ends the stack (the JAX
package logs these and carries on).
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import cv2
import numpy as np
import torch

from .. import resolve_device
from ..log import BaseMetLog, get_useable_logger
from ..structs import DenoiseOption
from ..utils import EULER_CONSTANT, circular_kernel

SUPPORT_BG_ALGO = ["median", "med-of-med", "sigma-clipping", "mean"]

DTYPE_UPSCALE_MAP = {
    np.dtype("uint8"): np.dtype("uint16"),
    np.dtype("uint16"): np.dtype("uint32"),
    np.dtype("uint32"): np.dtype("uint64"),
    np.dtype("uint64"): np.dtype("float64"),
}


class FastGaussianParam:
    """Streaming mean/variance in integer arithmetic with dtype upscaling
    and add/sub/mask algebra (reference MetLib/utils.py:418-513)."""

    def __init__(self, sum_mu: np.ndarray,
                 square_sum: Optional[np.ndarray] = None,
                 n: Optional[np.ndarray] = None, ddof: int = 1,
                 dtype_n=np.dtype("int16")) -> None:
        self.sum_mu = sum_mu
        if square_sum is not None:
            self.square_sum = square_sum
        else:
            sq_dtype = DTYPE_UPSCALE_MAP.get(sum_mu.dtype, np.float64)
            self.square_sum = np.square(sum_mu, dtype=sq_dtype)
        self.n = n if n is not None else np.ones_like(sum_mu, dtype=dtype_n)
        self.ddof = ddof

    @property
    def mu(self) -> np.ndarray:
        return np.round(self.sum_mu / self.n)

    @property
    def var(self) -> np.ndarray:
        sum_mu = np.asarray(self.sum_mu, dtype=self.square_sum.dtype)
        return (self.square_sum
                - np.square(sum_mu) / self.n) / (self.n - self.ddof)

    def __add__(self, other: "FastGaussianParam") -> "FastGaussianParam":
        assert self.ddof == other.ddof
        return FastGaussianParam(sum_mu=self.sum_mu + other.sum_mu,
                                 square_sum=self.square_sum
                                 + other.square_sum,
                                 n=self.n + other.n, ddof=self.ddof)

    def __sub__(self, other: "FastGaussianParam") -> "FastGaussianParam":
        assert self.ddof == other.ddof
        return FastGaussianParam(sum_mu=self.sum_mu - other.sum_mu,
                                 square_sum=self.square_sum
                                 - other.square_sum,
                                 n=self.n - other.n, ddof=self.ddof)

    def mask(self, mask_pos: np.ndarray) -> None:
        assert mask_pos.dtype == np.dtype("bool")
        self.sum_mu = self.sum_mu * mask_pos
        self.square_sum = self.square_sum * mask_pos
        self.n = np.asarray(mask_pos, dtype=np.uint16)

    @property
    def shape(self):
        return self.sum_mu.shape


# ---------------------------------------------------------------------------
# Streaming containers
# ---------------------------------------------------------------------------


class BaseImgContainer:
    def __init__(self):
        self.container = None

    def append(self, new_frame: np.ndarray) -> None:
        pass

    def export(self):
        return self.container


class AllImgContainer(BaseImgContainer):
    def __init__(self):
        self.container: list[np.ndarray] = []

    def append(self, new_frame):
        self.container.append(new_frame)


class MaxImgContainer(BaseImgContainer):
    def append(self, new_frame):
        if self.container is None:
            # copy: the loader may recycle new_frame's buffer after pop
            self.container = new_frame.copy()
        else:
            np.maximum(self.container, new_frame, out=self.container)


class FastGaussianContainer(BaseImgContainer):
    """Streaming sum / square-sum accumulation for FastGaussianParam.

    Accumulates in-place into two preallocated arrays instead of building
    a per-frame FastGaussianParam chain: the object-algebra path allocates
    ~240 MB of temporaries per 1080p color frame (astype, square,
    ones_like, three __add__ results). The in-place path is
    bit-equal: same uint16 sum / uint32 square-sum dtypes as the
    reference's chained adds (MetLib/utils.py:418-513), n materialized
    once at export. The uint16 sum wraps after 257 frames of 255, as the
    reference's does; the device accumulators do not (int64 sums)."""

    def __init__(self):
        self._sum = None
        self._sq = None
        self._n = 0

    def append(self, new_frame):
        if self._sum is None:
            self._sum = new_frame.astype(np.uint16)
            self._sq = np.square(self._sum, dtype=np.uint32)
        else:
            np.add(self._sum, new_frame, out=self._sum)
            sq = np.multiply(new_frame, new_frame, dtype=np.uint16)
            np.add(self._sq, sq, out=self._sq)
        self._n += 1

    def export(self):
        if self._sum is None:
            return None
        return FastGaussianParam(
            self._sum, self._sq,
            n=np.full(self._sum.shape, self._n, dtype=np.int16))


def _batch_stacker(video_loader, container_cls_list, start_frame=None,
                   end_frame=None) -> list[Any]:
    """Stream the loader's frames into the containers. An exception (a
    loader failure, a frame of another shape) ends the stack and
    propagates; the JAX package logs it and returns the partial stacks."""
    containers = [c() for c in container_cls_list]
    try:
        if start_frame is not None or end_frame is not None:
            video_loader.reset(start_frame=start_frame, end_frame=end_frame)
        base_shape = None
        video_loader.start()
        for _ in range(video_loader.iterations):
            frame = video_loader.pop()
            if frame is None:
                break
            if base_shape is None:
                base_shape = frame.shape
            elif base_shape != frame.shape:
                raise ValueError(f"frame shape changed: {base_shape} vs "
                                 f"{frame.shape}")
            for c in containers:
                c.append(frame)
    finally:
        video_loader.stop()
    return [c.export() for c in containers]


def all_stacker(video_loader, start_frame=None, end_frame=None, logger=None):
    """Every frame of the range (``logger`` is taken for the reference's
    signature; a failure raises)."""
    return _batch_stacker(video_loader, [AllImgContainer], start_frame,
                          end_frame)[0]


def max_stacker(video_loader, start_frame=None, end_frame=None, logger=None):
    """The max stack of the range (``logger`` as in ``all_stacker``)."""
    return _batch_stacker(video_loader, [MaxImgContainer], start_frame,
                          end_frame)[0]


# ---------------------------------------------------------------------------
# Background estimation helpers
# ---------------------------------------------------------------------------


# The JAX package's constant, kept as it is: its "device pays off" size
# was reckoned for a TPU behind a network link, not for this port's card.
DEVICE_MEDIAN_MIN_ELEMS = 64 << 20  # ~64M elements


_LINK_BPS_CACHE: dict[str, tuple[float, float]] = {}


def _probe_link_bps(device) -> tuple[float, float]:
    """(h2d, d2h) bandwidths in bytes/s between the host and ``device``,
    probed once per process and device.

    A four-frame 1080p gray block goes up from pinned memory and two of
    its frames come back into pinned memory, each leg timed from its
    launch to ``torch.cuda.synchronize``; a small copy first pays the
    first-transfer setup.
    Three rounds, the best rate per direction (the JAX package's rule: the
    job rides many transfers, so capability, not one instant, is the
    placement's input). On the CPU both legs are plain copies."""
    dev = torch.device(device)
    key = str(dev)
    if key not in _LINK_BPS_CACHE:
        cuda = dev.type == "cuda"
        up = torch.zeros((4, 1080, 1920), dtype=torch.uint8, pin_memory=cuda)
        down = torch.empty((2, 1080, 1920), dtype=torch.uint8,
                           pin_memory=cuda)
        dst = torch.empty(up.shape, dtype=torch.uint8, device=dev)

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        dst[:1, :1].copy_(up[:1, :1])
        down[:1, :1].copy_(dst[:1, :1])
        sync()
        best_up = best_down = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            dst.copy_(up, non_blocking=cuda)
            sync()
            t_up = time.perf_counter() - t0
            t0 = time.perf_counter()
            down.copy_(dst[:2], non_blocking=cuda)
            sync()
            t_down = time.perf_counter() - t0
            best_up = max(best_up, up.numel() / max(t_up, 1e-9))
            best_down = max(best_down, down.numel() / max(t_down, 1e-9))
        _LINK_BPS_CACHE[key] = (best_up, best_down)
    return _LINK_BPS_CACHE[key]


def _device_median_wins(img_list: list[np.ndarray], n_elems: int,
                        device) -> bool:
    """Transport-aware placement for the big median sort: extrapolate the
    host cost from a row-slice pilot and compare against the estimated
    device round trip (upload the whole stack, read back one f32 frame,
    plus the JAX package's 0.3 s dispatch slack). On the CPU the "device"
    is the host itself: no win."""
    if torch.device(device).type == "cpu":
        return False
    rows = max(1, img_list[0].shape[0] // 16)
    pilot = [img[:rows] for img in img_list]
    t0 = time.perf_counter()
    _host_median(pilot)
    t_host = (time.perf_counter() - t0) * (img_list[0].shape[0] / rows)
    h2d, d2h = _probe_link_bps(device)
    out_bytes = int(np.prod(img_list[0].shape)) * 4  # one f32 frame
    t_dev = n_elems / h2d + out_bytes / d2h + 0.3  # dispatch slack
    return t_dev < t_host


def _host_median(img_list: list[np.ndarray]) -> np.ndarray:
    """Exact median along the stack axis without np.median's internal
    float64 conversion: np.median promotes a uint8 stack to float64
    BEFORE sorting (8x the memory traffic -- ~3 GB for a 64-frame 1080p
    color stack). np.partition on the native dtype + mean-of-two-middles
    is bit-equal to np.median."""
    s = np.stack(img_list)
    t, mid = s.shape[0], s.shape[0] // 2
    out_dtype = np.float64 if s.dtype.kind in "iub" else s.dtype
    if t % 2:
        return np.partition(s, mid, axis=0)[mid].astype(out_dtype)
    p = np.partition(s, (mid - 1, mid), axis=0)
    return (p[mid - 1].astype(out_dtype) + p[mid]) / 2.0


def median_frames(stack: torch.Tensor) -> torch.Tensor:
    """``jnp.median(stack.astype(f32), axis=0)`` for a [T, ...] tensor on
    any device: the middle value for an odd T, the mean of the two middle
    values for an even T, in float32 (``torch.median`` returns the lower
    middle, and ``torch.quantile`` refuses inputs over 2^24 elements).
    Sorts along the frame axis in the input's dtype; the mean of two
    uint8 values or of two halves is exact in float32."""
    t = stack.shape[0]
    srt = torch.sort(stack, dim=0).values
    lo = srt[(t - 1) // 2].to(torch.float32)
    if t % 2:
        return lo
    return (lo + srt[t // 2].to(torch.float32)) * 0.5


def stack_median(img_list: list[np.ndarray], device="cuda") -> np.ndarray:
    """Median over a frame stack; large stacks sort on ``device`` when the
    link can carry them.

    The exact-median background estimate is the dominant cost of the
    MFNR export path (the reference reports mfnr-mix >5x slower than a
    plain max stack, docs/update-log.md:154). Above the size gate the
    sort runs on the device instead (identical mean-of-two-middles
    semantics, ``median_frames``) -- but only if the measured link beats
    the pilot-extrapolated host sort (``_device_median_wins``).
    ``METDETPY_TPU_DEVICE_MEDIAN`` = ``force``/``0`` overrides; small
    stacks take the partition-based host median (``_host_median``). A
    device median that fails raises (no host fallback).
    """
    n_elems = len(img_list) * int(np.prod(img_list[0].shape))
    if n_elems >= DEVICE_MEDIAN_MIN_ELEMS:
        mode = os.environ.get("METDETPY_TPU_DEVICE_MEDIAN", "auto")
        if mode != "0":
            dev = resolve_device(device)
            if mode == "force" or _device_median_wins(img_list, n_elems,
                                                      dev):
                stack = torch.from_numpy(np.stack(img_list))
                if dev.type == "cuda":
                    stack = stack.pin_memory()
                out = median_frames(stack.to(dev, non_blocking=True))
                return out.cpu().numpy().astype(np.float64)
    return _host_median(img_list)


def median_of_medians(img_list: list[np.ndarray],
                      block_size: Optional[int] = None,
                      device="cuda") -> np.ndarray:
    """Memory-bounded approximate median (reference
    MetLib/stacker.py:62-78)."""
    if block_size is None:
        block_size = int(len(img_list) ** 0.5)
    block_num = (len(img_list) - 1) // block_size + 1
    medians = [stack_median(img_list[i * block_size:(i + 1) * block_size],
                            device)
               for i in range(block_num)]
    return _host_median(medians)


def single_sigma_clipping(img_list: list[np.ndarray],
                          ref_fg_img: FastGaussianParam,
                          sigma_high: float = 3.0,
                          sigma_low: float = 3.0) -> FastGaussianParam:
    """One-pass sigma clipping against the full-stack statistics
    (reference MetLib/stacker.py:91-111)."""
    mu, std = ref_fg_img.mu, np.sqrt(ref_fg_img.var)
    hi = np.round(mu + sigma_high * std).clip(0, 255).astype(np.uint8)
    lo = np.round(mu - sigma_low * std).clip(0, 255).astype(np.uint8)
    if not img_list:
        return ref_fg_img
    # stream the rejected-sample statistics in place (the per-frame
    # FastGaussianParam chain allocated ~240 MB of temporaries per
    # 1080p frame); bit-equal: clipped accumulates the REJECTED samples
    # and is subtracted from the full-stack stats
    rej_sum = np.zeros(img_list[0].shape, np.uint16)
    rej_sq = np.zeros(img_list[0].shape, np.uint32)
    rej_n = np.zeros(img_list[0].shape, np.uint16)
    for img in img_list:
        reject = (img > hi) | (img < lo)
        rejected = np.multiply(img, reject, dtype=np.uint16)
        np.add(rej_sum, rejected, out=rej_sum)
        np.add(rej_sq, np.multiply(rejected, rejected, dtype=np.uint32),
               out=rej_sq)
        np.add(rej_n, reject, out=rej_n)
    clipped = FastGaussianParam(rej_sum, rej_sq, n=rej_n,
                                ddof=ref_fg_img.ddof)
    return ref_fg_img - clipped


def get_gumbel_mean(n: int) -> float:
    """Expected maximum of n standard-normal samples (Gumbel approximation;
    reference MetLib/stacker.py:114-125)."""
    s = np.sqrt(2 * np.log(n))
    return float(s - (np.log(np.log(n)) + np.log(4 * np.pi)) / (2 * s)
                 + EULER_CONSTANT / s)


def estimate_snr_smooth_residual(image: np.ndarray,
                                 kernel_size: int = 5) -> float:
    """Reference-free SNR estimate via smooth-residual decomposition
    (reference MetLib/utils.py:1009-1045)."""
    if image.ndim == 3:
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    else:
        gray = image.copy()
    smooth = cv2.GaussianBlur(gray, (kernel_size, kernel_size), 0)
    residual = gray.astype(np.float32) - smooth.astype(np.float32)
    var_signal = np.var(smooth)
    var_noise = np.var(residual)
    if var_noise == 0:
        return float("inf")
    return float(10 * np.log10(var_signal / var_noise))


# ---------------------------------------------------------------------------
# Denoise building blocks
# ---------------------------------------------------------------------------


def gamma_luminance_transform(img: np.ndarray, gamma: float) -> np.ndarray:
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
    L, A, B = cv2.split(lab)
    table = np.power(np.arange(256) / 255.0, gamma) * 255
    L = cv2.LUT(L, table.astype(np.uint8))
    return cv2.cvtColor(cv2.merge([L, A, B]), cv2.COLOR_Lab2BGR)


def dust_and_scratches(img: np.ndarray, radius: int,
                       threshold: int) -> np.ndarray:
    """Photoshop-style dust & scratches filter: median-replace luminance
    outliers (reference MetLib/stacker.py:216-238)."""
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
    L, A, B = cv2.split(lab)
    median_l = cv2.medianBlur(L, 2 * radius + 1)
    keep = cv2.absdiff(L, median_l) > threshold
    L_result = L.copy()
    L_result[keep] = median_l[keep]
    return cv2.cvtColor(cv2.merge([L_result, A, B]), cv2.COLOR_Lab2BGR)


def fill_large_contours(src: np.ndarray, max_allow_area: int = 30
                        ) -> np.ndarray:
    contours, _ = cv2.findContours(src, cv2.RETR_CCOMP,
                                   cv2.CHAIN_APPROX_SIMPLE)
    for cnt in contours:
        if cv2.contourArea(cnt) > max_allow_area:
            cv2.drawContours(src, [cnt], 0, [0, 0, 0], -1)
    return src


def connect_highlight_area(light_img: np.ndarray, light_diff_img: np.ndarray,
                           rep_times: int = 1, ksize_multiplier: float = 1.0,
                           clip_threshold: int = 30, gamma: float = 1.0,
                           logger: Optional[BaseMetLog] = None) -> np.ndarray:
    """Morphologically reconnect broken bright trails
    (reference MetLib/stacker.py:241-293)."""
    logger = get_useable_logger(logger)
    clipped = cv2.cvtColor(
        np.clip(light_diff_img, clip_threshold, 255).astype(np.uint8),
        cv2.COLOR_BGR2GRAY)
    otsu_thresh, highlight_mask = cv2.threshold(
        clipped, 0, 1, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    logger.debug(f"Extreme highlight threshold = {otsu_thresh:.2f}")
    masked_light = light_img * highlight_mask[..., None]
    init_mask = highlight_mask.copy()
    ksize = int((max(light_img.shape) * 0.01 * ksize_multiplier) // 2 * 2 + 1)
    kernel = circular_kernel(ksize)
    highlight_mask = cv2.morphologyEx(highlight_mask, cv2.MORPH_CLOSE, kernel,
                                      iterations=rep_times)
    masked_light = cv2.morphologyEx(masked_light, cv2.MORPH_CLOSE, kernel,
                                    iterations=rep_times)
    hat = fill_large_contours(highlight_mask - init_mask, 20)
    masked_light = gamma_luminance_transform(masked_light, gamma=gamma)
    ext = masked_light * hat[..., None]
    return np.maximum(light_img, ext)


# ---------------------------------------------------------------------------
# Export stackers
# ---------------------------------------------------------------------------


def _device_denoise_wins(video_loader, denoise_cfg=None,
                         device="cuda") -> bool:
    """Transport-aware placement of the MFNR pixel math.

    With a stack-free background ("mean", the global/clip_cfg.json
    default) the device path can run in host-reduced mode — stream the
    (max, sum, sqsum) reduction on host during decode, fold sum/sqsum
    down to the rounded-mean u8 plane + the scalar bg std, and upload
    just (max, mu, fg mask) (~2.3 B/px) instead of every frame — so the
    link cost is a constant ~14 MB at 1080p color, set against the host's
    own stage math. Stack-needing backgrounds (median/sigma-clipping)
    must upload the whole clip, so they compare full clip bytes against
    the host pixel-math estimate. The host estimates (1.5 s for the stage
    math and 0.035 s a frame at 1080p) are the JAX package's constants,
    reckoned on its own host, kept as they are; this port has not
    measured them. On the CPU the "device" is the host itself: no win.
    ``METDETPY_TPU_DEVICE_DENOISE`` = ``force``/``0`` overrides the
    probe."""
    mode = os.environ.get("METDETPY_TPU_DEVICE_DENOISE", "auto")
    if mode == "0":
        return False
    if mode == "force":
        return True
    if torch.device(device).type == "cpu":
        return False
    w, h = video_loader.runtime_size
    frames = video_loader.iterations
    bg_algo = (denoise_cfg.mfnr_param.bg_algorithm
               if denoise_cfg is not None else None)
    px_scale = h * w / (1920 * 1080)
    h2d, _ = _probe_link_bps(device)
    if bg_algo == "mean":
        # host-reduced upload: ~2.3 B/px once (max u8 + mu u8 + 1-channel
        # fg mask) + the final u8 readback; the host keeps the streaming
        # accumulate either way, so the comparison is link time vs the
        # host's stage math
        upload_bytes = 2 * h * w * 3 + h * w
        host_stage_est_s = 1.5 * px_scale
        return upload_bytes / h2d < host_stage_est_s
    upload_bytes = frames * h * w * 3
    host_est_s = frames * px_scale * 0.035
    return upload_bytes / h2d < host_est_s


def _var_f32(fg: FastGaussianParam) -> np.ndarray:
    """Sample variance of a FastGaussianParam in float32. The f64 `var`
    property materializes ~250 MB of temporaries at 1080p; only the
    scalar mean(sqrt(var)) is consumed here, and the f32 cancellation
    error is <<1 gray level for u8 stacks. Clamped at 0: unlike exact
    integer-in-f64 math, f32 cancellation can go slightly negative,
    which would NaN the sqrt."""
    n = np.asarray(fg.n, np.float32)
    s = np.asarray(fg.sum_mu, np.float32)
    out = fg.square_sum.astype(np.float32)  # always copies (u32 source)
    out -= s * s / n
    out /= n - fg.ddof
    return np.maximum(out, 0, out=out)


def mfnr_mix_stacker(video_loader, denoise_cfg: DenoiseOption,
                     start_frame=None, end_frame=None,
                     logger: Optional[BaseMetLog] = None, device="cuda"
                     ) -> Optional[np.ndarray]:
    """MFNR mixed stacking: estimate the background, correct the max-stack
    by the Gumbel expected maximum, feather the foreground mask, and blend
    max + mean images (reference MetLib/stacker.py:296-403).

    ``device`` (``cuda``, the default, raises without a card) is where the
    device form runs when ``_device_denoise_wins`` places the pixel math
    there (``ops.stack_device.mfnr_mix_device``); a failure there
    propagates (the JAX package falls back to the host path)."""
    logger = get_useable_logger(logger)
    dev = resolve_device(device)
    if _device_denoise_wins(video_loader, denoise_cfg, dev):
        from .stack_device import mfnr_mix_device
        return mfnr_mix_device(video_loader, denoise_cfg, start_frame,
                               end_frame, logger, device=dev)
    hp, blur_ksize = denoise_cfg.highlight_preserve, denoise_cfg.blur_ksize
    connect_cfg, mfnr = denoise_cfg.connect_lines, denoise_cfg.mfnr_param
    max_img, img_stack, init_fg = _batch_stacker(
        video_loader, [MaxImgContainer, AllImgContainer,
                       FastGaussianContainer], start_frame, end_frame)
    if max_img is None or not img_stack or init_fg is None:
        return None
    logger.debug(f"Max-stack SNR: "
                 f"{estimate_snr_smooth_residual(max_img):.2f} db.")
    assert mfnr.bg_algorithm in SUPPORT_BG_ALGO, \
        f"unsupported bg algo {mfnr.bg_algorithm}"
    # The pixel math below runs in float32 on a single mask channel in
    # place of the reference's float64 [H, W, 3] intermediates
    # (repeat-to-3-channels mask, f64 GaussianBlur, ~10 full-frame f64
    # temporaries); the blurred mask is identical per channel, and the
    # output is u8, so f32 differs only within rounding noise (reference
    # MetLib/stacker.py:296-403).
    if mfnr.bg_algorithm == "sigma-clipping":
        sc = single_sigma_clipping(img_stack, init_fg,
                                   sigma_high=mfnr.sigma_high,
                                   sigma_low=mfnr.sigma_low)
        est_bg_mu = sc.mu.astype(np.float32)
        est_bg_var = float(np.mean(np.sqrt(_var_f32(sc))))
    elif mfnr.bg_algorithm == "mean":
        est_bg_mu = init_fg.mu.astype(np.float32)
        est_bg_var = float(np.mean(np.sqrt(_var_f32(init_fg))))
    else:
        if mfnr.bg_algorithm == "median" or len(img_stack) <= 16:
            est_bg_mu = stack_median(img_stack, dev).astype(np.float32)
        else:
            est_bg_mu = median_of_medians(img_stack,
                                          device=dev).astype(np.float32)
        est_bg_var = float(np.mean(np.sqrt(_var_f32(init_fg))))

    gumbel_mean = get_gumbel_mean(len(img_stack))
    bg_lift = np.float32(est_bg_var * gumbel_mean * mfnr.bg_fix_factor)
    max_f = max_img.astype(np.float32)
    max_bias = max_f - est_bg_mu
    max_bias -= bg_lift
    pos_bias = max_bias[max_bias > 0]
    highlight_avg = np.float32(np.average(pos_bias) if pos_bias.size
                               else 0.0)
    fg_any = np.any((max_bias > highlight_avg) | (max_f > 255 * hp),
                    axis=-1).astype(np.float32)
    fg_blur = cv2.GaussianBlur(fg_any, ksize=(blur_ksize, blur_ksize),
                               sigmaX=3)[..., None]
    if connect_cfg.switch:
        max_img = connect_highlight_area(
            max_img, max_bias, rep_times=1,
            ksize_multiplier=connect_cfg.ksize_multiplier,
            clip_threshold=connect_cfg.threshold, gamma=connect_cfg.gamma,
            logger=logger)
        max_f = max_img.astype(np.float32)
    # brightness correction with highlight protection (factor -> 0 at 255)
    fix_factor = 1 - ((max_f / 255 - hp).clip(0, 1) / (1 - hp))
    fixed_max = np.clip(max_f - est_bg_var * gumbel_mean * fix_factor,
                        0, 255)
    mixed = np.round(fixed_max * fg_blur
                     + est_bg_mu * (1 - fg_blur)).astype(np.uint8)
    logger.debug(f"MFNR-stacked SNR: "
                 f"{estimate_snr_smooth_residual(mixed):.2f} db.")
    return mixed


def simple_denoise(max_img: np.ndarray, denoise_cfg: DenoiseOption,
                   logger: BaseMetLog) -> np.ndarray:
    """Single-image denoise: dust&scratches background split + bilateral
    background + feathered blend (reference MetLib/stacker.py:431-482)."""
    hp, blur_ksize = denoise_cfg.highlight_preserve, denoise_cfg.blur_ksize
    connect_cfg, simple = denoise_cfg.connect_lines, denoise_cfg.simple_param
    logger.debug(f"Max-stack SNR: "
                 f"{estimate_snr_smooth_residual(max_img):.2f} db.")
    est_bg = dust_and_scratches(max_img, radius=simple.ds_radius,
                                threshold=simple.ds_threshold)
    # f32 single-channel mask math (see mfnr_mix_stacker): the blurred
    # mask is identical per channel and the u8 output differs from the
    # f64 formulation only within float rounding
    max_f = max_img.astype(np.float32)
    max_diff = max_f - est_bg
    pos = max_diff[max_diff > 0]
    highlight_avg = np.float32(np.average(pos) if pos.size else 0.0)
    fg_any = np.any((max_diff > highlight_avg) | (max_f > 255 * hp),
                    axis=-1).astype(np.float32)
    fg_blur = cv2.GaussianBlur(fg_any, ksize=(blur_ksize, blur_ksize),
                               sigmaX=3)[..., None]
    cp_max = np.asarray(max_img)
    if connect_cfg.switch:
        star_filter = circular_kernel(3)
        filtered_diff = cv2.morphologyEx(max_diff, cv2.MORPH_OPEN, star_filter)
        cp_max = connect_highlight_area(
            cp_max, filtered_diff, rep_times=1,
            ksize_multiplier=connect_cfg.ksize_multiplier,
            clip_threshold=connect_cfg.threshold, gamma=connect_cfg.gamma,
            logger=logger)
    bg = cv2.bilateralFilter(max_img, d=simple.bi_d,
                             sigmaColor=simple.bi_sigma_color,
                             sigmaSpace=simple.bi_sigma_space)
    mixed = (fg_blur * cp_max + (1 - fg_blur) * bg).astype(np.uint8)
    logger.debug(f"Denoised SNR: "
                 f"{estimate_snr_smooth_residual(mixed):.2f} db.")
    return mixed


def simple_denoise_stacker(video_loader, denoise_cfg: DenoiseOption,
                           start_frame=None, end_frame=None,
                           logger: Optional[BaseMetLog] = None
                           ) -> Optional[np.ndarray]:
    logger = get_useable_logger(logger)
    max_img = _batch_stacker(video_loader, [MaxImgContainer], start_frame,
                             end_frame)[0]
    if max_img is None:
        return None
    return simple_denoise(max_img, denoise_cfg, logger)
