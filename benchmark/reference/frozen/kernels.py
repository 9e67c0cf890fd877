"""The plain PyTorch versions of the port's four CUDA kernels, as the port
states them (each kernel equals its plain version exactly): the window
diff, the median-binarize-close chain, the Hough vote and the walk's row
pick.

``CONTROL = "bfloat16"`` makes the Hough vote compute and round each rho in
bfloat16, the control of the M3 cell. ``VOTE_POINTS`` gathers the valid
points of every vote since it was last cleared (0-dim int64 tensors), the
work the step's operation bound counts.
"""

from __future__ import annotations

import torch

from . import filters, windows
from .f32 import fma_f32, trig_tables

CONTROL = None
VOTE_POINTS: list = []


def window_diff(history: torch.Tensor, frames: torch.Tensor, n: int,
                      timer0, timer_step: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spec: ``windows.window_stats(...).diff`` and the new history."""
    stats, new_hist = windows.window_stats(history, frames, n, timer0,
                                           timer_step)
    return stats.diff, new_hist


def median_binarize_close(diff: torch.Tensor,
                                thr: torch.Tensor) -> torch.Tensor:
    """Spec: the ``filters`` chain median3x3 -> > thr[t] -> close3x3."""
    binary = filters.binary_threshold(filters.median3x3(diff),
                                      thr[:, None, None])
    return filters.close3x3(binary)


def hough_vote(xs: torch.Tensor, ys: torch.Tensor, valid: torch.Tensor,
                     n_rho: int, rho_offset: int) -> torch.Tensor:
    """Spec: ``metdetpy_tpu/ops/hough.py::_vote`` as a scatter-add. On
    the CPU the columns that are invalid in every frame are left out
    first: they add nothing, and the main path's compacted lists are
    mostly such columns."""
    if xs.device.type == "cpu":
        keep = valid.any(dim=0)
        if not bool(keep.all()):
            xs, ys, valid = xs[:, keep], ys[:, keep], valid[:, keep]
    t, n = xs.shape
    cos_t, sin_t = trig_tables(xs.device)
    VOTE_POINTS.append(valid.sum(dtype=torch.int64))
    if CONTROL == "bfloat16":
        # frozen: the control, rho computed and rounded in bfloat16
        bf = torch.bfloat16
        rho = (cos_t.to(bf)[None, :, None] * xs.to(bf)[:, None, :]
               + sin_t.to(bf)[None, :, None] * ys.to(bf)[:, None, :]
               ).to(torch.float32) + float(rho_offset)
    else:
        rho = fma_f32(cos_t[None, :, None], xs[:, None, :],
                      sin_t[None, :, None] * ys[:, None, :]
                      ) + float(rho_offset)
    q = torch.clamp(torch.round(rho).to(torch.int64), 0, n_rho - 1)
    base = (torch.arange(t * 180, device=xs.device) * n_rho).view(t, 180, 1)
    votes = torch.zeros(t * 180 * n_rho, dtype=torch.int32, device=xs.device)
    weight = valid[:, None, :].expand(t, 180, n).to(torch.int32)
    votes.scatter_add_(0, (base + q).reshape(-1), weight.reshape(-1))
    return votes.view(t, 180, n_rho)


def walk_pick(planes: torch.Tensor, r: torch.Tensor,
                    xmaj: torch.Tensor) -> torch.Tensor:
    """Spec: ``metdetpy_tpu/ops/hough.py::_picks_onehot`` (batched):
    v[b, k, c] = planes[b, 0 if xmaj[b, k] else 1, r[b, k, c], c], and 0
    where r[b, k, c] is outside [0, S)."""
    b, k, s = r.shape
    plane = torch.where(xmaj, 0, 1).to(torch.int64)
    row = r.to(torch.int64)
    inside = (row >= 0) & (row < s)
    col = torch.arange(s, device=r.device)
    lin = (((torch.arange(b, device=r.device)[:, None] * 2 + plane)[..., None]
            * s + row.clamp(0, s - 1)) * s + col)
    v = planes.reshape(-1)[lin].to(torch.int32)
    return torch.where(inside, v, 0)
