"""Device-side non-maximum suppression for box predictions.

Counterpart of ``metdetpy_tpu/ops/nms.py``: an O(K^2) IoU-matrix greedy NMS
over a fixed candidate budget: score threshold -> top-K -> sequential
suppression. Shapes are static and nothing syncs with the host. All
functions are batched over a leading image axis (what the JAX package gets
from ``vmap``).
"""

from __future__ import annotations

import torch

from .f32 import fma_f32


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU for xyxy boxes: [..., A, 4] x [..., B, 4] ->
    [..., A, B] float32.

    The union follows the JAX function as XLA's CPU backend compiles it:
    ``area_a + area_b`` is one fused multiply-add of the second area's
    sides onto the rounded first area, and the intersection is subtracted
    unfused."""
    ax1, ay1, ax2, ay2 = [boxes_a[..., :, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [boxes_b[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    union = fma_f32((bx2 - bx1).clamp(min=0), (by2 - by1).clamp(min=0),
                    area_a) - inter
    return inter / union.clamp(min=1e-9)


def top_k_stable(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    descending order, the lower index first among equals (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none among equals)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_xyxy(boxes: torch.Tensor, scores: torch.Tensor, score_thre: float,
             nms_thre: float, top_k: int = 128):
    """Greedy NMS matching cv2.dnn.NMSBoxes semantics.

    Args:
      boxes: [..., N, 4] xyxy float32.
      scores: [..., N] float32.
      score_thre: minimum score to be considered.
      nms_thre: IoU suppression threshold.
      top_k: output budget.

    Returns:
      (keep_idx [..., K] int64 into the input arrays, keep_mask [..., K]
      bool), K = min(top_k, N).
    """
    scores = torch.where(scores >= score_thre, scores,
                         torch.full_like(scores, -1.0))
    top_scores, order = top_k_stable(scores, min(top_k, scores.shape[-1]))
    cand = torch.gather(boxes, -2, order[..., None].expand(
        *order.shape, 4))
    over = iou_matrix(cand, cand) > nms_thre        # [..., K, K]
    k = order.shape[-1]
    alive = top_scores > 0
    # survives if no higher-ranked *kept* box overlaps it above threshold;
    # row i of `over` is final once keep[:i] is, so one step per rank
    keep = torch.zeros_like(alive)
    lower = torch.tril(torch.ones(k, k, dtype=torch.bool,
                                  device=boxes.device), diagonal=-1)
    over = over & lower
    for i in range(k):
        sup = (over[..., i, :] & keep).any(dim=-1)
        keep[..., i] = ~sup & alive[..., i]
    return order, keep
