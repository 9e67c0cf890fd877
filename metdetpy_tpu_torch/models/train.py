"""YOLOv5s training of the port: loss, target assignment, train step,
synthetic fit.

Counterpart of ``metdetpy_tpu/models/train.py``: a YOLOv5-style loss (BCE
objectness + BCE class + box regression on the decoded parameterization),
a host-side anchor assigner building dense per-head targets, a train step
by autograd with the JAX package's optimiser (``Adam``: optax's
``chain(clip_by_global_norm, adam(schedule))``), its data-parallel form
over a ``(dp, mdl)`` mesh, and the synthetic-scene fit that produces the
shipped weights. The batch norms stay frozen, as in the JAX package (its
``BatchNorm`` uses the running averages and the step does not update
them): their running statistics are buffers, not parameters, so only the
parameters receive gradients.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..log import BaseMetLog
from ..parallel.mesh import GridMesh, canonical
from ..profiling import StageTimer
from . import yolov5
from .weights import params_from_flax

ANCHOR_T = 4.0  # wh-ratio matching threshold (ultralytics default)


# ---------------------------------------------------------------------------
# Target assignment (host, numpy)
# ---------------------------------------------------------------------------


def build_dense_targets(boxes_list: Sequence[np.ndarray],
                        labels_list: Sequence[np.ndarray],
                        input_hw: tuple[int, int], nc: int,
                        anchors=yolov5.DEFAULT_ANCHORS,
                        strides=yolov5.STRIDES):
    """Build dense per-head targets from per-image xyxy boxes + labels.

    Returns a list over heads of (tgt [B,h,w,3,5+nc], mask [B,h,w,3]):
    a GT is assigned to every anchor whose w/h ratio to the GT box is
    within ANCHOR_T at the grid cell containing the box center.
    """
    b = len(boxes_list)
    out = []
    for anc, stride in zip(anchors, strides):
        gh, gw = input_hw[0] // stride, input_hw[1] // stride
        tgt = np.zeros((b, gh, gw, 3, 5 + nc), np.float32)
        mask = np.zeros((b, gh, gw, 3), np.float32)
        for bi, (boxes, labels) in enumerate(zip(boxes_list, labels_list)):
            for box, label in zip(boxes, labels):
                x1, y1, x2, y2 = [float(v) for v in box]
                cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
                w, h = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
                gx, gy = int(cx / stride), int(cy / stride)
                if not (0 <= gx < gw and 0 <= gy < gh):
                    continue
                for ai, (aw, ah) in enumerate(anc):
                    r = max(w / aw, aw / w, h / ah, ah / h)
                    if r > ANCHOR_T:
                        continue
                    tgt[bi, gy, gx, ai, 0:4] = (cx, cy, w, h)
                    tgt[bi, gy, gx, ai, 4] = 1.0
                    tgt[bi, gy, gx, ai, 5 + int(label)] = 1.0
                    mask[bi, gy, gx, ai] = 1.0
        out.append((tgt, mask))
    return out


def target_norms(targets) -> list[tuple[float, int]]:
    """The loss's divisors of each head for a batch's targets: (n_pos, the
    positives counted at least once; n_cells, the anchor cells the
    objectness mean runs over)."""
    return [(max(float(np.sum(mask)), 1.0), int(np.size(mask)))
            for _, mask in targets]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, in its form (torch's
    ``binary_cross_entropy_with_logits`` evaluates another formula)."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


@functools.lru_cache(maxsize=None)
def _anchor_tensor(anc: tuple, dev: torch.device) -> torch.Tensor:
    """A head's anchors [3, 2] on ``dev``, copied there once: a copy from
    the host in every step would hold the host until the device has run
    the queued forward."""
    return torch.tensor(anc, dtype=torch.float32, device=dev)


def yolo_loss(heads: Sequence[torch.Tensor], targets, nc: int,
              anchors=yolov5.DEFAULT_ANCHORS, strides=yolov5.STRIDES,
              box_w: float = 0.05, obj_w: float = 1.0, cls_w: float = 0.5,
              norms: Optional[Sequence[tuple[float, int]]] = None
              ) -> torch.Tensor:
    """YOLOv5-style loss over raw head outputs ([B, h, w, 3*(5+nc)]
    float32) and dense targets (tensors on the heads' device).

    ``norms`` (``target_norms`` of a batch) are the divisors of the box,
    objectness and class terms; by default this batch's own. A shard of a
    larger batch passes the whole batch's, so that the shards' losses (and
    gradients) add up to the batch's."""
    total = 0.0
    for i, (head, (tgt, mask), anc, stride) in enumerate(
            zip(heads, targets, anchors, strides)):
        b, gh, gw, _ = head.shape
        dev = head.device
        p = head.reshape(b, gh, gw, 3, 5 + nc)
        # decode boxes with the v5 parameterization
        sig = torch.sigmoid(p[..., 0:4])
        gx = torch.arange(gw, dtype=torch.float32, device=dev)[None, None, :,
                                                               None]
        gy = torch.arange(gh, dtype=torch.float32, device=dev)[None, :, None,
                                                               None]
        anc_wh = _anchor_tensor(tuple(map(tuple, anc)), dev)
        anc_w, anc_h = anc_wh[:, 0], anc_wh[:, 1]
        px = (sig[..., 0] * 2 - 0.5 + gx) * stride
        py = (sig[..., 1] * 2 - 0.5 + gy) * stride
        pw = torch.square(sig[..., 2] * 2) * anc_w
        ph = torch.square(sig[..., 3] * 2) * anc_h
        # box regression: normalized squared error (a CIoU-lite surrogate)
        scale = float(stride * 8)
        box_err = (torch.square((px - tgt[..., 0]) / scale)
                   + torch.square((py - tgt[..., 1]) / scale)
                   + torch.square((pw - tgt[..., 2]) / scale)
                   + torch.square((ph - tgt[..., 3]) / scale))
        if norms is None:
            n_pos, n_cells = torch.clamp(torch.sum(mask), min=1.0), mask.numel()
        else:
            n_pos, n_cells = norms[i]
        box_loss = torch.sum(box_err * mask) / n_pos
        obj_loss = torch.sum(_bce(p[..., 4], tgt[..., 4])) / n_cells
        cls_loss = (torch.sum(_bce(p[..., 5:], tgt[..., 5:]) * mask[..., None])
                    / (n_pos * nc))
        total = total + box_w * box_loss + obj_w * obj_loss + cls_w * cls_loss
    return total


# ---------------------------------------------------------------------------
# Optimiser
# ---------------------------------------------------------------------------


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` in float32 as XLA compiles it:
    ``init_value * fma(1 - alpha, 0.5 * (1 + cos(pi * min(count,
    decay_steps) / decay_steps)), alpha)``, the cosine correctly rounded
    (XLA's own approximation of it differs in the last bit for some
    counts)."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, not {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        x = f32(math.pi) * f32(min(count, decay_steps)) / f32(decay_steps)
        cosine = f32(0.5) * (f32(1) + f32(math.cos(float(x))))
        decayed = f32(float(f32(1 - alpha)) * float(cosine) + float(
            f32(alpha)))
        return float(f32(init_value) * decayed)

    return schedule


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c) of float32 operands as one fused multiply-add
    (float64 holds the product exactly)."""
    return (a.double() * b + c.double()).float()


class Adam:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(lr))`` over the
    parameters that require a gradient (``max_norm=None``: plain
    ``adam(lr)``), with the arithmetic of the JAX package's jitted step.
    ``lr`` is a number or a schedule of the update count before the step,
    as optax evaluates it.

    Clipping is optax's: ``where(norm < max_norm, g, g / norm * max_norm)``
    with the global norm over every gradient (its sum of squares taken in
    float64, then rounded; torch's ``clip_grad_norm_`` scales by
    ``max_norm / (norm + 1e-6)`` every time). Adam is optax's with b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0 and bias correction ``bc = 1 - b**count``
    in float32, in the form XLA compiles the chain: ``mu = fma(1 - b1, g, b1
    * mu)``, ``nu = fma(b2, nu, (1 - b2) * g * g)``, ``p = fma(-lr, mu /
    (bc1 * (sqrt(nu / bc2) + eps)), p)`` (without the clip XLA contracts
    nu's other product, ``fma(1 - b2, g * g, b2 * nu)``: the last bits of
    plain ``adam`` may differ).

    The parameters become views of one flat float32 buffer (their
    ``.data`` is re-pointed), as are the moments, so a step is a handful
    of launches whatever the number of parameter tensors."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 max_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.params = [p for p in params if p.requires_grad]
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("Adam keeps float32 parameters")
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.max_norm, self.eps = max_norm, eps
        f32 = np.float32
        self.b1, self.b2 = f32(b1), f32(b2)
        self.c1, self.c2 = float(f32(1 - b1)), float(f32(1 - b2))
        with torch.no_grad():
            self.flat = torch.cat([p.reshape(-1) for p in self.params])
            off = 0
            for p in self.params:
                p.data = self.flat[off:off + p.numel()].view(p.shape)
                off += p.numel()
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (each must be set)."""
        g = torch.cat([p.grad.reshape(-1) for p in self.params])
        if self.max_norm is not None:
            g_norm = torch.sqrt(torch.sum(torch.square(g.double())).float())
            g = torch.where(g_norm < self.max_norm, g,
                            g / g_norm * self.max_norm)
        f32 = np.float32
        neg_lr = float(-f32(self.lr(self.count)))
        self.count += 1
        bc1 = float(f32(1) - self.b1 ** f32(self.count))
        bc2 = float(f32(1) - self.b2 ** f32(self.count))
        self.mu = _fma(g, self.c1, self.mu * float(self.b1))
        self.nu = _fma(self.nu, float(self.b2), self.c2 * (g * g))
        # the quotient and the root rounded once from float64, as IEEE
        # float32 would (torch's vectorised CPU sqrt is not correctly
        # rounded; a division by a scalar may become a reciprocal product)
        root = torch.sqrt((self.nu.double() / bc2).float().double()).float()
        upd = self.mu / (bc1 * (root + self.eps))
        self.flat.copy_(_fma(upd, neg_lr, self.flat))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _place(imgs, targets, dev: torch.device):
    """The batch as tensors on ``dev``."""
    def put(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dev)
    return put(imgs), [(put(t), put(m)) for t, m in targets]


def make_train_step(model: yolov5.YOLOv5, optimizer: Adam, nc: int):
    """Unsharded train step: ``step(imgs, targets) -> loss`` (imgs [B, H,
    W, 3] float in [0, 1] and the dense targets, numpy or tensors; the
    loss a 0-d tensor on the model's device, not waited for). Autograd
    through the loss, then one optimiser update of the model's
    parameters in place."""
    dev = next(model.parameters()).device

    def step(imgs, targets) -> torch.Tensor:
        x, tg = _place(imgs, targets, dev)
        optimizer.zero_grad()
        loss = yolo_loss(model(x), tg, nc)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def param_sharding_rules(model_or_state_dict, mesh: GridMesh,
                         axis: str = "mdl") -> dict[str, tuple]:
    """The layout the JAX package gives each array over the ``axis`` of
    the mesh: a tensor of two or more dims whose output channels (dim 0,
    OIHW; flax's last, HWIO) divide by the axis's size is split over them
    (``(axis, None, ...)``), any other is replicated (``()``)."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    size = mesh.shape[axis]
    return {k: ((axis,) + (None,) * (v.ndim - 1)
                if v.ndim >= 2 and v.shape[0] % size == 0 else ())
            for k, v in sd.items()}


def make_sharded_train_step(model: yolov5.YOLOv5, optimizer: Adam, nc: int,
                            mesh: GridMesh, dp_axis: str = "dp",
                            mdl_axis: str = "mdl"):
    """Train step over a ``(dp, mdl)`` mesh: ``step(imgs, targets) ->
    loss`` as ``make_train_step``'s, the batch split evenly over the dp
    shards.

    The port keeps the mdl shards of each dp slice on one device (a slice
    that spans devices raises ``ValueError``): there the output-channel
    layout of ``param_sharding_rules`` is one tensor and changes no
    number. Shards that share a device are one sub-batch, so on a mesh
    whose shards all lie on one device (the CPU, one card) this is the
    unsharded step.

    Across several devices the model (on the mesh's first device) gets a
    replica on each other device. Each device group's sub-batch loss is
    taken with the whole batch's divisors (``target_norms``: the positives
    and the objectness mean over the whole batch), so the sub-batch losses
    and their gradients add up to the whole batch's; a sum of losses each
    normalised by its own shard would not. The gradients are summed on the
    model's device, the optimiser updates there and each step first
    copies the parameters to the replicas. This case has run on the CPU
    only (devices that compare unequal), never on several cards."""
    if mdl_axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {mdl_axis!r}")
    dp = mesh.along(dp_axis)
    groups = dp.groups()
    home = canonical(next(model.parameters()).device)
    if groups[0][0] != home:
        raise ValueError(f"the model lies on {home}, the mesh's first "
                         f"device is {groups[0][0]}")
    if len(groups) == 1:
        return make_train_step(model, optimizer, nc)
    replicas = [model] + [copy.deepcopy(model).to(dev)
                          for dev, _, _ in groups[1:]]
    params = [p for p in model.parameters() if p.requires_grad]

    def step(imgs, targets) -> torch.Tensor:
        if imgs.shape[0] % dp.size:
            raise ValueError(f"batch {imgs.shape[0]} does not divide over "
                             f"{dp.size} dp shards")
        per = imgs.shape[0] // dp.size
        norms = target_norms(targets)
        optimizer.zero_grad()
        total = None
        for rep, (dev, a, e) in zip(replicas, groups):
            rep_params = [q for q in rep.parameters() if q.requires_grad]
            if rep is not model:
                with torch.no_grad():
                    for q, p in zip(rep_params, params):
                        q.copy_(p)
                        q.grad = None
            x, tg = _place(imgs[a * per:e * per],
                           [(t[a * per:e * per], m[a * per:e * per])
                            for t, m in targets], dev)
            loss = yolo_loss(rep(x), tg, nc, norms=norms)
            loss.backward()
            if rep is not model:
                for p, q in zip(params, rep_params):
                    p.grad += q.grad.to(home)
            loss = loss.detach().to(home)
            total = loss if total is None else total + loss
        optimizer.step()
        return total

    return step


# ---------------------------------------------------------------------------
# Synthetic training data + fit loop
# ---------------------------------------------------------------------------


def _draw_streak(img: np.ndarray, x1, y1, x2, y2, amp, sigma) -> None:
    """Gaussian streak -- matches the appearance of a max-stacked meteor
    from the synthetic video renderer (synth._draw_gaussian_dot trail)."""
    from ..synth import _draw_gaussian_dot
    steps = max(int(np.hypot(x2 - x1, y2 - y1)) * 2, 2)
    for k in range(steps):
        a = k / (steps - 1)
        # slight brightness falloff along the trail
        _draw_gaussian_dot(img, x1 + (x2 - x1) * a, y1 + (y2 - y1) * a,
                           amp * (1.0 - 0.3 * a), sigma)


def synth_batch(rng: np.random.Generator, batch: int,
                input_hw: tuple[int, int], nc: int):
    """Random star-field images with gaussian meteor streaks + labels
    (same renderer family as synth.generate_meteor_video, so trained
    weights transfer to stacks of the synthetic fixtures)."""
    from ..synth import _draw_gaussian_dot
    h, w = input_hw
    imgs = np.zeros((batch, h, w, 3), np.float32)
    boxes_list, labels_list = [], []
    for b in range(batch):
        img = np.full((h, w), 12.0, np.float32)
        for _ in range(rng.integers(5, 25)):
            # stars are hard negatives: include saturated ones so bright
            # dots in max-stacks don't read as meteors
            _draw_gaussian_dot(img, rng.uniform(0, w), rng.uniform(0, h),
                               rng.uniform(25, 250), rng.uniform(0.7, 1.8))
        boxes, labels = [], []
        for _ in range(rng.integers(0, 3)):
            length = rng.uniform(15, 110)
            ang = rng.uniform(0, 2 * np.pi)
            x1 = rng.uniform(5, w - 5)
            y1 = rng.uniform(5, h - 5)
            x2 = np.clip(x1 + length * np.cos(ang), 0, w - 1)
            y2 = np.clip(y1 + length * np.sin(ang), 0, h - 1)
            if max(abs(x2 - x1), abs(y2 - y1)) < 10:
                continue
            _draw_streak(img, x1, y1, x2, y2, rng.uniform(120, 240),
                         rng.uniform(1.0, 2.2))
            boxes.append([min(x1, x2), min(y1, y2), max(x1, x2),
                          max(y1, y2)])
            labels.append(0)  # METEOR
        # half the batch simulates a max-stack: noise floor is the max of
        # several per-frame noise draws (brighter, positively skewed)
        if rng.random() < 0.5:
            img = img + rng.normal(0, rng.uniform(2, 5),
                                   (4, h, w)).max(axis=0)
        else:
            img = img + rng.normal(0, rng.uniform(2, 5), (h, w))
        # quantize like the deployed uint8 pipeline; occasionally blur to
        # mimic codec smoothing of the noise texture
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        if rng.random() < 0.3:
            import cv2
            u8 = cv2.GaussianBlur(u8, (3, 3), 0.6)
        imgs[b] = np.repeat(u8[..., None], 3, axis=-1) / 255.0
        boxes_list.append(np.asarray(boxes, np.float32).reshape(-1, 4))
        labels_list.append(np.asarray(labels, np.int32))
    targets = build_dense_targets(boxes_list, labels_list, input_hw, nc)
    return imgs, targets


def fit_synthetic(steps: int = 200, batch: int = 8,
                  input_hw: tuple[int, int] = (320, 320), nc: int = 8,
                  lr: float = 1e-3, seed: int = 0, log_every: int = 20,
                  variables: Optional[dict] = None,
                  logger: Optional[BaseMetLog] = None, device: str = "cuda",
                  timer: Optional[StageTimer] = None) -> yolov5.YOLOv5:
    """Train YOLOv5s (bfloat16 body) on synthetic meteor scenes on
    ``device`` (``"cuda"``, the default, raises without a card); returns
    the model with its best-loss parameters (global-norm clipping +
    cosine decay guard against the predict-nothing collapse that a late
    loss spike can cause). ``variables`` (the flattened flax tree) are the
    initial weights, else ``yolov5.init_params(seed=seed)``'s. ``timer``
    receives the host seconds of each ``synth_batch`` and of each step up
    to its loss on the host."""
    dev = resolve_device(device)
    if variables is None:
        model = yolov5.init_params(nc=nc, input_hw=input_hw, seed=seed,
                                   device=dev)
    else:
        model = yolov5.YOLOv5(nc=nc)
        model.load_state_dict(params_from_flax(variables), strict=True)
        model = model.to(dev)
    optimizer = Adam(model.parameters(),
                     cosine_decay_schedule(lr, steps, alpha=0.05),
                     max_norm=5.0)
    step = make_train_step(model, optimizer, nc)
    timer = timer or StageTimer()
    rng = np.random.default_rng(seed)
    loss_ema, best_ema = None, None
    best_state = None
    for i in range(steps):
        with timer.stage("synth_batch"):
            imgs, targets = synth_batch(rng, batch, input_hw, nc)
        with timer.stage("step"):
            loss_f = float(step(imgs, targets))
        loss_ema = loss_f if loss_ema is None else (0.9 * loss_ema
                                                    + 0.1 * loss_f)
        if i >= steps // 4 and i % 25 == 0 and (best_ema is None
                                                or loss_ema < best_ema):
            best_ema = loss_ema
            # a copy: state_dict() holds the live tensors
            best_state = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
        if logger is not None and i % log_every == 0:
            logger.info(f"train step {i}: loss={loss_f:.4f} "
                        f"(ema {loss_ema:.4f})")
    if best_ema is not None and loss_ema > best_ema * 1.5:
        if logger is not None:
            logger.info(f"restoring best checkpoint (ema {best_ema:.4f} vs "
                        f"final {loss_ema:.4f})")
        model.load_state_dict(best_state)
    return model
