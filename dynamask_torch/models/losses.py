"""The losses the flagship trains with (port of the parts of
``dynamask_tpu/models/losses.py`` it uses: ``weight_reduce_loss`` :20,
``softmax_cross_entropy`` :34, ``binary_cross_entropy_with_logits`` :44,
``l1_loss`` :71, ``smooth_l1_loss`` :76-86, ``iou_loss`` :101-130,
``accuracy`` :160, ``ghm_c_loss`` :296-320, ``ghm_r_loss`` :410-432,
``bounded_iou_loss`` :456-485, GFL's ``quality_focal_loss`` :335-361
and ``distribution_focal_loss`` :398-418, Libra R-CNN's
``balanced_l1_loss`` :282-295, CornerNet's ``gaussian_focal_loss`` :322,
and the focal loss of ``dynamask_tpu/
models/single_stage.py:253-259``). Dense padded inputs with elementwise
weights and an ``avg_factor``, as in the JAX package."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       avg_factor=None) -> torch.Tensor:
    """sum(loss * weight) / avg_factor (the mean over the weights when
    ``avg_factor`` is None)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if weight is None:
            return loss.mean()
        return loss.sum() / weight.sum().clamp(min=1.0)
    if not torch.is_tensor(avg_factor):
        avg_factor = torch.tensor(float(avg_factor), device=loss.device)
    return loss.sum() / avg_factor.clamp(min=1.0)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weight=None, avg_factor=None) -> torch.Tensor:
    """CE over (N, C) logits and int labels; labels < 0 add nothing."""
    logp = F.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(labels >= 0, nll, 0.0)
    return weight_reduce_loss(nll, weight, avg_factor)


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Elementwise, in the JAX package's stable form."""
    return logits.clamp(min=0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))


def focal_elementwise(logits: torch.Tensor, onehot: torch.Tensor,
                      gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """The sigmoid focal loss of each logit against its 0/1 target (JAX
    ``_focal_elementwise``): ``a_t * (1 - p_t) ** gamma * BCE``."""
    p = torch.sigmoid(logits)
    ce = binary_cross_entropy_with_logits(logits, onehot)
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return a_t * (1 - p_t) ** gamma * ce


def _ghm_weights(g: torch.Tensor, valid: torch.Tensor, edges: torch.Tensor,
                 total: torch.Tensor) -> torch.Tensor:
    """GHM's inverse gradient-density weights: an element of ``g`` in
    ``[edges[i], edges[i + 1])`` weighs ``total / count_i``, over the
    number of non-empty bins; invalid elements weigh 0. The counts are
    exact integers (``bincount``)."""
    bins = edges.numel() - 1
    idx = (torch.bucketize(g, edges, right=True) - 1).clamp(0, bins)
    idx = torch.where(valid & (g < edges[-1]), idx, bins)
    count = torch.bincount(idx.reshape(-1), minlength=bins + 1)[:bins]
    per_bin = torch.where(count > 0, total / count.clamp(min=1).float(),
                          torch.zeros((), device=g.device))
    nonempty = (count > 0).sum().clamp(min=1).float()
    return torch.cat([per_bin, per_bin.new_zeros(1)])[idx] / nonempty


def _ghm_edges(bins: int, last: float, device) -> torch.Tensor:
    """JAX's ``jnp.linspace(0, 1, bins + 1)`` with its last edge set to
    ``last``: ``i * (1 / bins)`` in float32, as it computes them."""
    step = torch.tensor(1.0 / bins, dtype=torch.float32, device=device)
    edges = torch.arange(bins + 1, dtype=torch.float32, device=device) * step
    edges[-1] = last
    return edges


def ghm_c_loss(logits: torch.Tensor, onehot: torch.Tensor,
               label_weights: torch.Tensor, bins: int = 10) -> torch.Tensor:
    """Gradient-harmonised classification loss (mmdet ``GHMC``) in JAX's
    stateless form: the density of this batch alone, whatever the config's
    ``momentum`` (ROADMAP.md queue 3, 3ab). BCE weighted per element by
    its gradient norm's bin, over the count of weighted elements."""
    g = (torch.sigmoid(logits).detach() - onehot).abs()
    valid = label_weights > 0
    total = valid.sum().clamp(min=1).float()
    edges = _ghm_edges(bins, 1.0 + 1e-6, logits.device)
    weights = _ghm_weights(g, valid, edges, total)
    ce = binary_cross_entropy_with_logits(logits, onehot)
    return (ce * weights).sum() / total


def ghm_r_loss(pred: torch.Tensor, target: torch.Tensor,
               label_weight: torch.Tensor, mu: float = 0.02,
               bins: int = 10) -> torch.Tensor:
    """Gradient-harmonised regression loss (mmdet ``GHMR``), stateless as
    :func:`ghm_c_loss`: the authentic smooth L1 ``sqrt(d² + mu²) - mu``
    weighted by its gradient norm's bin."""
    diff = pred - target
    loss = torch.sqrt(diff * diff + mu * mu) - mu
    g = (diff / torch.sqrt(mu * mu + diff * diff)).abs().detach()
    valid = label_weight > 0
    total = label_weight.sum().clamp(min=1).float()
    edges = _ghm_edges(bins, 1e3, pred.device)
    weights = _ghm_weights(g, valid, edges, total)
    return (loss * weights).sum() / total


def quality_focal_loss(logits: torch.Tensor, onehot: torch.Tensor,
                       score: torch.Tensor, beta: float = 2.0, weight=None,
                       avg_factor=None) -> torch.Tensor:
    """GFL's Quality Focal Loss: BCE of each logit against its class's
    quality ``score`` (0 off the label's column), modulated by
    ``|target - sigmoid| ** beta``."""
    target = onehot * score[..., None]
    mod = (target - torch.sigmoid(logits)).abs() ** beta
    return weight_reduce_loss(
        binary_cross_entropy_with_logits(logits, target) * mod, weight,
        avg_factor)


def distribution_focal_loss(logits: torch.Tensor, target: torch.Tensor,
                            weight=None, avg_factor=None) -> torch.Tensor:
    """GFL's Distribution Focal Loss: the cross-entropy of the (..., bins)
    ``logits`` to the two integer bins around each continuous ``target``,
    weighted by its distance to the other."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = target - tl.to(target.dtype)
    logp = F.log_softmax(logits, -1)
    top = logits.shape[-1] - 1
    nl = -logp.gather(-1, tl.clamp(0, top)[..., None])[..., 0]
    nr = -logp.gather(-1, tr.clamp(0, top)[..., None])[..., 0]
    return weight_reduce_loss(nl * wl + nr * wr, weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None) -> torch.Tensor:
    return weight_reduce_loss((pred - target).abs(), weight, avg_factor)


def smooth_l1_elementwise(pred, target, beta: float = 1.0) -> torch.Tensor:
    """0.5·d²/beta where |d| < beta, |d| − 0.5·beta beyond."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def smooth_l1_loss(pred, target, beta: float = 1.0, weight=None,
                   avg_factor=None) -> torch.Tensor:
    return weight_reduce_loss(smooth_l1_elementwise(pred, target, beta),
                              weight, avg_factor)


def gaussian_focal_loss(pred_sigmoid: torch.Tensor,
                        gaussian_target: torch.Tensor, alpha: float = 2.0,
                        gamma: float = 4.0, weight=None,
                        avg_factor=None) -> torch.Tensor:
    """CornerNet's heatmap focal loss: the peak cells (target 1) weigh
    ``(1 - p) ** alpha``, the others ``p ** alpha (1 - t) ** gamma``;
    reduced as :func:`weight_reduce_loss` reduces (a mean without weight
    or ``avg_factor``)."""
    eps = 1e-12
    pos = (gaussian_target == 1).to(pred_sigmoid.dtype)
    neg_w = torch.pow(1 - gaussian_target, gamma)
    pos_loss = -torch.log(pred_sigmoid.clamp(min=eps)) * \
        torch.pow(1 - pred_sigmoid, alpha) * pos
    neg_loss = -torch.log((1 - pred_sigmoid).clamp(min=eps)) * \
        torch.pow(pred_sigmoid, alpha) * neg_w * (1 - pos)
    return weight_reduce_loss(pos_loss + neg_loss, weight, avg_factor)


def balanced_l1_loss(pred, target, beta: float = 1.0, alpha: float = 0.5,
                     gamma: float = 1.5, weight=None,
                     avg_factor=None) -> torch.Tensor:
    """Libra R-CNN's balanced L1 (JAX ``losses.py:282-295``): with
    ``b = e ** (gamma / alpha) - 1``, ``alpha / b * (b d + 1) log(b d / beta
    + 1) - alpha d`` where ``d = |pred - target| < beta``, ``gamma d +
    gamma / b - alpha beta`` beyond."""
    diff = (pred - target).abs()
    b = math.e ** (gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log(
            (b * diff / beta + 1).clamp(min=1e-12)) - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return weight_reduce_loss(loss, weight, avg_factor)


def iou_loss(pred, target, mode: str = 'giou', eps: float = 1e-7,
             weight=None, avg_factor=None) -> torch.Tensor:
    """The IoU family over (..., 4) xyxy boxes, one value a box: ``iou``
    1 - IoU, ``log_iou`` -log(IoU) (mmdet's ``IoULoss``), ``giou`` 1 -
    GIoU. JAX's eps, 1e-7 (mmdet's losses take 1e-6)."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0]).clamp(min=0) * \
        (pred[..., 3] - pred[..., 1]).clamp(min=0)
    at = (target[..., 2] - target[..., 0]).clamp(min=0) * \
        (target[..., 3] - target[..., 1]).clamp(min=0)
    union = ap + at - inter + eps
    iou = inter / union
    if mode == 'iou':
        loss = 1 - iou
    elif mode == 'log_iou':
        loss = -torch.log(iou.clamp(min=eps))
    elif mode == 'giou':
        e_wh = (torch.maximum(pred[..., 2:], target[..., 2:]) -
                torch.minimum(pred[..., :2], target[..., :2])).clamp(min=0)
        enclose = e_wh[..., 0] * e_wh[..., 1] + eps
        loss = 1 - (iou - (enclose - union) / enclose)
    else:
        raise NotImplementedError(f'iou_loss mode {mode!r}')
    return weight_reduce_loss(loss, weight, avg_factor)


def bounded_iou_loss(pred, target, beta: float = 0.2, eps: float = 1e-3,
                     weight=None, avg_factor=None) -> torch.Tensor:
    """Bounded IoU (mmdet ``bounded_iou_loss``): per-coordinate bounded-IoU
    terms of the centre offsets and sizes through a SmoothL1 envelope of
    ``beta``, the target taken as a constant."""
    px = (pred[..., 0] + pred[..., 2]) * 0.5
    py = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0]
    ph = pred[..., 3] - pred[..., 1]
    target = target.detach()
    tx = (target[..., 0] + target[..., 2]) * 0.5
    ty = (target[..., 1] + target[..., 3]) * 0.5
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    dx, dy = (tx - px).abs(), (ty - py).abs()
    comb = torch.stack([
        1 - ((tw - 2 * dx) / (tw + 2 * dx + eps)).clamp(min=0),
        1 - ((th - 2 * dy) / (th + 2 * dy + eps)).clamp(min=0),
        1 - torch.minimum(tw / (pw + eps), pw / (tw + eps)),
        1 - torch.minimum(th / (ph + eps), ph / (th + eps))], -1)
    loss = torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta)
    if weight is not None and weight.dim() < loss.dim():
        weight = weight[..., None]
    return weight_reduce_loss(loss, weight, avg_factor)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-1 accuracy over the valid entries."""
    correct = (logits.argmax(-1) == labels).float()
    if valid is not None:
        return (correct * valid).sum() / valid.sum().clamp(min=1.0)
    return correct.mean()
