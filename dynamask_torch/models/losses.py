"""The losses the flagship trains with (port of the parts of
``dynamask_tpu/models/losses.py`` it uses: ``weight_reduce_loss`` :20,
``softmax_cross_entropy`` :34, ``binary_cross_entropy_with_logits`` :44,
``l1_loss`` :71, ``smooth_l1_loss`` :76-86, ``iou_loss`` :101-130,
``accuracy`` :160, ``bounded_iou_loss`` :456-485). Dense padded inputs
with elementwise weights and an ``avg_factor``, as in the JAX package."""

from __future__ import annotations

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


def l1_loss(pred, target, weight=None, avg_factor=None) -> torch.Tensor:
    return weight_reduce_loss((pred - target).abs(), weight, avg_factor)


def smooth_l1_loss(pred, target, beta: float = 1.0, weight=None,
                   avg_factor=None) -> torch.Tensor:
    """0.5·d²/beta where |d| < beta, |d| − 0.5·beta beyond."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
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
