"""The losses the flagship trains with (port of the parts of
``dynamask_tpu/models/losses.py`` it uses: ``weight_reduce_loss`` :20,
``softmax_cross_entropy`` :34, ``binary_cross_entropy_with_logits`` :44,
``l1_loss`` :71, ``accuracy`` :160). Dense padded inputs with elementwise
weights and an ``avg_factor``, as in the JAX package."""

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


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-1 accuracy over the valid entries."""
    correct = (logits.argmax(-1) == labels).float()
    if valid is not None:
        return (correct * valid).sum() / valid.sum().clamp(min=1.0)
    return correct.mean()
