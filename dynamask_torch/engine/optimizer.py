"""The training recipe's optimizer and LR schedule (port of
``dynamask_tpu/engine/optimizer.py``: ``step_lr_schedule`` :23-43 and
``build_optimizer`` :64-107).

The JAX chain is clip_by_global_norm -> optional MSM gradient scale ->
weight decay -> momentum -> -lr, with the frozen backbone stages set to zero
(``set_to_zero``: no update, no weight decay). Here the frozen parameters do
not require a gradient and are left out; the clip runs over the trainable
gradients, then ``torch.optim.SGD`` applies weight decay and momentum in the
JAX order (v = μ·v + g + wd·p; p -= lr·v). A trainable parameter that got no
gradient still decays, as its zero gradient does in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: Sequence[int] = (8, 11),
                     gamma: float = 0.1, warmup_iters: int = 500,
                     warmup_ratio: float = 0.001) -> Callable[[int], float]:
    """mmcv's step policy with linear warmup:
    warmup lr = base * (1 - (1 - it / warmup_iters) * (1 - ratio))."""
    boundaries = [e * steps_per_epoch for e in decay_epochs]

    def schedule(step: int) -> float:
        lr = base_lr * gamma ** sum(step >= b for b in boundaries)
        if warmup_iters > 0 and step < warmup_iters:
            frac = min(max(step / warmup_iters, 0.0), 1.0)
            lr *= 1.0 - (1.0 - frac) * (1.0 - warmup_ratio)
        return lr

    return schedule


class DetectorSGD:
    """Global-norm clip, optional MSM gradient scale, then SGD with weight
    decay and momentum at the schedule's lr. ``step()`` returns the global
    norm of the gradients before the clip."""

    def __init__(self, model: torch.nn.Module, base_lr: float = 0.02,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 grad_clip_norm: Optional[float] = 35.0,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 msm_grad_scale: Optional[float] = None):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.msm = ([p for p in model.roi_head.mask_predictor.parameters()
                     if p.requires_grad] if msm_grad_scale else [])
        self.msm_grad_scale = msm_grad_scale
        self.grad_clip_norm = grad_clip_norm
        self.lr_schedule = lr_schedule or (lambda step: base_lr)
        self.sgd = torch.optim.SGD(self.params, lr=base_lr,
                                   momentum=momentum,
                                   weight_decay=weight_decay)
        self.steps = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if self.grad_clip_norm:
            # optax: g unchanged below the limit, else g / norm * limit
            scale = torch.where(norm < self.grad_clip_norm,
                                torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        if self.msm:
            torch._foreach_mul_([p.grad for p in self.msm],
                                self.msm_grad_scale)
        for group in self.sgd.param_groups:
            group['lr'] = self.lr_schedule(self.steps)
        self.sgd.step()
        self.steps += 1
        return norm

    def state_dict(self) -> dict:
        """The step count and the SGD state (momentum buffers, the
        groups' hyperparameters): what a resumed run needs to continue the
        schedule and the momentum exactly, as the optax state and
        ``TrainState.step`` do in the JAX package."""
        return {'steps': self.steps, 'sgd': self.sgd.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`; buffers move to the parameters'
        device."""
        self.steps = int(state['steps'])
        self.sgd.load_state_dict(state['sgd'])


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict,
                    optimizer_config: Optional[dict] = None,
                    lr_config: Optional[dict] = None, *,
                    steps_per_epoch: int) -> DetectorSGD:
    """From the config's ``optimizer``, ``optimizer_config`` and
    ``lr_config`` sections, as ``dynamask_tpu/apis/train.py:134-150``; the
    schedule's epochs are ``steps_per_epoch`` optimizer steps long."""
    optimizer_config = optimizer_config or {}
    lr_config = lr_config or {}
    schedule = step_lr_schedule(
        optimizer_cfg['lr'], steps_per_epoch,
        decay_epochs=lr_config.get('step', (8, 11)),
        warmup_iters=lr_config.get('warmup_iters', 500),
        warmup_ratio=lr_config.get('warmup_ratio', 0.001))
    return DetectorSGD(
        model, base_lr=optimizer_cfg['lr'],
        momentum=optimizer_cfg.get('momentum', 0.9),
        weight_decay=optimizer_cfg.get('weight_decay', 0.0),
        grad_clip_norm=(optimizer_config.get('grad_clip') or {}).get(
            'max_norm'),
        lr_schedule=schedule,
        msm_grad_scale=optimizer_config.get('msm_grad_scale'))
