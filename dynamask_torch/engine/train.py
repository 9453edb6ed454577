"""One training step (port of ``make_train_step``,
``dynamask_tpu/engine/train_state.py:45-80``): ``forward_train``, the sum of
the losses, the backward pass and the optimizer update. Each part is a
``record_function`` range (``forward_train``, ``backward``, ``optimizer``),
so a profiler trace of a step splits its time."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from ..models.detectors import parse_losses
from .optimizer import DetectorSGD


def make_train_step(model: torch.nn.Module,
                    optimizer: DetectorSGD) -> Callable:
    """Returns ``step(batch, noise=None, generator=None) -> log``: the
    losses (detached), the total ``loss`` and the pre-clip ``grad_norm``.
    The model should be in training mode."""

    def train_step(batch: Dict[str, torch.Tensor],
                   noise: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None) -> Dict:
        optimizer.zero_grad()
        with record_function('forward_train'):
            total, log = parse_losses(model.forward_train(batch, noise,
                                                          generator))
        with record_function('backward'):
            total.backward()
        with record_function('optimizer'):
            log['grad_norm'] = optimizer.step()
        return {k: v.detach() for k, v in log.items()}

    return train_step
