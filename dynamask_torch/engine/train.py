"""One training step (port of ``make_train_step``,
``dynamask_tpu/engine/train_state.py:45-80``, and of its data-parallel form
``jit_train_step_ddp``, :147-225): ``forward_train``, the sum of the
losses, the backward pass, on a process group the one fused all-reduce,
and the optimizer update. Each part is a ``record_function`` range
(``forward_train``, ``backward``, ``all_reduce``, ``optimizer``), so a
profiler trace of a step splits its time."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call
from torch.profiler import record_function

from ..core.fp16 import cast_floating
from ..models.detectors import parse_losses
from .optimizer import DetectorSGD
from .train_state import FusedAllReduce


class _ForwardTrain(torch.nn.Module):
    """``forward_train`` of ``model`` as a module's forward, for
    ``functional_call`` (its parameters under ``model.``)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, noise, generator):
        return self.model.forward_train(batch, noise, generator)


def make_train_step(model: torch.nn.Module, optimizer: DetectorSGD,
                    compute_dtype: Optional[torch.dtype] = None,
                    group=None) -> Callable:
    """Returns ``step(batch, noise=None, generator=None) -> log``: the
    losses (detached), the total ``loss`` and the pre-clip ``grad_norm``.
    The model should be in training mode.

    With ``group`` (a process group, ``torch.distributed.group.WORLD`` for
    the default one) the step is the data-parallel one of
    ``jit_train_step_ddp``: this rank's ``forward_train`` on its own batch
    with local normalisation (BatchNorms on this rank's batch statistics,
    not SyncBN), the backward, then one all-reduce of the fp32 master
    gradients, the log scalars and the running statistics, averaged
    (``engine.train_state.FusedAllReduce``, ``step.reduce``: its ``calls``
    and ``nbytes``), then the clip and SGD on the averaged gradients, whose
    norm is ``grad_norm``. At world size 1 it is the step without a group,
    bit for bit.

    ``compute_dtype=torch.bfloat16`` runs the forward and the backward in
    bf16 with fp32 master weights, as the JAX step does
    (``dynamask_tpu/engine/train_state.py:46-74``): each floating parameter
    is cast inside the differentiated function (``functional_call``), so
    its gradient lands on the fp32 master; the image is cast; the total
    loss is taken in fp32; the BatchNorm running statistics stay fp32;
    ``grad_norm``, the clip and SGD run on the fp32 gradients. Not
    ``torch.autocast``, which would keep BatchNorm, softmax and others in
    fp32 and compute another function than JAX's."""
    wrapped = _ForwardTrain(model)
    reduce = (None if group is None else
              FusedAllReduce(model, optimizer.params, group))

    def forward_train(batch, noise, generator):
        if compute_dtype is None:
            return model.forward_train(batch, noise, generator)
        params = cast_floating({'model.' + k: p for k, p in
                                model.named_parameters()}, compute_dtype)
        batch = dict(batch, image=batch['image'].to(compute_dtype))
        return functional_call(wrapped, params, (batch, noise, generator))

    def train_step(batch: Dict[str, torch.Tensor],
                   noise: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None) -> Dict:
        optimizer.zero_grad()
        with record_function('forward_train'):
            total, log = parse_losses(forward_train(batch, noise, generator))
            log['loss'] = total = total.float()
        with record_function('backward'):
            total.backward()
        if reduce is not None:
            with record_function('all_reduce'):
                log = reduce(log)
        with record_function('optimizer'):
            log['grad_norm'] = optimizer.step()
        return {k: v.detach() for k, v in log.items()}

    train_step.reduce = reduce
    return train_step
