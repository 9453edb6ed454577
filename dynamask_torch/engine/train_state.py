"""Data parallelism (port of ``dynamask_tpu/engine/train_state.py``): the
process group of one process per device, and the one fused all-reduce of
the data-parallel train step (``jit_train_step_ddp``, :147-225).

The JAX package runs its DDP step under ``shard_map``: each device takes
its shard of the global batch, computes its losses and gradients with
local normalisation, then one ``psum`` sums a single flat vector of the
gradients, the log scalars and the BatchNorm statistics, each part
divided by the number of devices. Here each rank is a process
(``torch.distributed``: NCCL on the GPU, gloo on the CPU), and
:class:`FusedAllReduce` is that ``psum``: one ``all_reduce`` of one flat
vector between the backward pass and the optimizer
(``engine.train.make_train_step(..., group=)``). Not
``nn.parallel.DistributedDataParallel``, whose bucketed reduce averages
the gradients alone: JAX's also averages the logs and the running
statistics.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

# torchrun's variables, read by ``--launcher pytorch``
LAUNCHER_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')


def init_group(device='cuda', *, rank: int, world_size: int,
               init_method: str, local_rank: Optional[int] = None
               ) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's device: ``cuda:local_rank`` (``local_rank`` defaults
    to ``rank``) over NCCL, or the CPU over gloo. ``init_method`` is a
    ``file://`` store or torchrun's ``env://``. A group that cannot start
    raises."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('a CUDA process group needs a GPU and none is '
                               'available')
        dev = torch.device('cuda', rank if local_rank is None else
                           local_rank)
        torch.cuda.set_device(dev)
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    # NCCL builds its communicator here (device_id), so a refusal raises
    # at the start and not at the first collective
    eager = {'device_id': dev} if backend == 'nccl' else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **eager)
    return dev


def init_group_from_env(device='cuda') -> torch.device:
    """:func:`init_group` from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f'--launcher pytorch reads torchrun\'s '
                           f'environment: {", ".join(missing)} unset')
    env = os.environ
    return init_group(device, rank=int(env['RANK']),
                      world_size=int(env['WORLD_SIZE']),
                      local_rank=int(env['LOCAL_RANK']),
                      init_method='env://')


def destroy_group() -> None:
    """Leave the default process group, where one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def active_group():
    """The default process group where one is up, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


class FusedAllReduce:
    """The DDP step's collective (``jit_train_step_ddp``'s ``psum``): one
    ``all_reduce`` over ``group`` of one flat vector in the master type,
    holding the gradient of every parameter of ``params`` (zero where one
    got none, as ``DetectorSGD.step`` fills it), then the log scalars (by
    key), then every floating buffer of ``model``: the BatchNorms' running
    statistics, and Dynamic R-CNN's state, which JAX keeps among them too.
    The sum is divided by the world size and written back: the gradients
    to ``.grad``, the statistics in place; the averaged log is returned.
    At world size 1 every value comes back bit for bit. ``calls`` counts
    the all-reduces, ``nbytes`` is the last vector's size."""

    def __init__(self, model: torch.nn.Module,
                 params: List[torch.nn.Parameter], group=None):
        self.group = group
        self.params = params
        self.stats = [b for b in model.buffers() if b.is_floating_point()]
        self.calls = 0
        self.nbytes = 0

    def __call__(self, log: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        keys = sorted(log)
        flat = torch.cat([g.reshape(-1) for g in grads] +
                         [log[k].detach().reshape(-1) for k in keys] +
                         [b.reshape(-1) for b in self.stats])
        dist.all_reduce(flat, group=self.group)
        self.calls += 1
        self.nbytes = flat.numel() * flat.element_size()
        flat /= dist.get_world_size(self.group)
        parts = iter(flat.split([t.numel() for t in grads] +
                                [log[k].numel() for k in keys] +
                                [b.numel() for b in self.stats]))
        for p, g in zip(self.params, grads):
            p.grad = next(parts).view_as(g).to(g.dtype)
        out = {k: next(parts).view_as(log[k]).to(log[k].dtype)
               for k in keys}
        with torch.no_grad():
            for b in self.stats:
                b.copy_(next(parts).view_as(b))
        return out
