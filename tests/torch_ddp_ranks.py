"""Rank bodies for ``tests/test_torch_port_ddp.py``: each runs in a spawned
process joined to its peers over gloo with a file store, imports torch and
the port only (no JAX), computes at one thread, and saves what the test
reads to ``<out>/rank<r>.pkl``."""

import os
import pickle

import numpy as np
import torch


def run_ranks(fn, world, out, *args, timeout=300.0):
    """Spawn ``world`` ranks of ``fn(rank, world, init_method, out, *args)``
    (``tools.train.spawn_ranks``) and return each rank's pickle; a rank
    that fails or outlasts ``timeout`` seconds fails the call (the others
    are ended)."""
    from dynamask_torch.tools.train import spawn_ranks
    rc = spawn_ranks(fn, world, (out, *args), timeout=timeout)
    assert rc == 0, f'the ranks exited {rc}'
    out_of = []
    for r in range(world):
        with open(os.path.join(out, f'rank{r}.pkl'), 'rb') as f:
            out_of.append(pickle.load(f))
    return out_of


def _join(rank, world, init):
    from dynamask_torch.engine import init_group
    torch.set_num_threads(1)
    init_group('cpu', rank=rank, world_size=world, init_method=init)


def _save(out, rank, obj):
    with open(os.path.join(out, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(obj, f)


def _model(cfgs, state):
    from dynamask_torch.models import build_detector
    model = build_detector(*cfgs, device='cpu')
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def ddp_step(rank, world, init, out, cfgs, state, batch, noise, lr):
    """One DDP step (``make_train_step(group=)``) on this rank's slice of
    ``batch``, with ``noise``'s draws -> its log, its state after the step
    and the all-reduce count."""
    from dynamask_torch.engine import (DetectorSGD, active_group,
                                       destroy_group, make_train_step,
                                       step_lr_schedule)
    _join(rank, world, init)
    try:
        model = _model(cfgs, state).train()
        opt = DetectorSGD(model, lr, 0.9, 1e-4, 35.0,
                          step_lr_schedule(lr, 10, warmup_iters=0))
        step = make_train_step(model, opt, group=active_group())
        n = len(batch['image']) // world
        local = {k: torch.from_numpy(np.ascontiguousarray(
            v[rank * n:(rank + 1) * n])) for k, v in batch.items()}
        log = step(local, {k: torch.from_numpy(v) for k, v in noise.items()})
        _save(out, rank, dict(
            log={k: v.numpy() for k, v in log.items()},
            state={k: v.numpy() for k, v in model.state_dict().items()},
            calls=step.reduce.calls, nbytes=step.reduce.nbytes))
    finally:
        destroy_group()


def multi_test(rank, world, init, out, cfgs, state, data_cfg,
               samples_per_device=1, single=True):
    """``multi_device_test`` over the ranks, ``samples_per_device`` images a
    rank a batch, and, with ``single``, on rank 0 in the same process
    ``single_device_test`` on the same model and set."""
    from dynamask_torch.apis import multi_device_test, single_device_test
    from dynamask_torch.data import build_dataset
    from dynamask_torch.engine import destroy_group
    _join(rank, world, init)
    try:
        model = _model(cfgs, state)
        dataset = build_dataset(data_cfg, dict(test_mode=True))
        got = multi_device_test(model, dataset, samples_per_device,
                                workers_per_gpu=0)
        ref = (single_device_test(model, dataset, workers_per_gpu=0,
                                  progress=False)
               if single and rank == 0 else None)
        _save(out, rank, dict(multi=got, single=ref))
    finally:
        destroy_group()
