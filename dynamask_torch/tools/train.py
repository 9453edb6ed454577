"""Training CLI of the port:

    python -m dynamask_torch.tools.train <config> [--work-dir DIR]

The flags of the JAX package's ``train.py``: the config's recipe through
``apis.train_detector`` on one device (``--device``, default ``cuda``;
``cpu`` runs the plain PyTorch versions of the kernels), checkpoints
``epoch_N.pth`` and ``latest`` in the work dir (``--work-dir``, else the
config's ``work_dir``, else ``./work_dirs/<config name>``), ``--resume-from``
(model, optimizer, epoch), ``--load-from`` (weights only), ``--seed``,
``--no-validate``, ``--max-steps-per-epoch`` and ``--options k=v``. The
eval CLI reads a checkpoint, ``latest`` or the work dir as it is.

Data-parallel training (the JAX CLI's ``--devices`` and ``--launcher
jax``): ``--devices N`` spawns N ranks, one process each, on
``cuda:0..N-1`` over NCCL (exit 2 where fewer GPUs are visible), or with
``--device cpu`` on the CPU over gloo; ``--launcher pytorch`` is one rank
of ``torchrun``'s (``torchrun --nproc_per_node N -m
dynamask_torch.tools.train <config> --launcher pytorch``). Each rank runs
``apis.train_detector`` on its shard of each global batch of
``samples_per_gpu`` x N images; rank 0 writes the logs and checkpoints.
``--launcher slurm`` and ``mpi`` exit 2: the JAX package has no such
launcher.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import List, Optional

# the launchers of the reference CLI that the JAX package has not got
NO_LAUNCHER = ('--launcher {}: the JAX package has no such launcher (its '
               'train.py takes none or jax, whose counterpart here is '
               'pytorch)')


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Train a detector (PyTorch port)')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', help='dir to save logs and checkpoints')
    p.add_argument('--resume-from', help='checkpoint to resume from')
    p.add_argument('--load-from', help='checkpoint to load weights from')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--no-validate', action='store_true',
                   help='skip the validation after each evaluation.interval '
                        'epochs')
    p.add_argument('--max-steps-per-epoch', type=int, default=None,
                   help='truncate epochs (smoke runs); the lr schedule '
                        'counts in the truncated epochs')
    p.add_argument('--options', nargs='+', default=[],
                   help='config overrides, key=value (dotted keys)')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; cpu runs the plain '
                        'PyTorch versions of the kernels)')
    p.add_argument('--deterministic', action='store_true',
                   help='make cuDNN pick deterministic algorithms; the '
                        'kernels K3 (DCN backward) and K4 (RoIAlign '
                        'backward) still sum in L2 in a nondeterministic '
                        'order')
    p.add_argument('--devices', type=int, default=1,
                   help='data-parallel training over N spawned ranks, one '
                        'a GPU (with --device cpu, N ranks on the CPU)')
    p.add_argument('--launcher', default='none',
                   choices=['none', 'pytorch', 'slurm', 'mpi'],
                   help='pytorch: one rank of torchrun\'s, from its '
                        'environment')
    return p.parse_args(argv)


def spawn_ranks(fn, n: int, args=(), timeout: Optional[float] = None
                ) -> int:
    """Run ``fn(rank, n, init_method, *args)`` in ``n`` spawned processes
    joined over a file store -> 0, or the exit code of the first rank that
    failed (1 where it raised): the other ranks are then ended, so none
    waits for good on a collective the failed one never reaches. Where the
    ranks still run after ``timeout`` seconds, all are ended and the code
    is 124."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            fn, args=(n, 'file://' + os.path.join(tmp, 'store'), *args),
            nprocs=n, join=False, start_method='spawn')
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    print(f'error: the ranks still ran after {timeout} s',
                          file=sys.stderr)
                    return 124
        except mp.ProcessExitedException as e:
            print(f'error: rank {e.error_index} exited {e.exit_code}',
                  file=sys.stderr)
            return e.exit_code or 1
        except mp.ProcessRaisedException as e:
            print(f'error: a rank raised: {e}', file=sys.stderr)
            return 1
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(30)
                    if p.is_alive():
                        p.kill()
                        p.join()
    return 0


def check_devices(device: str, n: int) -> Optional[str]:
    """Why ``n`` ranks cannot run on ``device``, or None."""
    import torch
    if n < 1:
        return f'--devices {n}: at least one'
    if n > 1 and device.split(':')[0] == 'cuda' and \
            n > torch.cuda.device_count():
        return (f'--devices {n} asks for {n} GPUs and '
                f'torch.cuda.device_count() is '
                f'{torch.cuda.device_count()}')
    return None


def _rank(rank: int, n: int, init_method: str, run, args,
          threads: int) -> None:
    """One spawned rank of ``--devices``: ``run(args, device)`` (this
    module's :func:`train`, or the eval CLI's ``evaluate``) in the process
    group, at ``threads`` torch threads; exits with ``run``'s code."""
    import torch
    from ..engine.train_state import destroy_group, init_group
    torch.set_num_threads(threads)
    device = init_group(args.device or 'cuda', rank=rank, world_size=n,
                        init_method=init_method)
    try:
        rc = run(args, device)
    finally:
        destroy_group()
    if rc:
        sys.exit(rc)


def train(args, device) -> None:
    """``args``' config through ``apis.train_detector`` on ``device`` (in
    the process group, where one is up)."""
    from ..apis import set_random_seed, train_detector
    from ..utils.config import Config
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.options))
    work_dir = args.work_dir or cfg.get('work_dir') or os.path.join(
        './work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    if args.deterministic:
        set_random_seed(args.seed, deterministic=True)
    train_detector(cfg, work_dir=work_dir,
                   resume_from=args.resume_from or cfg.get('resume_from'),
                   load_from=args.load_from or cfg.get('load_from'),
                   seed=args.seed,
                   max_steps_per_epoch=args.max_steps_per_epoch,
                   device=device, validate=not args.no_validate)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.launcher in ('slurm', 'mpi'):
        print(f'error: {NO_LAUNCHER.format(args.launcher)}', file=sys.stderr)
        return 2
    if args.launcher == 'pytorch':
        from ..engine.train_state import destroy_group, init_group_from_env
        device = init_group_from_env(args.device)
        try:
            train(args, device)
        finally:
            destroy_group()
        return 0
    why = check_devices(args.device, args.devices)
    if why:
        print(f'error: {why}', file=sys.stderr)
        return 2
    if args.devices > 1:
        import torch
        return spawn_ranks(_rank, args.devices,
                           (train, args, torch.get_num_threads()))
    from ..utils.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f'error: {e}', file=sys.stderr)
        return 1
    train(args, device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
