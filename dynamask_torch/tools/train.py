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
``--devices`` above 1 and a ``--launcher`` other than ``none`` are not
ported: each exits 2, naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

DDP = ('multi-device training (DDP) is not ported: ROADMAP.md §1, '
       'item 11')


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
    p.add_argument('--devices', type=int, default=1, help=DDP)
    p.add_argument('--launcher', default='none',
                   choices=['none', 'pytorch', 'slurm', 'mpi'], help=DDP)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.devices > 1 or args.launcher != 'none':
        print(f'error: {DDP}', file=sys.stderr)
        return 2
    from ..apis import set_random_seed, train_detector
    from ..utils.config import Config
    from ..utils.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f'error: {e}', file=sys.stderr)
        return 1
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
    return 0


if __name__ == '__main__':
    sys.exit(main())
