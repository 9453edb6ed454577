"""Fold the BatchNorms of a checkpoint into their convs:

    python -m dynamask_torch.tools.fuse_conv_bn <config> <checkpoint> <out>

The config's detector with the checkpoint's weights (a port or mmdet
``state_dict`` file, a training checkpoint, or a training run's
directory), its conv+BN pairs folded as the JAX package's rule pairs them
(``engine.fuse_conv_bn``), saved to ``out`` as a port ``state_dict``: the
same keys, so it loads into the unfolded model and runs without
``--fuse-conv-bn``. The model is built and folded on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description='Fold conv+BN pairs')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('out')
    args = p.parse_args(argv)
    import torch
    from ..apis.inference import init_detector
    from ..engine.fuse import fuse_conv_bn
    model = init_detector(args.config, args.checkpoint, device='cpu')
    fused, n = fuse_conv_bn(model)
    print(f'fused {n} conv+bn pairs')
    torch.save({'state_dict': fused.state_dict(),
                'meta': {'fused_conv_bn': True, 'config': args.config,
                         'CLASSES': list(model.CLASSES)}}, args.out)
    print(f'written to {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
