"""Evaluation CLI of the port:

    python -m dynamask_torch.tools.test <config> [checkpoint] --eval bbox segm

The flags of the JAX package's ``test.py``: the config's test set through
the test loop on one device (``--device``, default ``cuda``), its
dataset's metrics (COCO's ``bbox``, ``segm``, ``proposal`` and
``proposal_fast``, VOC's ``mAP`` and ``recall``), the results as json
(``--out r.json``, ``--format-only``) or, for ``--out r.pkl``, pickled: an
RPN's then as the ``proposal_file`` a Fast R-CNN config reads, and
rendered detections (``--show-dir``; ``--show`` renders only with it).
``--fuse-conv-bn`` folds the conv+BN pairs before the loop
(``engine.fuse_conv_bn``) and prints their count. ``--tta`` runs the
test-time augmentation loop (``apis.aug_device_test``): each scale of
``--tta-scales`` (flat h w pairs; without them the config's own), unflipped
and flipped; a detector the JAX package cannot augment exits non-zero,
naming why. A checkpoint is a port or mmdet ``state_dict`` file; without
one the weights are random from seed 0. ``--devices`` above 1 is not
ported: it exits non-zero, naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import List, Optional

# flags of the JAX CLI the port has not got, and where they are queued
NOT_PORTED = {
    'devices': 'multi-device eval (multi_device_test) is not ported: '
               'ROADMAP.md §1, item 11',
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Test a detector (PyTorch port)')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='state_dict file (omit for random weights)')
    p.add_argument('--eval', nargs='+', default=['bbox'],
                   choices=['bbox', 'segm', 'proposal', 'proposal_fast',
                            'mAP', 'recall'])
    p.add_argument('--out', help='write the results here: json, or a '
                   'pickle for a .pkl path (an RPN\'s: its proposal_file)')
    p.add_argument('--format-only', action='store_true',
                   help='write the results json without evaluating')
    p.add_argument('--show', action='store_true',
                   help='render detections (headless: needs --show-dir)')
    p.add_argument('--show-dir',
                   help='directory to save rendered detection images')
    p.add_argument('--show-score-thr', type=float, default=0.3)
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--classwise', action='store_true',
                   help='print the per-category AP table')
    p.add_argument('--options', nargs='+', default=[],
                   help='config overrides, key=value')
    p.add_argument('--device', default=None,
                   help='torch device (default cuda; cpu runs the plain '
                        'PyTorch versions of the kernels)')
    p.add_argument('--tta', action='store_true',
                   help='test-time augmentation: each scale unflipped and '
                        'flipped, merged by the detector\'s aug_test')
    p.add_argument('--tta-scales', type=int, nargs='+', default=None,
                   help='the TTA scales as flat h w pairs, e.g. '
                        '--tta-scales 800 1333 1000 1333')
    p.add_argument('--fuse-conv-bn', action='store_true',
                   help='fold the BatchNorms into their convs before the '
                        'test loop')
    p.add_argument('--devices', type=int, default=1,
                   help=NOT_PORTED['devices'])
    args = p.parse_args(argv)
    if args.tta_scales and len(args.tta_scales) % 2:
        p.error('--tta-scales wants h w pairs')
    return args


def render_results(out_dir: str, dataset, results, classes,
                   score_thr: float) -> None:
    """Draw each image's valid dets and masks into ``out_dir``."""
    import cv2
    import numpy as np
    from ..apis.inference import show_result
    os.makedirs(out_dir, exist_ok=True)
    by_id = {dataset.sample_id(i): info
             for i, info in enumerate(dataset.img_infos)}
    for res in results:
        info = by_id[res['img_id']]
        path = os.path.join(dataset.img_prefix, info['file_name'])
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        bbox = [[] for _ in classes]
        segm = [[] for _ in classes] if 'masks' in res else None
        for d in np.nonzero(res['valid'])[0]:
            cls = int(res['labels'][d])
            bbox[cls].append(res['dets'][d])
            if segm is not None:
                segm[cls].append(res['masks'][d])
        bbox = [np.stack(b) if b else np.zeros((0, 5)) for b in bbox]
        show_result(img, (bbox, segm), classes, score_thr=score_thr,
                    out_file=os.path.join(out_dir,
                                          os.path.basename(path)))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.devices > 1:
        print(f'error: {NOT_PORTED["devices"]}', file=sys.stderr)
        return 2
    from ..apis import run_test
    from ..apis.test import proposal_lists
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.options))
    scales = args.tta_scales and [tuple(args.tta_scales[i:i + 2]) for i in
                                  range(0, len(args.tta_scales), 2)]
    try:
        dataset, results = run_test(cfg, args.checkpoint, args.max_images,
                                    args.device, args.fuse_conv_bn, args.tta,
                                    scales)
    except NotImplementedError as e:
        print(f'error: {e}', file=sys.stderr)
        return 2
    if args.out and args.out.endswith('.pkl'):
        with open(args.out, 'wb') as f:
            pickle.dump(proposal_lists(results) if 'proposals' in results[0]
                        else results, f)
        print(f'results written to {args.out}')
    elif args.out or args.format_only:
        det_json, segm_json = dataset.results2json(results)
        out_path = args.out or 'results.json'
        with open(out_path, 'w') as f:
            json.dump({'bbox': det_json, 'segm': segm_json}, f)
        print(f'results written to {out_path}')
    if args.show_dir:
        render_results(args.show_dir, dataset, results, dataset.CLASSES,
                       args.show_score_thr)
    elif args.show:
        print('warning: headless environment, --show requires --show-dir; '
              'skipping display', file=sys.stderr)
    if args.format_only:
        return 0
    metrics = dataset.evaluate(results, metric=args.eval,
                               classwise=args.classwise)
    for k, v in metrics.items():
        print(f'{k}: {v:.4f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
