#!/usr/bin/env python3
"""Flagship inference time of two checkouts of the port, alternated on one
GPU.

    python3 tools/ab_torch_inference.py TREE_A TREE_B

Each run is a fresh process that imports ``dynamask_torch`` from one
checkout (its kernels built into that checkout's ``build/``), builds
DynaMask R50-FPN with random N(0, 0.05) weights from seed 0 and times
``inference_detector`` on one seeded 800x1344 fp32 image with TF32 off, as
``chip_smoke.py`` phase 4 does: per mode (faithful, dynamic) 2 warm-up
calls, then 5 timed calls, each synchronised, median. Three runs per tree
go A B B A A B, so a drift of the card's clock falls on both trees alike.
Prints each run's medians and, per tree and mode, the median of the runs'
medians; writes ``chiprun_out/ab_torch_inference.json``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
PAIRS = 3
ITERS = 5


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    import dynamask_torch
    from dynamask_torch.apis import inference_detector, init_detector
    if not os.path.abspath(dynamask_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f'dynamask_torch imported from '
                           f'{dynamask_torch.__file__}, not {tree}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_detector(os.path.join(
        tree, 'configs/dynamask/coco/r50_dynamask_1x.py'), device='cuda',
        seed=0, init_std=0.05)
    gen = torch.Generator(device='cuda').manual_seed(0)
    h, w = 800, 1344
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device='cuda'),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device='cuda'),
             'scale_factor': torch.ones(1, 4, device='cuda')}
    out = {}
    for mode, dynamic in (('faithful', False), ('dynamic', True)):
        model.roi_head.dynamic_inference = dynamic
        times = []
        for i in range(2 + ITERS):
            t = time.perf_counter()
            inference_detector(model, batch)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t))
        out[mode] = dict(median_ms=statistics.median(times), times_ms=times)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('trees', nargs='*')
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print('RESULT ' + json.dumps(worker(args.worker)))
        return
    if len(args.trees) != 2:
        ap.error('give two checkouts')
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    order = []
    for i in range(PAIRS):
        order += [0, 1] if i % 2 == 0 else [1, 0]
    runs = []
    for k in order:
        res = subprocess.run([sys.executable, HERE, '--worker', trees[k]],
                             cwd=trees[k],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith('RESULT ')]
        if res.returncode != 0 or not lines:
            sys.exit(f'run in {trees[k]} failed:\n{res.stderr[-3000:]}')
        r = json.loads(lines[-1][len('RESULT '):])
        runs.append(dict(tree=args.trees[k], **r))
        print(f'{args.trees[k]}: faithful {r["faithful"]["median_ms"]:.3f}, '
              f'dynamic {r["dynamic"]["median_ms"]:.3f} ms/img [{card}]',
              flush=True)
    summary = {t: {m: statistics.median(r[m]['median_ms'] for r in runs
                                        if r['tree'] == t)
                   for m in ('faithful', 'dynamic')} for t in args.trees}
    for t, s in summary.items():
        print(f'median of runs, {t}: faithful {s["faithful"]:.3f}, dynamic '
              f'{s["dynamic"]:.3f} ms/img [{card}]')
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'ab_torch_inference.json'),
              'w') as f:
        json.dump(dict(card=card, runs=runs, summary=summary), f, indent=1)


if __name__ == '__main__':
    main()
