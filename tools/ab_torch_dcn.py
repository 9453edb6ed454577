#!/usr/bin/env python3
"""K1 and K3 time, and the flagship's training step, of two checkouts of the
port, alternated on one GPU.

    python3 tools/ab_torch_dcn.py TREE_A TREE_B [--no-train]

Each run is a fresh process that imports ``dynamask_torch`` from one
checkout (its kernels built into that checkout's ``build/``) and times, with
CUDA events (20 launches after 3 warm-ups), K1 ``deform_im2col_windowed`` at
the three SFM stages (14x14x256, 28x28x128, 56x56x64; 2 deform groups,
window 3) at n = 100 (inference) and n = 512 (training), and K3
``deform_col2im_windowed`` at the three stages at n = 512, on seeded inputs
drawn as ``chip_smoke.py`` phase 2 draws them (offsets up to ±5 px). Unless
``--no-train``, it then times the flagship's training step as
``chip_smoke.py`` phase 5 does: ``train_detector`` on a seeded synthetic
batch of 4 images at 800x1344 with 20 GTs each, fp32 with TF32 off, one
warm-up and 3 timed steps, median. Runs go A B B A, so a drift of the card's
clock falls on both trees alike. Prints each run and, per tree, the mean of
its runs; writes ``chiprun_out/ab_torch_dcn.json``.
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
STAGES = ((14, 256), (28, 128), (56, 64))
ORDER = (0, 1, 1, 0)


def _cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def worker(tree: str, train: bool) -> dict:
    sys.path.insert(0, tree)
    import torch
    import dynamask_torch
    from dynamask_torch.ops import deform_conv as dc
    if not os.path.abspath(dynamask_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f'dynamask_torch imported from '
                           f'{dynamask_torch.__file__}, not {tree}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(kernel_size=3, padding=1, dilation=1, deform_groups=2,
              window=3)
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = {'k1': {}, 'k3': {}}
    for n in (100, 512):
        for s, c in STAGES:
            x = torch.randn(n, s, s, c, generator=gen, device='cuda')
            off = (torch.rand(n, s, s, 36, generator=gen, device='cuda') -
                   0.5) * 10
            case = f'{n}x{s}x{s}x{c}'
            out['k1'][case] = _cuda_ms(
                lambda: dc.deform_im2col_windowed(x, off, **kw))
            if n == 512:
                d_col = torch.randn(n, s, s, 2, 9, c // 2, generator=gen,
                                    device='cuda')
                out['k3'][case] = _cuda_ms(
                    lambda: dc.deform_col2im_windowed(x, off, d_col, **kw))
                del d_col
            del x, off
            torch.cuda.empty_cache()
    if train:
        from dynamask_torch.apis import (init_trainer, synthetic_batch,
                                         train_detector)
        model, opt = init_trainer(
            os.path.join(tree, 'configs/dynamask/coco/r50_dynamask_1x.py'),
            steps_per_epoch=117266 // 4, device='cuda', seed=0)
        batch = synthetic_batch(0, b=4, h=800, w=1344, num_gts=20,
                                crop_size=128,
                                num_classes=model.roi_head.num_classes,
                                device='cpu')
        tgen = torch.Generator(device='cuda').manual_seed(0)
        times = []
        for _ in range(4):
            t = time.perf_counter()
            train_detector(model, opt, [batch], generator=tgen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        out['train'] = dict(ms_per_step=statistics.median(times[1:]),
                            times_ms=times)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('trees', nargs='*')
    ap.add_argument('--no-train', action='store_true',
                    help='time the kernels only')
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print('RESULT ' + json.dumps(worker(args.worker, not args.no_train)))
        return
    if len(args.trees) != 2:
        ap.error('give two checkouts')
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = []
    for k in ORDER:
        cmd = [sys.executable, HERE, '--worker', trees[k]]
        if args.no_train:
            cmd.append('--no-train')
        res = subprocess.run(cmd, cwd=trees[k], capture_output=True,
                             text=True, timeout=1200)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith('RESULT ')]
        if res.returncode != 0 or not lines:
            sys.exit(f'run in {trees[k]} failed:\n{res.stderr[-3000:]}')
        r = json.loads(lines[-1][len('RESULT '):])
        runs.append(dict(tree=args.trees[k], **r))
        line = ', '.join(f'{kern.upper()} {case} {ms:.4f}'
                         for kern in ('k1', 'k3')
                         for case, ms in r[kern].items())
        if 'train' in r:
            line += f'; train {r["train"]["ms_per_step"]:.1f} ms/step'
        print(f'{args.trees[k]}: {line} [{card}]', flush=True)
    summary = {}
    for t in args.trees:
        mine = [r for r in runs if r['tree'] == t]
        s = {kern: {case: statistics.mean(r[kern][case] for r in mine)
                    for case in mine[0][kern]} for kern in ('k1', 'k3')}
        s['k1_infer_ms'] = sum(v for c, v in s['k1'].items()
                               if c.startswith('100x'))
        s['k1_train_ms'] = sum(v for c, v in s['k1'].items()
                               if c.startswith('512x'))
        s['k3_train_ms'] = sum(s['k3'].values())
        if 'train' in mine[0]:
            s['train_ms_per_step'] = statistics.mean(
                r['train']['ms_per_step'] for r in mine)
        summary[t] = s
        print(f'mean of runs, {t}: K1 n=100 {s["k1_infer_ms"]:.4f} ms, '
              f'K1 n=512 {s["k1_train_ms"]:.4f} ms, K3 n=512 '
              f'{s["k3_train_ms"]:.4f} ms' + (
                  f', train {s["train_ms_per_step"]:.1f} ms/step'
                  if 'train_ms_per_step' in s else '') + f' [{card}]')
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'ab_torch_dcn.json'),
              'w') as f:
        json.dump(dict(card=card, runs=runs, summary=summary), f, indent=1)


if __name__ == '__main__':
    main()
