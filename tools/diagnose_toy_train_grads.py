#!/usr/bin/env python3
"""Where the GPU's gradients of the toy training step part from the CPU's.

    python3 tools/diagnose_toy_train_grads.py

Takes ``chip_smoke.py``'s toy training step (phase 3: a small DynaMask
model, 2 images at 128x128, the same weights, draws and proposals on both
devices) and reports, with TF32 off for matmuls:

1. the chain: every conv and BatchNorm of the backbone and the FPN, in
   backward order, with the rel-L2 distance GPU (with cuDNN at its
   defaults, and without cuDNN) vs CPU of its output, of the gradients at
   its output and at its input and of its weight gradient, and for a
   BatchNorm the elements whose sign differs (a ReLU follows), so the first
   module whose backward parts from the CPU stands out;
2. each conv alone: its weight and input gradients computed on the GPU from
   the CPU run's own fp32 input and output gradient, under several cuDNN
   settings, as rel-L2 against a float64 CPU reference, beside the CPU's
   fp32 error on the same inputs (the error one layer's algorithm adds);
3. the whole step under each setting: the worst per-parameter gradient
   rel-L2 against the CPU.

Writes ``chiprun_out/diagnose_toy_train_grads.json``.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# cudnn (enabled, benchmark, deterministic, allow_tf32)
SETTINGS = {
    'cudnn': (True, False, False, False),
    'cudnn_benchmark': (True, True, False, False),
    'cudnn_deterministic': (True, False, True, False),
    'cudnn_tf32': (True, False, False, True),
    'no_cudnn': (False, False, False, False),
}


def _apply(setting):
    import torch
    c = torch.backends.cudnn
    c.enabled, c.benchmark, c.deterministic, c.allow_tf32 = setting


def _rel_l2(a, ref):
    a, ref = a.detach().cpu().double(), ref.detach().cpu().double()
    n = ref.norm().item()
    return (a - ref).norm().item() / n if n > 0 else float('nan')


def _hooked_step(net, data, noise, proposals, toy_train_step):
    """One toy step with, for every conv and BatchNorm call, its input and
    output and the gradients at both kept: {name: [record per call]}, plus
    the step's results."""
    import torch
    kept, handles = {}, []

    def fwd(name):
        def hook(mod, inp, out):
            rec = {'x': inp[0].detach().cpu().clone(),
                   'y': out.detach().cpu().clone()}
            kept.setdefault(name, []).append(rec)
            for key, t in (('gin', inp[0]), ('gout', out)):
                if t.requires_grad:
                    t.register_hook(lambda g, key=key: rec.__setitem__(
                        key, g.detach().cpu()))
        return hook

    for name, m in net.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d)):
            handles.append(m.register_forward_hook(fwd(name)))
    try:
        result = toy_train_step(net, data, noise, proposals)
    finally:
        for h in handles:
            h.remove()
    return kept, result


def _chain(gpu_kept, cpu_kept, gpu_grads, cpu_grads):
    """Per conv / BatchNorm call with a gradient, in backward order: rel-L2
    GPU vs CPU of its output, of the gradients at its output and input and
    of its weight gradient; for a BatchNorm also the elements whose sign
    differs between the devices (a ReLU follows) and the exact zeros of
    its output on the CPU."""
    rows = []
    for name, calls in cpu_kept.items():
        for i, rec in enumerate(calls):
            if 'gout' not in rec:
                continue
            g = gpu_kept[name][i]
            wkey = name + '.weight'
            row = dict(module=name, call=i, shape=list(rec['x'].shape),
                       y=_rel_l2(g['y'], rec['y']),
                       gout=_rel_l2(g['gout'], rec['gout']),
                       gin=(_rel_l2(g['gin'], rec['gin']) if 'gin' in rec
                            else None),
                       wgrad=(_rel_l2(gpu_grads[wkey], cpu_grads[wkey])
                              if wkey in cpu_grads and cpu_grads[wkey].any()
                              else None))
            if 'bn' in name or 'downsample.1' in name:
                row['sign_flips'] = int(((g['y'] > 0) != (rec['y'] > 0))
                                        .sum())
                row['cpu_exact_zeros'] = int((rec['y'] == 0).sum())
                row['gpu_exact_zeros'] = int((g['y'] == 0).sum())
            rows.append(row)
    return rows[::-1]


def _fmt(v):
    return '-' if v is None else f'{v:.1e}'


def _conv_grads(conv, x, gout, device, dtype, nchw=False):
    """(d_x, d_w) of ``conv`` at input ``x`` for output gradient ``gout``."""
    import torch
    import torch.nn.functional as F
    w = conv.weight.detach()
    x, gout, w = (t.to(device, dtype) for t in (x, gout, w))
    if nchw:
        x, gout, w = (t.contiguous() for t in (x, gout, w))
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = F.conv2d(x, w, None, conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return torch.autograd.grad(y, (x, w), gout)


def main():
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        sys.exit('diagnose_toy_train_grads: needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f'[{card}] torch {torch.__version__}, cuDNN '
          f'{torch.backends.cudnn.version()}')
    ref, model, batch, _, noise = chip_smoke.toy_train_case()
    step = chip_smoke.toy_train_step
    report = {'card': card, 'torch': torch.__version__,
              'cudnn': torch.backends.cudnn.version()}

    # 1. the chain, GPU with and without cuDNN against the CPU
    _apply(SETTINGS['cudnn'])
    gpu_kept, (_, gpu_grads, props) = _hooked_step(model, batch, noise, None,
                                                   step)
    cpu_kept, (_, cpu_grads, _) = _hooked_step(ref, batch, noise, props, step)
    _apply(SETTINGS['no_cudnn'])
    nocudnn_kept, (_, nocudnn_grads, _) = _hooked_step(model, batch, noise,
                                                       props, step)
    convs = dict(ref.named_modules())
    report['chain'] = {
        'cudnn': _chain(gpu_kept, cpu_kept, gpu_grads, cpu_grads),
        'no_cudnn': _chain(nocudnn_kept, cpu_kept, nocudnn_grads, cpu_grads)}
    for v, rows in report['chain'].items():
        print(f'1. chain, backward order, GPU ({v}) vs CPU rel-L2: output, '
              'grad at output, grad at input, weight grad [sign flips, '
              'exact zeros CPU/GPU]')
        for r in rows:
            if r['module'].startswith(('backbone', 'neck')):
                extra = (f' [{r["sign_flips"]}, {r["cpu_exact_zeros"]}/'
                         f'{r["gpu_exact_zeros"]}]' if 'sign_flips' in r
                         else '')
                print(f'  {r["module"]}#{r["call"]} {r["shape"]}: '
                      f'{_fmt(r["y"])}, {_fmt(r["gout"])}, {_fmt(r["gin"])}, '
                      f'{_fmt(r["wgrad"])}{extra}')

    # 2. each conv alone, from the CPU run's own fp32 inputs
    variants = dict(SETTINGS, cudnn_nchw=SETTINGS['cudnn'])
    alone = []
    for name, calls in cpu_kept.items():
        rec = calls[0]
        conv = convs[name]
        if 'gout' not in rec or not isinstance(conv, torch.nn.Conv2d):
            continue
        dx64, dw64 = _conv_grads(conv, rec['x'], rec['gout'], 'cpu',
                                 torch.float64)
        dx32, dw32 = _conv_grads(conv, rec['x'], rec['gout'], 'cpu',
                                 torch.float32)
        row = dict(conv=name, shape=list(rec['x'].shape),
                   out_channels=conv.out_channels,
                   kernel=list(conv.kernel_size), stride=list(conv.stride),
                   cpu_fp32=(_rel_l2(dx32, dx64), _rel_l2(dw32, dw64)))
        for v, setting in variants.items():
            _apply(setting)
            dx, dw = _conv_grads(conv, rec['x'], rec['gout'], 'cuda',
                                 torch.float32, nchw=v.endswith('nchw'))
            torch.cuda.synchronize()
            row[v] = (_rel_l2(dx, dx64), _rel_l2(dw, dw64))
        alone.append(row)
    _apply(SETTINGS['cudnn'])
    report['alone'] = alone
    names = ['cpu_fp32'] + list(variants)
    print('2. each conv alone vs float64 (rel-L2 of d_x / d_w): ' +
          ', '.join(names))
    for r in sorted(alone, key=lambda r: -max(r['cudnn'])):
        print(f'  {r["conv"]} {r["shape"]}->{r["out_channels"]} k'
              f'{r["kernel"][0]} s{r["stride"][0]}: ' + ', '.join(
                  f'{r[v][0]:.1e}/{r[v][1]:.1e}' for v in names))

    # 3. the whole step under each setting
    whole = {}
    for v, setting in SETTINGS.items():
        _apply(setting)
        _, grads, _ = step(model, batch, noise, props)
        rows = sorted(((_rel_l2(grads[k], g), k) for k, g in cpu_grads.items()
                       if g.any()), reverse=True)
        whole[v] = [dict(param=k, rel_l2=d) for d, k in rows[:5]]
        print(f'3. whole step, {v}: worst gradient rel-L2 ' + ', '.join(
            f'{k} {d:.2e}' for d, k in rows[:3]))
    _apply(SETTINGS['cudnn'])
    report['whole_step'] = whole
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out',
                           'diagnose_toy_train_grads.json'), 'w') as f:
        json.dump(report, f, indent=1)


if __name__ == '__main__':
    main()
