#!/usr/bin/env python3
"""K5, the fused windowed-DCN forward, beside K1 + GEMM on one GPU: each
instance held to its plain version, then both forms timed alternately over
several repeats at the SFM stages.

    python3 tools/ab_torch_k5.py

Imports ``dynamask_torch`` and ``chip_smoke.py`` from this checkout. Prints
the card's name and power limit and K5's tensor-core instruction counts
(``chip_smoke.check_k5_sass``), holds K5 at ``chip_smoke.K5_EDGE_SHAPES``
against its plain version, then takes ``chip_smoke.k5_cases`` (the three
SFM stages at n = 100 and 512, fp32 and bf16): holds both entry points
(``deform_conv2d_windowed_fused``, the plane rule; ``deform_conv2d_frame``,
the frame rule) to ``chip_smoke.k5_limit`` against the plain version, and
times them and K1 + ``torch.matmul`` (``ops.deform_conv.deform_conv2d``,
the main path's form) on the same inputs, each with CUDA events (20
launches after 3 warm-ups), the three in turn, ``REPEATS`` times. Per
case and form it prints the median, the least and the largest time, with
``chip_smoke.k5_bound``; writes ``chiprun_out/ab_torch_k5.json``.
"""

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPEATS = 9


def main() -> int:
    import torch
    from dynamask_torch.ops import _build, deform_conv as dc
    from dynamask_torch.ops import deform_conv_fused as dcf
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {'device': torch.cuda.get_device_name(0), 'card': cs.card_line(),
           'repeats': REPEATS, 'cases': {}}
    print(out['card'], flush=True)
    _build.build(['deform_conv_fused', 'deform_im2col'])
    out['sass'] = cs.check_k5_sass(_build.library_path('deform_conv_fused'))
    report = {}
    cs.check_k5_edges(report)
    out['edges'] = report['k5_edges']
    gen = torch.Generator(device='cuda').manual_seed(0)
    for case, (x, off, w), kw in cs.k5_cases(gen, 'cuda'):
        forms = {'k1_gemm': lambda: dc.deform_conv2d(x, off, w, **kw)}
        rec = {}
        for rule, fn in ((False, dcf.deform_conv2d_windowed_fused),
                         (True, dcf.deform_conv2d_frame)):
            got = fn(x, off, w, **kw)
            torch.cuda.synchronize()
            ref = dcf.deform_conv2d_fused_plain(x, off, w,
                                                round_to_input=rule, **kw)
            err, scale, finite = cs._compare(got, ref)
            limit, tol = cs.k5_limit(scale, got)
            if not (err <= limit and finite):
                raise RuntimeError(f'{fn.__name__} [{case}]: max abs err '
                                   f'{err} (limit {limit}, {tol})')
            b_ms, by = cs.bound_of(*cs.k5_bound((x, off, w), kw, got,
                                                round_to_input=rule))
            rec[fn.__name__] = {'max_abs_err': err, 'tol': limit,
                                'bound_ms': b_ms, 'bound_by': by}
            forms[fn.__name__] = (lambda fn=fn: fn(x, off, w, **kw))
            del got, ref
        times = {name: [] for name in forms}
        for _ in range(REPEATS):
            for name, call in forms.items():
                times[name].append(cs.cuda_ms(call))
        for name, ts in times.items():
            r = rec.setdefault(name, {})
            r.update(median_ms=statistics.median(ts), min_ms=min(ts),
                     max_ms=max(ts), ms=ts)
            share = (f', bound {r["bound_ms"]:.4f} ({r["bound_by"]}, '
                     f'{100 * r["bound_ms"] / r["median_ms"]:.1f}% of the '
                     f'median), err {r["max_abs_err"]:.3e} (tol '
                     f'{r["tol"]:.3e})' if 'bound_ms' in r else '')
            print(f'  {name} [{case}]: median {r["median_ms"]:.4f} ms, '
                  f'{r["min_ms"]:.4f}-{r["max_ms"]:.4f} over {len(ts)}'
                  + share, flush=True)
        out['cases'][case] = rec
        del x, off, w, forms
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'ab_torch_k5.json'),
              'w') as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
