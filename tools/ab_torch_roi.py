#!/usr/bin/env python3
"""K2 and K4 time of two checkouts of the port, alternated on one GPU; or
what K4 of this checkout spends its time on.

    python3 tools/ab_torch_roi.py TREE_A TREE_B
    python3 tools/ab_torch_roi.py --ablate

A/B: each run is a fresh process that imports ``dynamask_torch`` from one
checkout (its kernels built into that checkout's ``build/``) and times, with
CUDA events (20 calls after 3 warm-ups, the wrapper's host work included),
K2 ``roi_align_fwd`` at ``chip_smoke.py``'s inference crops, training crops
and training crops with clustered RoIs, and K4 ``roi_align_bwd`` at the
training and clustered crops, on inputs drawn by ``chip_smoke.py``'s case
functions from seed 0 (this checkout's ``chip_smoke.py``, so both trees get
the same inputs; phase 2 draws K1's cases first, so its own differ). For
each K2 crop it also keeps a checksum of the output's bits (the sum of its
int32 bit patterns), so the two trees' K2 can be told bit-identical or not.
Runs go A B B A. Prints per crop the ms of each tree (the mean of its runs)
and its share of the bound (``chip_smoke.k2_bound`` / ``k4_bound``); writes
``chiprun_out/ab_torch_roi.json``.

``--ablate``: in this checkout, K4 at the training and clustered crops: the
zero fill of d_flat alone (``torch.zeros``, part of the wrapper), the
kernel alone on a d_flat filled once, the kernel built again from its
source with parts left out (results wrong; only the times count):
``no_flush`` without its reductions into d_flat, ``one_load`` with every
d_out load from one address (L1-resident), ``skeleton`` without both; the
scatter form (K2's layout read backwards: four 16-byte reductions per
sample), appended to K4's source, on K2's bands; and ``d_out.sum()`` as a
yardstick of reading d_out once. Then K4 and the scatter form on the
clustered mask crop's RoIs at one bin (P = 1). Writes
``chiprun_out/ablate_k4.json``.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
ORDER = (0, 1, 1, 0)
SOURCE = os.path.join(ROOT, 'dynamask_torch', 'ops', 'csrc',
                      'roi_align_bwd.cu')
OUT = os.path.join(ROOT, 'build', 'ablate_k4')
# (anchor in the source, its stand-in) per part left out
CUTS = {
    'no_flush': [('if (nonzero(acc)) global_add(p, scaled(acc, inv));',
                  'if (nonzero(acc) && inv < 0.f) global_add(p, scaled(acc, '
                  'inv));')],
    'one_load': [('load_ro<VEC>(dn + bin * C)', 'load_ro<VEC>(dn)')],
}
CUTS['skeleton'] = CUTS['no_flush'] + CUTS['one_load']


def _smoke():
    """This checkout's chip_smoke.py, whatever checkout is imported."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_cases', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    import dynamask_torch
    from dynamask_torch.ops import roi_align as ra
    if not os.path.abspath(dynamask_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f'dynamask_torch imported from '
                           f'{dynamask_torch.__file__}, not {tree}')
    cs = _smoke()
    out = {'k2': {}, 'k4': {}}
    gen = torch.Generator(device='cuda').manual_seed(0)
    for case, args, kw in cs.k2_cases(gen, 'cuda'):
        got = ra.roi_align_fwd(*args, **kw)
        out['k2'][case] = dict(
            ms=cs.cuda_ms(lambda: ra.roi_align_fwd(*args, **kw)),
            bound_ms=cs.bound_of(*cs.k2_bound(args, kw, got))[0],
            bits=int(got.view(torch.int32).long().sum()))
        del got, args
    gen = torch.Generator(device='cuda').manual_seed(0)
    for case, args, kw in cs.k4_cases(gen, 'cuda'):
        got = ra.roi_align_bwd(*args, **kw)
        out['k4'][case] = dict(
            ms=cs.cuda_ms(lambda: ra.roi_align_bwd(*args, **kw)),
            bound_ms=cs.bound_of(*cs.k4_bound(args, kw, got))[0])
        del got, args
        torch.cuda.empty_cache()
    return out


def ab(trees, names):
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = []
    for k in ORDER:
        res = subprocess.run([sys.executable, HERE, '--worker', trees[k]],
                             cwd=trees[k], capture_output=True, text=True,
                             timeout=1200)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith('RESULT ')]
        if res.returncode != 0 or not lines:
            sys.exit(f'run in {trees[k]} failed:\n{res.stderr[-3000:]}')
        r = json.loads(lines[-1][len('RESULT '):])
        runs.append(dict(tree=names[k], **r))
        print(f'{names[k]}: ' + ', '.join(
            f'{kern.upper()} {case} {v["ms"]:.4f}' for kern in ('k2', 'k4')
            for case, v in r[kern].items()) + f' [{card}]', flush=True)
    summary = {}
    for t in names:
        mine = [r for r in runs if r['tree'] == t]
        summary[t] = {kern: {case: statistics.mean(r[kern][case]['ms']
                                                   for r in mine)
                             for case in mine[0][kern]}
                      for kern in ('k2', 'k4')}
    first = runs[0]
    for kern in ('k2', 'k4'):
        groups = {}
        for case, v in first[kern].items():
            a, b = (summary[t][kern][case] for t in names)
            same = ''
            if kern == 'k2':
                bits = {r['k2'][case]['bits'] for r in runs}
                same = ', bits equal' if len(bits) == 1 else ', BITS DIFFER'
            print(f'{kern.upper()} {case}: {names[0]} {a:.4f} ms, {names[1]} '
                  f'{b:.4f} ms; bound {v["bound_ms"]:.4f} ms, share '
                  f'{100 * v["bound_ms"] / a:.1f}% / '
                  f'{100 * v["bound_ms"] / b:.1f}%{same} [{card}]')
            g = groups.setdefault(case.split()[0], [0.0, 0.0, 0.0])
            g[0] += a
            g[1] += b
            g[2] += v['bound_ms']
        for group, (a, b, bound) in groups.items():
            print(f'{kern.upper()} {group} crops in sum: {names[0]} {a:.4f} '
                  f'ms ({100 * bound / a:.1f}%), {names[1]} {b:.4f} ms '
                  f'({100 * bound / b:.1f}%), bound {bound:.4f} ms [{card}]')
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'ab_torch_roi.json'),
              'w') as f:
        json.dump(dict(card=card, runs=runs, summary=summary), f, indent=1)


# K2's layout read backwards, K4's measured alternative, appended to K4's
# source: one block per (RoI, band of output rows) with K2's bands and
# tables, lanes over (output bin, channel quad), each inside sample adding
# d_out / s^2 times its four weights into its four corners with 16-byte
# reductions.
SCATTER = r"""
namespace {
template <int VEC, int S>
__global__ void __launch_bounds__(THREADS, 4) scatter_kernel(
    const float* __restrict__ d_out, const float* __restrict__ rois,
    const long long* __restrict__ base, const int* __restrict__ hs,
    const int* __restrict__ ws, const float* __restrict__ scales,
    float* __restrict__ d_feat, int C, int P, int s_rt, int band_rows,
    int n_bands, int lanes_log2) {
  using VT = typename Vec<VEC>::T;
  const int s = S > 0 ? S : s_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  AxisSample* t_x = reinterpret_cast<AxisSample*>(smem);
  AxisSample* t_y = t_x + P * s;
  const int band = (int)(blockIdx.x % (unsigned)n_bands);
  const long long n = blockIdx.x / (unsigned)n_bands;
  const int py_first = band * band_rows;
  const int rows = min(band_rows, P - py_first);
  float x1, y1, bin_w, bin_h;
  roi_geometry(rois + 4 * n, scales[n], P, x1, y1, bin_w, bin_h);
  const int h = hs[n], w = ws[n];
  const int nx = P * s, ny = rows * s;
  for (int e = threadIdx.x; e < nx + ny; e += THREADS) {
    const bool is_x = e < nx;
    const int k = is_x ? e : py_first * s + e - nx;
    const int extent = is_x ? w : h, stride = is_x ? 1 : w;
    AxisSample a;
    int v0;
    const bool inside = axis_geometry(k, s, is_x ? x1 : y1,
                                      is_x ? bin_w : bin_h, extent, v0, a.h,
                                      a.l);
    a.i0 = inside ? v0 * stride : -1;   // corners scaled, -1 outside
    a.i1 = min(v0 + 1, extent - 1) * stride;
    (is_x ? t_x : t_y)[is_x ? e : e - nx] = a;
  }
  __syncthreads();
  float* plane = d_feat + base[n] * C;
  const float* dob = d_out + (n * P + py_first) * P * C;
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int slot = threadIdx.x >> lanes_log2;
  const int slots = THREADS >> lanes_log2;
  const float inv = 1.f / (float)(s * s);
  for (int e = slot; e < rows * P; e += slots) {
    const int r = e / P, px = e - (e / P) * P;
    for (int q = sub; q < C / VEC; q += lanes) {
      const int c = q * VEC;
      const VT g = scaled(load_ro<VEC>(dob + (r * P + px) * C + c), inv);
      if (!nonzero(g)) continue;
      for (int iy = 0; iy < s; ++iy) {
        const AxisSample ya = t_y[r * s + iy];
        if (ya.i0 < 0) continue;
        for (int ix = 0; ix < s; ++ix) {
          const AxisSample xa = t_x[px * s + ix];
          if (xa.i0 < 0) continue;
          global_add(plane + (ya.i0 + xa.i0) * C + c, scaled(g, ya.h * xa.h));
          global_add(plane + (ya.i0 + xa.i1) * C + c, scaled(g, ya.h * xa.l));
          global_add(plane + (ya.i1 + xa.i0) * C + c, scaled(g, ya.l * xa.h));
          global_add(plane + (ya.i1 + xa.i1) * C + c, scaled(g, ya.l * xa.l));
        }
      }
    }
  }
}

template <int VEC, int S>
int launch_scatter(long long blocks, int smem_bytes, cudaStream_t st,
                   const float* d_out, const float* rois,
                   const long long* base, const int* hs, const int* ws,
                   const float* scales, float* d_feat, int C, int P, int s,
                   int band_rows, int n_bands, int lanes_log2) {
  scatter_kernel<VEC, S><<<(unsigned)blocks, THREADS, smem_bytes, st>>>(
      d_out, rois, base, hs, ws, scales, d_feat, C, P, s, band_rows, n_bands,
      lanes_log2);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int roi_align_bwd_scatter_f32(
    const float* d_out, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, float* d_feat, int N,
    int C, int P, int s, long long rows, int band_rows, int vec,
    int lanes_log2, int smem_bytes, void* stream) {
  const int n_bands = (P + band_rows - 1) / band_rows;
  const long long blocks = (long long)N * n_bands;
  cudaStream_t st = (cudaStream_t)stream;
#define SCATTER_ARGS blocks, smem_bytes, st, d_out, rois, base, hs, ws, \
    scales, d_feat, C, P, s, band_rows, n_bands, lanes_log2
  if (vec == 4)
    return s == 1 ? launch_scatter<4, 1>(SCATTER_ARGS)
           : s == 2 ? launch_scatter<4, 2>(SCATTER_ARGS)
                    : launch_scatter<4, 0>(SCATTER_ARGS);
  return s == 1 ? launch_scatter<1, 1>(SCATTER_ARGS)
         : s == 2 ? launch_scatter<1, 2>(SCATTER_ARGS)
                  : launch_scatter<1, 0>(SCATTER_ARGS);
}
"""


def _variant_fns():
    """K4 built again from its source: the ablation variants (each with
    its parts cut) and the scatter form (appended); name -> the C function,
    its argument types set."""
    from dynamask_torch.ops import _build
    with open(SOURCE) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    variants = {name: (cuts, '', 'roi_align_bwd_f32')
                for name, cuts in CUTS.items()}
    variants['scatter'] = ([], SCATTER, 'roi_align_bwd_scatter_f32')
    procs = {}
    for name, (cuts, extra, _) in variants.items():
        text = src
        for old, new in cuts:
            if text.count(old) < 1:
                raise RuntimeError(f'ablate: {old!r} is not in {SOURCE}')
            text = text.replace(old, new)
        cu = os.path.join(OUT, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(text + extra)
        so = os.path.join(OUT, f'lib{name}.so')
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'ablate: nvcc {name} failed:\n{log}')
        fn = getattr(ctypes.CDLL(so), variants[name][2])
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 +
                       [ctypes.c_longlong] + [ctypes.c_int] * 4 +
                       [ctypes.c_void_p])
        fns[name] = fn
    return fns


def ablate():
    import torch
    sys.path.insert(0, ROOT)
    from dynamask_torch.ops import roi_align as ra
    cs = _smoke()
    card = cs.card_line()
    fns = _variant_fns()
    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []

    def timed(case, args, kw, variants=tuple(fns)):
        d_out, rows, rois = args[:3]
        n, c = rois.shape[0], d_out.shape[-1]
        p, s = kw['out_size'], kw['sampling_ratio']
        d_flat = torch.zeros(rows, c, device='cuda')
        tensors = (d_out, *args[2:], d_flat)
        row = dict(case=case, zeros_ms=cs.cuda_ms(
            lambda: torch.zeros(rows, c, device='cuda')),
            d_out_sum_ms=cs.cuda_ms(lambda: d_out.sum()))
        cfg = ra.roi_align_launch_config('k4', n, p, s, c)
        row['k4_ms'] = cs.cuda_ms(lambda: ra._launch(
            'k4', tensors, n, c, p, s, rows, cfg, stream))
        for name in variants:
            # the scatter form on K2's bands, as K2's layout runs
            v_cfg = (ra.roi_align_launch_config('k2', n, p, s, c)
                     if name == 'scatter' else cfg)

            def run(fn=fns[name], v_cfg=v_cfg):
                rc = fn(*[t.data_ptr() for t in tensors], n, c, p, s, rows,
                        v_cfg['band_rows'], v_cfg['vec'],
                        v_cfg['lanes_log2'], v_cfg['smem_bytes'], stream)
                if rc:
                    raise RuntimeError(f'K4 {name}: CUDA error {rc}')
            row[f'{name}_ms'] = cs.cuda_ms(run)
        print(f'{case}: ' + ', '.join(f'{k[:-3]} {v:.4f}' for k, v in
                                      row.items() if k != 'case') +
              f' ms [{card}]', flush=True)
        rows_out.append(row)

    gen = torch.Generator(device='cuda').manual_seed(0)
    one_bin = None
    for case, args, kw in cs.k4_cases(gen, 'cuda'):
        timed(case, args, kw)
        if case.startswith(cs.CLUSTERED + ' mask'):
            one_bin = args
        del args
        torch.cuda.empty_cache()
    d_out = torch.randn(one_bin[2].shape[0], 1, 1, one_bin[0].shape[-1],
                        generator=gen, device='cuda')
    timed('clustered mask RoIs, one bin (P = 1) r2', (d_out, *one_bin[1:]),
          dict(out_size=1, sampling_ratio=2), variants=('scatter',))
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'ablate_k4.json'), 'w') as f:
        json.dump(dict(card=card, rows=rows_out), f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('trees', nargs='*')
    ap.add_argument('--ablate', action='store_true',
                    help="time K4's parts in this checkout")
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print('RESULT ' + json.dumps(worker(args.worker)))
    elif args.ablate:
        ablate()
    elif len(args.trees) == 2:
        ab([os.path.abspath(t) for t in args.trees], args.trees)
    else:
        ap.error('give two checkouts, or --ablate')


if __name__ == '__main__':
    main()
