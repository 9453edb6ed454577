#!/usr/bin/env python3
"""What K3 (``dynamask_torch/ops/csrc/deform_col2im.cu``) spends its time on,
on one GPU.

    python3 tools/ablate_k3.py

Builds K3 four times from its source, each build with parts of the work
left out (results are wrong; only the times count): ``full``; ``no_dx``
without the 16-byte d_x reductions; ``no_x`` without the corner loads of x
(so without the offset gradient's values); ``skeleton`` without both, which
leaves the table, the d_col stream and the d_offset stores. Times each, with
CUDA events, at the three SFM stages of the flagship's training step
(n = 512; 14x14x256, 28x28x128, 56x56x64; 2 deform groups, window 3) with
random (up to ±5 px) and zero offsets, beside ``d_col.sum()`` as a yardstick
of streaming d_col once. Also prints the SASS that ``nvcc`` emits for an
fp32 ``atomicAdd`` to shared memory on sm_90a. Writes
``chiprun_out/ablate_k3.json``.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, 'build', 'ablate_k3')
SOURCE = os.path.join(ROOT, 'dynamask_torch', 'ops', 'csrc',
                      'deform_col2im.cu')
# (anchor in the source, its stand-in) per part left out
CUTS = {
    'no_dx': [('const bool a00 = pc.x >= 0 && w00 != 0.f, a01 = pc.y >= 0 '
               '&& w01 != 0.f;',
               'const bool a00 = false, a01 = false;'),
              ('const bool a10 = pc.z >= 0 && w10 != 0.f, a11 = pc.w >= 0 '
               '&& w11 != 0.f;',
               'const bool a10 = false, a11 = false;')],
    'no_x': [(f'const float4 v{c} = pv.{a} >= 0 ?',
              f'const float4 v{c} = false ?')
             for c, a in (('00', 'x'), ('01', 'y'), ('10', 'z'),
                          ('11', 'w'))],
}
CUTS['skeleton'] = CUTS['no_dx'] + CUTS['no_x']
VARIANTS = ('full', 'no_dx', 'no_x', 'skeleton')


def _variant_source(name: str) -> str:
    with open(SOURCE) as f:
        src = f.read()
    for old, new in CUTS.get(name, ()):
        if src.count(old) != 1:
            raise RuntimeError(f'ablate_k3: {old!r} is not in {SOURCE} once')
        src = src.replace(old, new)
    return src


def _build(nvcc):
    from dynamask_torch.ops import _build as b
    os.makedirs(OUT, exist_ok=True)
    fns = {}
    for name in VARIANTS:
        cu = os.path.join(OUT, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(_variant_source(name))
        so = os.path.join(OUT, f'lib{name}.so')
        subprocess.run([nvcc, *b.NVCC_FLAGS, '-o', so, cu], check=True,
                       capture_output=True, text=True)
        fn = ctypes.CDLL(so).deform_col2im_windowed_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [
            ctypes.c_void_p]
        fns[name] = fn
    return fns


def _shared_atomic_sass(nvcc) -> list:
    cu = os.path.join(OUT, 'smem_atomic.cu')
    with open(cu, 'w') as f:
        f.write('__global__ void k(float* p, float v) {\n'
                '  __shared__ float s[64];\n  s[threadIdx.x] = 0.f;\n'
                '  __syncthreads();\n  atomicAdd(s + (threadIdx.x * 7) % 64, '
                'v);\n  __syncthreads();\n  p[threadIdx.x] = s[threadIdx.x];'
                '\n}\n')
    cubin = cu[:-3] + '.cubin'
    subprocess.run([nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-cubin', '-o', cubin, cu], check=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), 'cuobjdump'),
                           '-sass', cubin], capture_output=True, text=True,
                          check=True).stdout
    return [ln.split(';')[0].split('*/')[-1].strip()
            for ln in sass.splitlines() if 'ATOM' in ln]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('ablate_k3: needs a CUDA device')
    from chip_smoke import SFM_STAGES, card_line, cuda_ms
    from dynamask_torch.ops import _build as b
    from dynamask_torch.ops.deform_conv import dcn_launch_config
    card = card_line()
    nvcc = b._nvcc()
    fns = _build(nvcc)
    sass = _shared_atomic_sass(nvcc)
    print(f'fp32 atomicAdd to shared memory on sm_90a: {sass}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    n = 512
    for s, c in SFM_STAGES:
        x = torch.randn(n, s, s, c, generator=gen, device='cuda')
        d_col = torch.randn(n, s, s, 2, 9, c // 2, generator=gen,
                            device='cuda')
        offs = {'random': (torch.rand(n, s, s, 36, generator=gen,
                                      device='cuda') - 0.5) * 10,
                'zero': torch.zeros(n, s, s, 36, device='cuda')}
        d_x, d_off = torch.zeros_like(x), torch.empty_like(offs['zero'])
        cfg = dcn_launch_config('k3', n, s, s, c, 2, 3)
        stream = torch.cuda.current_stream().cuda_stream
        row = dict(case=f'{n}x{s}x{s}x{c}', d_col_sum_ms=cuda_ms(
            lambda: d_col.sum()))
        for kind, off in offs.items():
            for name, fn in fns.items():
                def run():
                    rc = fn(x.data_ptr(), off.data_ptr(), d_col.data_ptr(),
                            d_x.data_ptr(), d_off.data_ptr(), n, s, s, c, 2,
                            3, 1, 1, 3, cfg['band_rows'],
                            cfg['table_entries'], cfg['vec'],
                            cfg['lanes_log2'], cfg['smem_bytes'], stream)
                    if rc:
                        raise RuntimeError(f'K3 {name}: CUDA error {rc}')
                row[f'{kind}_{name}_ms'] = cuda_ms(run)
        print(f'{row["case"]}: ' + ', '.join(
            f'{k[:-3]} {v:.4f}' for k, v in row.items() if k != 'case') +
            f' ms [{card}]', flush=True)
        rows.append(row)
        del x, d_col, offs, d_x, d_off
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'ablate_k3.json'), 'w') as f:
        json.dump(dict(card=card, shared_atomic_sass=sass, rows=rows), f,
                  indent=1)


if __name__ == '__main__':
    main()
