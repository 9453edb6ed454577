#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch. Phases, in order; any failure exits non-zero
before the last line is printed:

1. build the hand-written kernels K1 (``deform_im2col_windowed``) and K2
   (``roi_align_fwd``) from ``dynamask_torch/ops/csrc`` (one ``nvcc`` per
   source, started together);
2. hold each kernel against its plain PyTorch version at the shapes the
   flagship main path gives it, and time both with CUDA events;
3. check the port end to end on a small input: a toy DynaMask model on the
   GPU (kernels) against the same model on the CPU (plain versions);
4. drive the main path: DynaMask R50-FPN (``configs/dynamask/coco/
   r50_dynamask_1x.py``) at full width, random weights N(0, 0.05) from a
   seeded generator, one 800x1344 image in fp32, ``simple_test`` + mask paste
   in the faithful and the MSM-routed mode; for each mode the kernels'
   launch counters are zeroed just before its drive and read just after,
   and every kernel must have launched in each.

Standard output ends with the ``kernels`` JSON line, the card's name and
power limit as ``nvidia-smi`` reports them, and the ``{"ok": true, ...}``
line. Details go to ``chiprun_out/chip_smoke.json``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

DEVICE = 'cuda'
IMAGE_HW = (800, 1344)           # the flagship's test canvas
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
K1_TOL = 1e-4   # same arithmetic as the plain form; fma contraction only
K2_TOL = 1e-4   # same samples; summation order and fma only


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(DEVICE)
    return start.elapsed_time(end) / iters


def k1_cases(gen, dev):
    """K1 at the three SFM stages of the main path: n = 100 dets,
    (S, C) = (14, 256), (28, 128), (56, 64), 2 deform groups. Offsets reach
    ±5 px, past the ±3 window and off the plane."""
    import torch
    for s, c in ((14, 256), (28, 128), (56, 64)):
        x = torch.randn(100, s, s, c, generator=gen, device=dev)
        off = (torch.rand(100, s, s, 36, generator=gen, device=dev) - 0.5) * 10
        yield f'{s}x{s}x{c}', (x, off), dict(kernel_size=3, padding=1,
                                               dilation=1, deform_groups=2,
                                               window=3)


def k2_cases(gen, dev):
    """K2 at the main path's five crops: the 7x7 box extract (1000 RoIs,
    ratio 2) and the 14x14 mask extract (100, ratio 2) over P2-P5, the SFM
    crops (100 x {14, 28, 56}^2 of P4/P3/P2 at scale 1/4 with 256/128/64
    channels, ratio 1) and the MSM 56x56x128 crop of P2 (ratio 1). RoIs
    include boxes partly off the image, zero-area and very wide ones."""
    import torch
    from dynamask_torch.ops import roi_align as ra
    h, w = IMAGE_HW
    shapes = [(h // s, w // s) for s in (4, 8, 16, 32)]

    def rois(n):
        xy = torch.rand(n, 2, generator=gen, device=dev) * torch.tensor(
            [w, h], device=dev)
        wh = torch.rand(n, 2, generator=gen, device=dev) ** 2 * torch.tensor(
            [w, h], device=dev)
        r = torch.cat([xy - wh / 4, xy + wh], 1)
        r[:4] = torch.tensor([[-40., -30., 100., 90.],     # partly off
                              [h / 2, h / 2, h / 2, h / 2],  # zero area
                              [0., h / 3, w, h / 3 + 60],   # very wide
                              [w - 100, h - 80, w + 60, h + 40]], device=dev)
        return r.contiguous()

    def multilevel(n, p, c, ratio):
        feats = [torch.randn(1, a, b, c, generator=gen, device=dev)
                 for a, b in shapes]
        r = rois(n)
        flat, offsets = ra._flat_planes(feats)
        lvl = ra.map_roi_levels(r, 4)
        hs = torch.tensor([a for a, _ in shapes], device=dev,
                          dtype=torch.int32)[lvl]
        ws = torch.tensor([b for _, b in shapes], device=dev,
                          dtype=torch.int32)[lvl]
        base = torch.tensor(offsets, device=dev)[lvl]
        sc = (1.0 / torch.tensor([4., 8., 16., 32.], device=dev))[lvl]
        return (flat, r, base.contiguous(), hs.contiguous(), ws.contiguous(),
                sc.contiguous()), dict(out_size=p, sampling_ratio=ratio)

    def single(n, p, c, plane, ratio):
        a, b = plane
        feat = torch.randn(1, a, b, c, generator=gen, device=dev)
        r = rois(n)
        flat, _ = ra._flat_planes([feat])
        return (flat, r, torch.zeros(n, dtype=torch.int64, device=dev),
                torch.full((n,), a, dtype=torch.int32, device=dev),
                torch.full((n,), b, dtype=torch.int32, device=dev),
                torch.full((n,), 0.25, device=dev)), dict(
                    out_size=p, sampling_ratio=ratio)

    yield 'box 1000x7x7x256 r2', *multilevel(1000, 7, 256, 2)
    yield 'mask 100x14x14x256 r2', *multilevel(100, 14, 256, 2)
    yield 'sfm P4 100x14x14x256 r1', *single(100, 14, 256, shapes[2], 1)
    yield 'sfm P3 100x28x28x128 r1', *single(100, 28, 128, shapes[1], 1)
    yield 'sfm P2 100x56x56x64 r1', *single(100, 56, 64, shapes[0], 1)
    yield 'msm P2 100x56x56x128 r1', *single(100, 56, 128, shapes[0], 1)


def k1_bound(args, kw, out):
    x, off = args
    nbytes = 4 * (x.numel() + off.numel() + out.numel())
    flops = 13 * out.numel()       # 4 tent weights + 9 for the 2x2 blend
    return nbytes, flops


def k2_bound(args, kw, out):
    flat, rois, base, hs, ws, sc = args
    nbytes = (4 * (flat.numel() + rois.numel() + hs.numel() + ws.numel() +
                   sc.numel() + out.numel()) + 8 * base.numel())
    flops = out.numel() * (kw['sampling_ratio'] ** 2 * 16 + 1)
    return nbytes, flops


def check_kernels(report):
    """Phase 2: each kernel against its plain version, timed."""
    import torch
    from dynamask_torch.ops import deform_conv as dc, roi_align as ra
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for name, kernel, plain, cases, bound, tol, src, replaces in (
            ('deform_im2col_windowed', dc.deform_im2col_windowed,
             dc.deform_im2col_windowed_plain, k1_cases, k1_bound, K1_TOL,
             'dynamask_torch/ops/csrc/deform_im2col.cu',
             'dynamask_tpu/ops/deform_conv_pallas.py:318'),
            ('roi_align_fwd', ra.roi_align_fwd, ra.roi_align_fwd_plain,
             k2_cases, k2_bound, K2_TOL,
             'dynamask_torch/ops/csrc/roi_align.cu',
             'dynamask_tpu/ops/roi_align_pallas.py:45')):
        agg = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0, flops=0)
        for case, args, kw in cases(gen, DEVICE):
            launches = kernel.launches
            got = kernel(*args, **kw)
            torch.cuda.synchronize(DEVICE)
            if kernel.launches != launches + 1:
                raise RuntimeError(f'{name} did not launch its kernel')
            ref = plain(*args, **kw)
            err = (got - ref).abs().max().item()
            if not (err <= tol and torch.isfinite(got).all()):
                raise RuntimeError(f'{name} [{case}] disagrees with its '
                                   f'plain version: max abs err {err}')
            ms = cuda_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=5)
            nbytes, flops = bound(args, kw, got)
            b_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                             flops / FP32_FLOPS_PER_S)
            print(f'  {name} [{case}]: max_abs_err {err:.3e} (tol {tol}) '
                  f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                  f'{b_ms:.4f} ms ({nbytes / 1e9:.4f} GB)')
            report['kernel_cases'].append(dict(
                name=name, case=case, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bytes=nbytes, flops=flops))
            agg['max_abs_err'] = max(agg['max_abs_err'], err)
            agg['ms'] += ms
            agg['plain_ms'] += plain_ms
            agg['nbytes'] += nbytes
            agg['flops'] += flops
            del got, ref
        t_bytes = agg['nbytes'] / HBM_BYTES_PER_S
        t_ops = agg['flops'] / FP32_FLOPS_PER_S
        rows.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=None, max_abs_err=agg['max_abs_err'], ms=agg['ms'],
            plain_ms=agg['plain_ms'], bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
            library_ms=None))
    return rows


def toy_cfg():
    """A small DynaMask Mask R-CNN (ResNet-18, 32-channel FPN, 8 classes)."""
    from dynamask_torch.utils import Config
    cfg = Config.fromfile(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), 'configs/dynamask/coco/'
        'r50_dynamask_1x.py'))
    m = cfg.model
    m.backbone.depth = 18
    m.neck.in_channels = [64, 128, 256, 512]
    m.neck.out_channels = 32
    m.rpn_head.in_channels = m.rpn_head.feat_channels = 32
    rh = m.roi_head
    for ext in (rh.bbox_roi_extractor, rh.mask_roi_extractor):
        ext.out_channels = 32
    rh.bbox_head.in_channels = 32
    rh.bbox_head.fc_out_channels = 64
    rh.bbox_head.num_classes = 8
    mh = rh.mask_head
    mh.num_convs_instance = 1
    mh.conv_out_channels_instance = mh.conv_out_channels_semantic = 32
    mh.stage_num_classes = [8, 8, 8, 1]
    cfg.test_cfg.rpn.nms_pre = 64
    cfg.train_cfg.rpn_proposal.max_num = 32
    cfg.test_cfg.rcnn.max_per_img = 8
    return cfg


def check_toy_against_cpu(report):
    """Phase 3: the port on the GPU against itself on the CPU."""
    import torch
    from dynamask_torch.models import build_detector
    cfg = toy_cfg()
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(1, 128, 128, 3, generator=gen)
    batch = {'image': img, 'img_shape': torch.tensor([[128., 128.]]),
             'scale_factor': torch.ones(1, 4)}
    for dynamic in (False, True):
        cfg.model.roi_head.dynamic_inference = dynamic
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                               device=DEVICE)
        model.load_state_dict(ref.state_dict())
        a = ref.simple_test(batch)
        b = {k: v.cpu() for k, v in model.simple_test(
            {k: v.to(DEVICE) for k, v in batch.items()}).items()
            if torch.is_tensor(v)}
        errs = {k: (a[k].double() - b[k].double()).abs().max().item()
                for k in ('dets', 'mask_probs')}
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        print(f'  toy {"dynamic" if dynamic else "faithful"}: '
              f'{int(a["det_valid"].sum())} dets, GPU vs CPU max abs err '
              f'dets {errs["dets"]:.3e}, mask_probs {errs["mask_probs"]:.3e}, '
              f'labels/valid equal {same}')
        report['toy'].append(dict(dynamic=dynamic, same_labels_valid=same,
                                  **errs))
        # fp32 on both devices (TF32 off), other summation orders: ~1e-5
        # on 128-px box coordinates and on mask probabilities
        if not (same and errs['dets'] < 1e-3 and errs['mask_probs'] < 1e-3):
            raise RuntimeError('toy model: GPU result disagrees with the CPU '
                               'reference')


def run_main_path(report, card):
    """Phase 4: the flagship, both modes, launch counters around one drive."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import inference_detector, init_detector
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    model = init_detector(os.path.join(root, 'configs/dynamask/coco/'
                                       'r50_dynamask_1x.py'),
                          device=DEVICE, seed=0, init_std=0.05)
    print(f'  flagship built on {model.device} in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)')
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    h, w = IMAGE_HW
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE)}
    rh = model.roi_head
    modes = (('faithful', False), ('dynamic', True))

    def drive(dynamic):
        rh.dynamic_inference = dynamic
        out = inference_detector(model, batch)
        torch.cuda.synchronize(DEVICE)
        return out

    outs, launches = {}, {}
    for mode, dyn in modes:
        ops.reset_kernel_launches()
        outs[mode] = drive(dyn)
        launches[mode] = ops.kernel_launches()
        print(f'  {mode}: kernel launches over one image: {launches[mode]}')
        for name, n in launches[mode].items():
            if n <= 0:
                raise RuntimeError(f'{name} was not launched on the {mode} '
                                   f'path')
    report['launches'] = launches

    for name, dyn in modes:
        out = outs[name]
        d = rh.max_per_img
        expect = {'dets': (1, d, 5), 'labels': (1, d), 'valid': (1, d),
                  'masks': (1, d, h, w)}
        for k, shape in expect.items():
            if tuple(out[k].shape) != shape:
                raise RuntimeError(f'{name}: {k} shape {tuple(out[k].shape)}'
                                   f' != {shape}')
        if not torch.isfinite(out['dets']).all():
            raise RuntimeError(f'{name}: non-finite dets')
        times = []
        for _ in range(5):
            t = time.perf_counter()
            drive(dyn)
            times.append(1e3 * (time.perf_counter() - t))
        ms = statistics.median(times)
        n_valid = int(out['valid'].sum())
        line = (f'  {name}: {ms:.1f} ms/img (median of 5, after 1 warm-up) '
                f'[{card}], {n_valid} valid dets, '
                f'{int(out["masks"][out["valid"]].sum())} mask pixels')
        rec = dict(mode=name, ms_per_img=ms, times_ms=times,
                   valid_dets=n_valid)
        if 'msm_routing' in out:
            r = {k: v.tolist() for k, v in out['msm_routing'].items()
                 if k != 'need'}
            line += f', routing {r}'
            rec['routing'] = r
        print(line)
        report['main_path'].append(rec)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on a GPU',
              file=sys.stderr)
        return 2
    from dynamask_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 GEMMs
    torch.backends.cudnn.allow_tf32 = False         # fp32 convs
    card = card_line()
    print(f'device: {torch.cuda.get_device_name(0)} | torch '
          f'{torch.__version__} cuda {torch.version.cuda} | {card}')
    report = {'card': card, 'kernel_cases': [], 'toy': [], 'main_path': []}

    print('phase 1: build kernels')
    t0 = time.perf_counter()
    built = _build.build()
    print(f'  built {sorted(built)} in {time.perf_counter() - t0:.1f} s')
    for name, info in built.items():
        for ln in info['log'].splitlines():
            if 'registers' in ln or 'spill' in ln:
                print(f'  {name}: {ln.strip()}')
    report['build'] = {k: v['seconds'] for k, v in built.items()}

    print(f'phase 2: kernels against their plain versions [{card}]')
    rows = check_kernels(report)
    print('phase 3: toy model, GPU against CPU')
    check_toy_against_cpu(report)
    print(f'phase 4: flagship main path [{card}]')
    launches = run_main_path(report, card)
    for row in rows:   # each mode's count from its own zeroed drive
        by_mode = {mode: n[row['name']] for mode, n in launches.items()}
        row['launches'] = sum(by_mode.values())
        row['launches_by_mode'] = by_mode
    report['kernels'] = rows
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        rc = main()
    except Exception as e:  # report and fail: no phase may swallow an error
        import traceback
        traceback.print_exc()
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        rc = 1
    sys.exit(rc)
