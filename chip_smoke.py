#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch. Phases, in order; any failure exits non-zero
before the last line is printed:

1. build the hand-written kernels K1 (``deform_im2col_windowed``), K2
   (``roi_align_fwd``), K3 (``deform_col2im_windowed``, K1's backward) and K4
   (``roi_align_bwd``, K2's backward) from ``dynamask_torch/ops/csrc`` (one
   ``nvcc`` per source, started together);
2. hold each kernel against its plain PyTorch version at the shapes the
   flagship's inference and training paths give it, and time both with CUDA
   events;
3. check the port end to end on a small input: a toy DynaMask model on the
   GPU (kernels) against the same model on the CPU (plain versions), at
   inference and for one training step (losses and per-parameter
   gradients);
4. drive the inference path: DynaMask R50-FPN (``configs/dynamask/coco/
   r50_dynamask_1x.py``) at full width, random weights N(0, 0.05) from a
   seeded generator, one 800x1344 image in fp32, ``simple_test`` + mask paste
   in the faithful and the MSM-routed mode;
5. drive the training path: the same config at full width with its own
   seeded initialisation (zero DCN offsets, as the JAX package), a seeded
   synthetic batch of 4 images at 800x1344 with 20 GTs each, fp32, on the
   host; one warm-up and three timed SGD steps, each a call of
   ``train_detector`` on the trainer from ``init_trainer``.

For each of the three drives (faithful, dynamic, train) the kernels' launch
counters are zeroed just before it and read just after, and every kernel of
that path must have launched in it: K1 and K2 at inference, K1-K4 in
training.

Standard output ends with the ``kernels`` JSON line, the card's name and
power limit as ``nvidia-smi`` reports them, and the ``{"ok": true, ...}``
line. Details go to ``chiprun_out/chip_smoke.json``.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

DEVICE = 'cuda'
ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, 'configs/dynamask/coco/r50_dynamask_1x.py')
IMAGE_HW = (800, 1344)           # the flagship's test canvas
TRAIN_IMAGES = 4                 # the config's samples_per_gpu
TRAIN_GTS = 20
TIMED_STEPS = 3                  # after one warm-up step
# the lr schedule's epoch: COCO train2017's 117266 images with annotations
# at the config's 4 per step on one card
COCO_STEPS_PER_EPOCH = 117266 // TRAIN_IMAGES
N_DETS = 100                     # inference: max_per_img dets reach the mask
N_BOX_TRAIN = TRAIN_IMAGES * 512  # training: sampled RoIs of the box branch
N_POS_TRAIN = TRAIN_IMAGES * 128  # training: max_pos slots of the mask branch
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
# Tolerances, each against the kernel's plain version on the same inputs:
K1_TOL = 1e-4   # absolute; same arithmetic as the plain form, fma only
K2_TOL = 1e-4   # absolute; same samples; summation order and fma only
# K3 and K4 sum with fp32 atomics (and K3 its channel sums by warp shuffle)
# in another order than the plain versions: relative to the largest value
K3_RTOL = 1e-5
K4_RTOL = 1e-5


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


# -- kernel cases -------------------------------------------------------------

SFM_STAGES = ((14, 256), (28, 128), (56, 64))   # (S, C) of the 3 DCNs


def k1_cases(gen, dev):
    """K1 at the three SFM stages: n = 100 dets at inference, 512 positive
    slots in training; 2 deform groups. Offsets reach ±5 px, past the ±3
    window and off the plane."""
    import torch
    for path, n in (('infer', N_DETS), ('train', N_POS_TRAIN)):
        for s, c in SFM_STAGES:
            x = torch.randn(n, s, s, c, generator=gen, device=dev)
            off = (torch.rand(n, s, s, 36, generator=gen, device=dev) - 0.5) \
                * 10
            yield f'{path} {n}x{s}x{s}x{c}', (x, off), dict(
                kernel_size=3, padding=1, dilation=1, deform_groups=2,
                window=3)


def k3_cases(gen, dev):
    """K3 at the training shapes of K1, with a random column gradient."""
    import torch
    for case, (x, off), kw in k1_cases(gen, dev):
        if case.startswith('train'):
            n, s, _, c = x.shape
            d_col = torch.randn(n, s, s, 2, 9, c // 2, generator=gen,
                                device=dev)
            yield case, (x, off, d_col), kw
            del x, off, d_col


def _crops(gen, dev, images, n_box, n_mask):
    """The crops of the main path, as (name, K2 arguments, options): the 7x7
    box extract (ratio 2) and the 14x14 mask extract (ratio 2) over P2-P5,
    the SFM crops ({14, 28, 56}^2 of P4/P3/P2 at scale 1/4 with 256/128/64
    channels, ratio 1) and the MSM 56x56x128 crop of P2 (ratio 1), over
    ``images`` images. RoIs include boxes partly off the image, zero-area and
    very wide ones."""
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

    def batch_of(n):
        return torch.randint(0, images, (n,), generator=gen, device=dev)

    def multilevel(n, p, c, ratio):
        feats = [torch.randn(images, a, b, c, generator=gen, device=dev)
                 for a, b in shapes]
        r = rois(n)
        flat, offsets = ra._flat_planes(feats)
        lvl = ra.map_roi_levels(r, 4)
        hs = torch.tensor([a for a, _ in shapes], device=dev,
                          dtype=torch.int32)[lvl]
        ws = torch.tensor([b for _, b in shapes], device=dev,
                          dtype=torch.int32)[lvl]
        base = torch.tensor(offsets, device=dev)[lvl] + batch_of(n) * (
            hs.long() * ws.long())
        sc = (1.0 / torch.tensor([4., 8., 16., 32.], device=dev))[lvl]
        return (flat, r, base.contiguous(), hs.contiguous(), ws.contiguous(),
                sc.contiguous()), dict(out_size=p, sampling_ratio=ratio)

    def single(n, p, c, plane, ratio):
        a, b = plane
        feat = torch.randn(images, a, b, c, generator=gen, device=dev)
        flat, _ = ra._flat_planes([feat])
        return (flat, rois(n), batch_of(n) * (a * b),
                torch.full((n,), a, dtype=torch.int32, device=dev),
                torch.full((n,), b, dtype=torch.int32, device=dev),
                torch.full((n,), 0.25, device=dev)), dict(
                    out_size=p, sampling_ratio=ratio)

    yield f'box {n_box}x7x7x256 r2', *multilevel(n_box, 7, 256, 2)
    yield f'mask {n_mask}x14x14x256 r2', *multilevel(n_mask, 14, 256, 2)
    for (s, c), plane, lvl in zip(SFM_STAGES, shapes[2::-1],
                                  ('P4', 'P3', 'P2')):
        yield f'sfm {lvl} {n_mask}x{s}x{s}x{c} r1', *single(n_mask, s, c,
                                                            plane, 1)
    yield f'msm P2 {n_mask}x56x56x128 r1', *single(n_mask, 56, 128, shapes[0],
                                                   1)


def k2_cases(gen, dev):
    """K2 at the inference crops (one image, 1000 proposals, 100 dets) and
    at the training crops (4 images, 2048 sampled RoIs, 512 positive
    slots)."""
    for case, args, kw in _crops(gen, dev, 1, 1000, N_DETS):
        yield 'infer ' + case, args, kw
    for case, args, kw in _crops(gen, dev, TRAIN_IMAGES, N_BOX_TRAIN,
                                 N_POS_TRAIN):
        yield 'train ' + case, args, kw


def k4_cases(gen, dev):
    """K4 at the training crops (4 images, 2048 sampled RoIs, 512 positive
    slots), with a random crop gradient."""
    import torch
    for case, args, kw in _crops(gen, dev, TRAIN_IMAGES, N_BOX_TRAIN,
                                 N_POS_TRAIN):
        flat, rois = args[:2]
        p = kw['out_size']
        d_out = torch.randn(rois.shape[0], p, p, flat.shape[1], generator=gen,
                            device=dev)
        yield 'train ' + case, (d_out, flat.shape[0], *args[1:]), kw
        del flat, args, d_out


# -- bounds: bytes each function must move, operations it must do ------------

def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_bound(args, kw, out):
    x, off = args
    return _nbytes(x, off, out), 13 * out.numel()  # 4 tents + 9 for 2x2 blend


def k3_bound(args, kw, out):
    x, off, d_col = args
    d_x, d_off = out
    # per column element: two 7-op channel terms, four corner weights times
    # the gradient and four adds into d_x
    return _nbytes(x, off, d_col, d_x, d_off), 22 * d_col.numel()


def k2_bound(args, kw, out):
    flat, rois, base, hs, ws, sc = args
    return (_nbytes(flat, rois, base, hs, ws, sc, out),
            out.numel() * (kw['sampling_ratio'] ** 2 * 16 + 1))


def k4_bound(args, kw, out):
    d_out, _, rois, base, hs, ws, sc = args
    # per sample: four weights, four products with the gradient, four adds
    return (_nbytes(d_out, rois, base, hs, ws, sc, out),
            d_out.numel() * (kw['sampling_ratio'] ** 2 * 12 + 1))


def _compare(got, ref):
    """(max abs error, max abs reference, all finite) over one output or a
    tuple of outputs."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    scale = max(b.abs().max().item() for b in ref)
    return err, scale, all(torch.isfinite(a).all().item() for a in got)


def kernel_specs():
    from dynamask_torch.ops import deform_conv as dc, roi_align as ra
    no_lib = ('no PyTorch call computes this function (no DCN or RoIAlign '
              'op in PyTorch without torchvision)')
    return (
        dict(name='deform_im2col_windowed', kernel=dc.deform_im2col_windowed,
             plain=dc.deform_im2col_windowed_plain, cases=k1_cases,
             bound=k1_bound, tol=K1_TOL, relative=False,
             source='dynamask_torch/ops/csrc/deform_im2col.cu',
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:318',
             library_null=no_lib),
        dict(name='roi_align_fwd', kernel=ra.roi_align_fwd,
             plain=ra.roi_align_fwd_plain, cases=k2_cases, bound=k2_bound,
             tol=K2_TOL, relative=False,
             source='dynamask_torch/ops/csrc/roi_align.cu',
             replaces='dynamask_tpu/ops/roi_align_pallas.py:45',
             library_null=no_lib),
        dict(name='deform_col2im_windowed',
             kernel=dc.deform_col2im_windowed,
             plain=dc.deform_col2im_windowed_plain, cases=k3_cases,
             bound=k3_bound, tol=K3_RTOL, relative=True,
             source='dynamask_torch/ops/csrc/deform_col2im.cu',
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:535',
             library_null='no PyTorch call computes the DCN backward'),
        dict(name='roi_align_bwd', kernel=ra.roi_align_bwd,
             plain=ra.roi_align_bwd_plain, cases=k4_cases, bound=k4_bound,
             tol=K4_RTOL, relative=True,
             source='dynamask_torch/ops/csrc/roi_align_bwd.cu',
             # no Pallas backward: XLA autodiff of the gather form
             replaces='dynamask_tpu/ops/roi_align.py:46',
             library_null='no PyTorch call computes the RoIAlign backward'))


def check_kernels(report):
    """Phase 2: each kernel against its plain version, timed."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for spec in kernel_specs():
        name, kernel, plain = spec['name'], spec['kernel'], spec['plain']
        agg = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0, flops=0)
        for case, args, kw in spec['cases'](gen, DEVICE):
            launches = kernel.launches
            got = kernel(*args, **kw)
            torch.cuda.synchronize(DEVICE)
            if kernel.launches != launches + 1:
                raise RuntimeError(f'{name} did not launch its kernel')
            ref = plain(*args, **kw)
            err, scale, finite = _compare(got, ref)
            limit = spec['tol'] * (scale if spec['relative'] else 1.0)
            if not (err <= limit and finite):
                raise RuntimeError(f'{name} [{case}] disagrees with its '
                                   f'plain version: max abs err {err} '
                                   f'(limit {limit}, max |ref| {scale})')
            del ref
            ms = cuda_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=5)
            nbytes, flops = spec['bound'](args, kw, got)
            b_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                             flops / FP32_FLOPS_PER_S)
            tol = (f'{spec["tol"]} x max|ref| {scale:.3e}' if spec['relative']
                   else f'{spec["tol"]}')
            print(f'  {name} [{case}]: max_abs_err {err:.3e} (tol {tol}) '
                  f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                  f'{b_ms:.4f} ms ({nbytes / 1e9:.4f} GB)')
            report['kernel_cases'].append(dict(
                name=name, case=case, max_abs_err=err, max_abs_ref=scale,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bytes=nbytes,
                flops=flops))
            agg['max_abs_err'] = max(agg['max_abs_err'], err)
            agg['ms'] += ms
            agg['plain_ms'] += plain_ms
            agg['nbytes'] += nbytes
            agg['flops'] += flops
            del got, args
            torch.cuda.empty_cache()
        t_bytes = agg['nbytes'] / HBM_BYTES_PER_S
        t_ops = agg['flops'] / FP32_FLOPS_PER_S
        rows.append(dict(
            name=name, route='cuda', source=spec['source'],
            replaces=spec['replaces'], launches=None,
            max_abs_err=agg['max_abs_err'], ms=agg['ms'],
            plain_ms=agg['plain_ms'], bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
            library_ms=None, library_ms_null=spec['library_null']))
    return rows


# -- phase 3: a toy model, GPU against CPU ------------------------------------

def toy_cfg():
    """A small DynaMask Mask R-CNN (ResNet-18, 32-channel FPN, 8 classes)."""
    from dynamask_torch.utils import Config
    cfg = Config.fromfile(FLAGSHIP)
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
    cfg.train_cfg.rcnn.sampler.num = 64
    cfg.test_cfg.rcnn.max_per_img = 8
    return cfg


def check_toy_against_cpu(report):
    """Phase 3a: inference, the port on the GPU against itself on the CPU."""
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


TOY_LOSS_RTOL = 1e-4   # fp32 sums in other orders: ~1e-6 relative
# Per parameter, relative L2 of the gradient, GPU against CPU: at most
# TOY_GRAD_RL2, or TOY_GRAD_FLOOR times that parameter's own response on the
# CPU to a 1e-7 relative perturbation of the input image (fp32 rounding
# noise). The MSM's gradients are ill-conditioned in the reference math
# (its conv biases are cancelled by batch-statistics BatchNorms) and move
# by ~2e-4 under that perturbation. Each conv's backward alone, cuDNN's
# included, agrees with float64 as closely as the CPU's fp32 does
# (tools/diagnose_toy_train_grads.py); what parts the devices further is an
# input within rounding of a kink: a ReLU input near zero (one such element
# put 9.5e-3 into the toy's stage-2 gradients) or a DCN offset near an
# integer, on one side on the GPU and on the other on the CPU. So the other
# runs take the first GPU run's side wherever the two inputs differ by at
# most KINK_RTOL of the input's largest magnitude (fp32 rounding of sums of
# a few hundred terms is ~1e-6 of it), and a side that differs by more
# fails (:class:`KinkSides`).
TOY_GRAD_RL2 = 1e-3
TOY_GRAD_FLOOR = 10.0
KINK_RTOL = 1e-5
INPUT_NOISE = 1e-7


class KinkSides:
    """The side of each kink of a toy step's math: of zero for each ReLU
    input, and of the integers for each DCN offset (the bilinear tent's
    derivative is 0 at an integer and the difference of the two corners
    between two). ``patched(follow=False)`` keeps every such input of one
    run; ``patched(follow=True)`` runs the step again with each input put
    on the kept run's side where the two differ by at most KINK_RTOL of the
    input's largest magnitude (both sides are then right within rounding,
    and the derivative differs); a side that differs by more raises.
    ``moved`` counts the inputs moved."""

    def __init__(self):
        self.kept, self.moved = [], 0

    def _pin(self, x, follow, kept, side):
        import torch
        if not follow:
            self.kept.append(x.detach().cpu().clone())
            return x
        ref = next(kept, None)
        if ref is None or ref.shape != x.shape:
            raise RuntimeError('toy train: the runs meet other kinks')
        ref = ref.to(x.device)
        flip = side(x.detach()) != side(ref)
        if flip.any():
            gap = (x.detach() - ref).abs()[flip].max()
            if gap > KINK_RTOL * x.detach().abs().max():
                raise RuntimeError(f'toy train: an input lies on the other '
                                   f'side of a kink by {gap}')
            self.moved += int(flip.sum())
            # the kept value where the sides differ; the gradient still
            # flows to x
            x = x + torch.where(flip, ref - x.detach(), 0.0)
        return x

    @contextlib.contextmanager
    def patched(self, follow: bool):
        import torch
        import torch.nn.functional as F
        import dynamask_torch.models.dynamask_head as head
        relu, dcn, kept = F.relu, head.deform_conv2d_nhwc, iter(self.kept)

        def offset_side(o):
            f = torch.floor(o)
            return 2 * f + (o != f)

        def pinned_relu(x, inplace=False):
            return relu(self._pin(x, follow, kept, lambda t: t > 0),
                        inplace=inplace)

        def pinned_dcn(x, offsets, *args):
            return dcn(x, self._pin(offsets, follow, kept, offset_side),
                       *args)

        F.relu, head.deform_conv2d_nhwc = pinned_relu, pinned_dcn
        try:
            yield
        finally:
            F.relu, head.deform_conv2d_nhwc = relu, dcn


def toy_train_case():
    """The toy training step's inputs: the model on the CPU in training
    mode (one DCN offset conv off zero, so K3's offset gradient is exercised
    too), the same weights on the GPU, a synthetic batch of 2 images at
    128x128, the same batch with its image perturbed by INPUT_NOISE
    (relative), and the random draws (sampler priorities, Gumbel
    uniforms)."""
    import numpy as np
    import torch
    from dynamask_torch.apis import synthetic_batch
    from dynamask_torch.models import build_detector
    cfg = toy_cfg()
    b, hw, max_gts = 2, 128, 4
    ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                         device='cpu', seed=0).train()
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if 'conv_offset' in name:
                p.copy_(torch.randn(p.shape, generator=torch.Generator(
                ).manual_seed(2)) * 0.05)
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           device=DEVICE).train()
    model.load_state_dict(ref.state_dict())
    batch = synthetic_batch(3, b=b, h=hw, w=hw, num_gts=3, max_gts=max_gts,
                            crop_size=32, num_classes=8, device='cpu')
    noisy = dict(batch, image=batch['image'] * (1 + INPUT_NOISE * torch.randn(
        batch['image'].shape, generator=torch.Generator().manual_seed(5))))
    rng = np.random.RandomState(4)
    n_anchors = 3 * sum((hw // s) ** 2 for s in (4, 8, 16, 32, 64))
    max_pos = int(cfg.train_cfg.rcnn.sampler.num *
                  cfg.train_cfg.rcnn.sampler.pos_fraction)
    noise = {'rpn': rng.uniform(size=(b, n_anchors)),
             'rcnn': rng.uniform(size=(
                 b, max_gts + cfg.train_cfg.rpn_proposal.max_num)),
             'gumbel': rng.uniform(1e-4, 1 - 1e-4, (b * max_pos, 4))}
    noise = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in noise.items()}
    return ref, model, batch, noisy, noise


def toy_train_step(net, data, noise, proposals=None):
    """``forward_train`` and the backward pass of ``net`` on ``data``:
    (losses, per trainable parameter its gradient as float64 on the CPU,
    the RPN proposals). Given ``proposals``, the step takes them in place of
    its own: near-tied RPN scores, ordered differently by two devices'
    summation orders, would otherwise change which RoIs are sampled. The
    caller may pin the sides of its kinks (:class:`KinkSides`)."""
    import torch
    import dynamask_torch.models.detectors as detectors
    from dynamask_torch.models.detectors import parse_losses
    dev = net.device
    orig = detectors.rpn_get_proposals
    taken = []

    def hook(*a, **k):
        if proposals is None:
            taken.append(orig(*a, **k))
            return taken[-1]
        return type(proposals)(*[t.to(dev) for t in proposals])

    net.zero_grad(set_to_none=True)
    detectors.rpn_get_proposals = hook
    try:
        total, log = parse_losses(net.forward_train(
            {k: v.to(dev) for k, v in data.items()},
            {k: v.to(dev) for k, v in noise.items()}))
        total.backward()
    finally:
        detectors.rpn_get_proposals = orig
    logs = {k: float(v.detach()) for k, v in log.items()}
    grads = {k: (p.grad.detach().cpu().double() if p.grad is not None
                 else torch.zeros(p.shape, dtype=torch.float64))
             for k, p in net.named_parameters() if p.requires_grad}
    return logs, grads, proposals if proposals is not None else taken[-1]


def check_toy_train_against_cpu(report):
    """Phase 3b: one training step of the toy model, GPU (with and without
    cuDNN's convs) against CPU: the same weights, batch, random draws and
    proposals (the first GPU run's)."""
    import torch
    ref, model, batch, noisy, noise = toy_train_case()
    logs, grads, moved = {}, {}, {}
    sides = KinkSides()
    with sides.patched(follow=False):
        logs['gpu'], grads['gpu'], props = toy_train_step(model, batch, noise)
    for run, net, data in (('gpu_no_cudnn', model, batch),
                           ('cpu', ref, batch), ('cpu_noisy', ref, noisy)):
        sides.moved = 0
        torch.backends.cudnn.enabled = run != 'gpu_no_cudnn'
        try:
            with sides.patched(follow=True):
                logs[run], grads[run], _ = toy_train_step(net, data, noise,
                                                          props)
        finally:
            torch.backends.cudnn.enabled = True
        moved[run] = sides.moved

    def rel_l2(a, g):
        return ((a - g).norm() / g.norm()).item()

    tol = TOY_GRAD_RL2
    print(f'  toy train step, CPU losses: {logs["cpu"]}; ReLU inputs and '
          f'DCN offsets put on the GPU run\'s side of a kink: {moved}')
    report['toy_train'] = {'losses_cpu': logs['cpu'],
                           'kink_inputs_moved': moved}
    for run in ('gpu', 'gpu_no_cudnn'):
        worst_loss = max(abs(logs[run][k] - v) / max(abs(v), 1e-6)
                         for k, v in logs['cpu'].items())
        rows = []
        for k, g in grads['cpu'].items():
            a = grads[run][k]
            if not g.any():     # frozen stem and stage 1, unused parameters
                if a.any():
                    raise RuntimeError(f'toy train ({run}): {k} has a '
                                       'gradient on the GPU, none on the CPU')
                continue
            d = rel_l2(a, g)
            floor = rel_l2(grads['cpu_noisy'][k], g)
            rows.append((d / max(tol, TOY_GRAD_FLOOR * floor), d, floor, k))
        rows.sort(reverse=True)
        worst = [dict(param=k, rel_l2=d, cpu_noise_rel_l2=f)
                 for _, d, f, k in rows[:3]]
        print(f'  {run} vs CPU: worst loss rel err {worst_loss:.3e} (tol '
              f'{TOY_LOSS_RTOL}); gradient rel-L2 over {len(rows)} '
              f'parameters, the three nearest their tolerance (max({tol}, '
              f'{TOY_GRAD_FLOOR} x CPU noise)): ' + ', '.join(
                  f'{w["param"]} {w["rel_l2"]:.2e} (noise '
                  f'{w["cpu_noise_rel_l2"]:.1e})' for w in worst))
        report['toy_train'][run] = dict(
            losses=logs[run], worst_loss_rel=worst_loss, worst_grads=worst,
            params_compared=len(rows))
        if not (worst_loss <= TOY_LOSS_RTOL and rows[0][0] <= 1.0 and
                len(rows) > 50):
            raise RuntimeError(f'toy train step ({run}): GPU disagrees with '
                               'the CPU')


# -- phases 4 and 5: the flagship ---------------------------------------------

def check_launches(path, launches, names):
    print(f'  {path}: kernel launches: {launches}')
    for name in names:
        if launches[name] <= 0:
            raise RuntimeError(f'{name} was not launched on the {path} path')


def run_inference_path(report, card):
    """Phase 4: flagship inference, both modes, counters around each."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import inference_detector, init_detector
    t0 = time.perf_counter()
    model = init_detector(FLAGSHIP, device=DEVICE, seed=0, init_std=0.05)
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
        check_launches(mode, launches[mode],
                       ('deform_im2col_windowed', 'roi_align_fwd'))

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
    del model, outs
    return launches


def run_train_path(report, card):
    """Phase 5: flagship training through ``train_detector``, one call per
    step on the host batch, counters around the whole drive."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (init_trainer, synthetic_batch,
                                     train_detector)
    t0 = time.perf_counter()
    model, opt = init_trainer(FLAGSHIP, steps_per_epoch=COCO_STEPS_PER_EPOCH,
                              device=DEVICE, seed=0)
    h, w = IMAGE_HW
    # on the host, as a loader hands it over: train_detector moves it
    batch = synthetic_batch(0, b=TRAIN_IMAGES, h=h, w=w, num_gts=TRAIN_GTS,
                            crop_size=128,
                            num_classes=model.roi_head.num_classes,
                            device='cpu')
    print(f'  trainer built in {time.perf_counter() - t0:.1f} s: '
          f'{sum(p.numel() for p in opt.params) / 1e6:.1f} M trainable of '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params; '
          f'batch {TRAIN_IMAGES}x{h}x{w}, {TRAIN_GTS} GTs per image')
    offsets = {k: p for k, p in model.named_parameters()
               if 'conv_offset' in k}
    if not offsets or any(p.abs().max() != 0 for p in offsets.values()):
        raise RuntimeError('the DCN offset convs must start at zero')
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize(DEVICE)
    torch.cuda.reset_peak_memory_stats(DEVICE)
    ops.reset_kernel_launches()
    logs, times = [], []
    for i in range(1 + TIMED_STEPS):
        t = time.perf_counter()
        log, = train_detector(model, opt, [batch], generator=gen)
        torch.cuda.synchronize(DEVICE)
        times.append(1e3 * (time.perf_counter() - t))
        log = {k: float(v) for k, v in log.items()}
        logs.append(log)
        bad = [k for k, v in log.items() if v != v or abs(v) == float('inf')]
        bad += [k for k, p in model.named_parameters() if p.grad is not None
                and not torch.isfinite(p.grad).all()]
        if bad:
            raise RuntimeError(f'train step {i}: non-finite {bad}')
        if i == 0:
            # the JAX tent derivative: zero offsets get exactly zero gradient
            moved = [k for k, p in offsets.items()
                     if p.grad is None or p.grad.abs().max() != 0]
            if moved:
                raise RuntimeError(f'step 0: conv_offset gradients not '
                                   f'exactly 0: {moved}')
        print(f'  step {i}{" (warm-up)" if i == 0 else ""}: '
              f'{times[-1]:.1f} ms [{card}], ' + ', '.join(
                  f'{k} {v:.5g}' for k, v in log.items()))
    launches = ops.kernel_launches()
    check_launches('train', launches, ops.KERNELS)
    peak = torch.cuda.max_memory_allocated(DEVICE)
    ms = statistics.median(times[1:])
    still_zero = all(p.abs().max() == 0 for p in offsets.values())
    print(f'  train: {ms:.1f} ms/step (median of {TIMED_STEPS}, after 1 '
          f'warm-up), {1e3 * TRAIN_IMAGES / ms:.2f} img/s, peak memory '
          f'{peak / 2 ** 30:.2f} GiB [{card}]; conv_offset gradients exactly '
          f'0 at step 0, offsets still all zero after {1 + TIMED_STEPS} '
          f'steps: {still_zero}')
    report['train'] = dict(ms_per_step=ms, times_ms=times,
                           img_per_s=1e3 * TRAIN_IMAGES / ms,
                           peak_memory_bytes=peak, losses=logs,
                           launches=launches, steps=1 + TIMED_STEPS,
                           offsets_still_zero=still_zero)
    del model, opt, batch
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on a GPU',
              file=sys.stderr)
        return 2
    import dynamask_torch.ops as ops
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
    check_toy_train_against_cpu(report)
    print(f'phase 4: flagship inference [{card}]')
    launches = run_inference_path(report, card)
    torch.cuda.empty_cache()
    print(f'phase 5: flagship training [{card}]')
    launches['train'] = run_train_path(report, card)
    for row in rows:   # each path's count from its own zeroed drive
        by_path = {path: n[row['name']] for path, n in launches.items()}
        row['launches'] = sum(by_path.values())
        row['launches_by_path'] = by_path
    assert set(r['name'] for r in rows) == set(ops.KERNELS)
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
