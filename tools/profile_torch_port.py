#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's flagship on one GPU.

    python3 tools/profile_torch_port.py [--iters 5] [--train] [--bf16]
                                        [--config CFG] [--cudnn-benchmark]

Without ``--train``: builds DynaMask R50-FPN (``configs/dynamask/coco/
r50_dynamask_1x.py``, or ``--config``) with random N(0, 0.05) weights from
seed 0, as ``chip_smoke.py`` does, and runs one fp32 image at the first
canvas of the config's test set (800x1344 for COCO) through
``simple_test`` + mask paste in the faithful and the MSM-routed mode (the
one mode of Mask R-CNN's FCN mask head, ``fcn``, of RefineMask,
``refine``, of Cascade R-CNN and HTC, ``cascade``, or of a single-stage
detector (RetinaNet, ATSS, FCOS), ``dense``; an HTC step's batch carries
``gt_semantic_seg``). With ``--train``: builds the trainer
from the same config (its own seeded initialisation) and runs training
steps on a seeded synthetic batch of the config's ``samples_per_gpu``
images at the first canvas of its train set, 20 GTs each (and
RefineMask's ``gt_semantic``), as ``chip_smoke.py`` phases 5, 8 and 10
do (``apis.config_shapes``).
``--bf16`` runs the mixed-precision policy instead, as ``chip_smoke.py``
phase 9 does: inference through ``apis.make_test_fn(..., bf16=True)`` (a
bf16 copy of the model on a bf16 image; the paste opens the same ``paste``
range), training steps with ``compute_dtype=torch.bfloat16``.
For each mode it reports

* from a ``torch.profiler`` trace of whole iterations: each stage's host
  time and the device time of the kernels it launched, read from the
  ``record_function`` ranges that the real entry points open: at inference
  ``MaskRCNN.simple_test``, the RoI head and ``inference_detector``
  (backbone, fpn, rpn_and_proposals, box_head_and_nms, mask_branch, paste;
  Grid R-CNN's grid_branch, Mask Scoring R-CNN's mask_iou_branch);
  in training ``make_train_step`` (forward_train, backward, optimizer),
  ``MaskRCNN.forward_train`` (backbone, fpn, rpn_loss, proposals) and the
  RoI head (box_branch, mask_branch, Grid R-CNN's grid_branch); a single-stage detector's are
  backbone, fpn (the neck), head, and get_dets at inference or loss in
  training (``SingleStageDetector``, ``ATSS``, ``FCOS``). The backward
  pass runs its kernels
  from autograd's own thread, so its device time is also given as the
  step's kernel time less that of forward_train and optimizer;
* device time per kernel name (the 30 largest, and every one of the
  port's own kernels K1-K5), the number of kernel launches, the port's
  kernels' launches per iteration from their own counters (RefineMask: K2
  8 an image, K2 and K4 8 a step), and the device's busy share (kernel
  time over wall time). Fill kernels (``FillFunctor``: K4's zero fill of
  its fp32 gradient buffer among them) are summed on a line of their
  own.

Prints a summary and writes ``chiprun_out/profile_torch_port.json``
(``profile_torch_port_<config name>.json`` for another config, with
``_train`` appended under ``--train``, ``_bf16`` under ``--bf16`` and
``_cudnn_benchmark`` under ``--cudnn-benchmark``, which lets cuDNN time
its algorithms for each conv shape in place of its heuristic's pick).
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FLAGSHIP = os.path.join(ROOT, 'configs/dynamask/coco/r50_dynamask_1x.py')
# DetectoRS' RFP neck adds its rounds' ranges after ``fpn``
# (``models/necks_extra.py``): ASPP and the backbone pass, pyramid and gate
RFP_STAGES = ('rfp_backbone', 'rfp_neck')
# Grid R-CNN's grid head and Mask Scoring R-CNN's rescoring open their own
# (``models/grid_rcnn.py``, ``mask_scoring.py``)
STAGES = ('backbone', 'fpn', *RFP_STAGES, 'rpn_and_proposals',
          'box_head_and_nms', 'mask_branch', 'grid_branch', 'mask_iou_branch',
          'paste')
TRAIN_STAGES = ('forward_train', 'backbone', 'fpn', *RFP_STAGES, 'rpn_loss',
                'proposals', 'box_branch', 'mask_branch', 'grid_branch',
                'backward', 'optimizer')
# a single-stage detector's ranges (``models/single_stage.py``, ``atss.py``,
# ``fcos.py``): the backbone, the neck (``fpn``), the dense head, then the
# dense targets and losses or the decode and NMS
DENSE_STAGES = ('backbone', 'fpn', 'head', 'get_dets', 'paste')
DENSE_TRAIN_STAGES = ('forward_train', 'backbone', 'fpn', 'head', 'loss',
                      'backward', 'optimizer')


def _device_us(e) -> float:
    """Device time of the kernels launched under a host event."""
    if hasattr(e, 'device_time_total'):
        return e.device_time_total
    return e.cuda_time_total        # PyTorch before 2.4


def _stage_times(prof, stages):
    """{stage: {'host_ms', 'device_ms'}} medians over the trace's
    iterations, from the host-side record_function ranges."""
    per = {k: {'host_ms': [], 'device_ms': []} for k in stages}
    for e in prof.events():
        if e.name in per and e.device_type.name == 'CPU':
            per[e.name]['host_ms'].append(e.cpu_time_total / 1e3)
            per[e.name]['device_ms'].append(_device_us(e) / 1e3)
    return {k: {m: statistics.median(v) for m, v in d.items()}
            for k, d in per.items() if d['host_ms']}


def _profile(run, iters, stages):
    """Kernel table and device busy share over ``iters`` calls of ``run``,
    and the port's kernel launches per call from their counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import dynamask_torch.ops as ops
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / iters
    counted = {k: n / iters for k, n in ops.kernel_launches().items() if n}
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0))
        # the stage ranges' device-side spans are not kernels
        if (dev_us > 0 and e.device_type.name == 'CUDA' and
                e.key not in stages):
            rows.append({'name': e.key, 'ms_per_iter': dev_us / 1e3 / iters,
                         'launches_per_iter': e.count / iters})
    rows.sort(key=lambda r: -r['ms_per_iter'])
    busy = sum(r['ms_per_iter'] for r in rows)
    return {'wall_ms_per_iter': wall_ms, 'device_ms_per_iter': busy,
            'device_busy_share': busy / wall_ms,
            'kernel_launches_per_iter': sum(r['launches_per_iter']
                                            for r in rows),
            'stages': _stage_times(prof, stages), 'kernels': rows[:30],
            'port_launches_per_iter': counted,
            'fill_kernels': [r for r in rows if 'FillFunctor' in r['name']],
            'port_kernels': [r for r in rows if _is_port_kernel(r['name'])]}


def _is_port_kernel(name: str) -> bool:
    """Whether a kernel is one of the port's own (csrc/*.cu)."""
    return any(k in name for k in ('deform_im2col', 'deform_col2im',
                                   'roi_align', 'deform_conv_fused'))


def _summary(mode, prof, card, unit):
    print(f'{mode} [{card}]: wall {prof["wall_ms_per_iter"]:.2f} ms/{unit} '
          f'(profiled), device busy {prof["device_ms_per_iter"]:.2f} ms '
          f'({100 * prof["device_busy_share"]:.1f}%), '
          f'{prof["kernel_launches_per_iter"]:.0f} kernel launches/{unit}')
    print('  stages, median ms host / device: ' + ', '.join(
        f'{k} {v["host_ms"]:.3f} / {v["device_ms"]:.3f}'
        for k, v in prof['stages'].items()))
    for r in prof['kernels'][:12]:
        print(f'  {r["ms_per_iter"]:8.3f} ms x{r["launches_per_iter"]:5.0f}'
              f'  {r["name"][:100]}')
    print('  the port\'s own kernels (launches per '
          f'{unit} by their counters: {prof["port_launches_per_iter"]}):')
    for r in prof['port_kernels']:
        print(f'  {r["ms_per_iter"]:8.3f} ms x{r["launches_per_iter"]:5.0f}'
              f'  {r["name"][:100]}')
    fills = prof['fill_kernels']
    print(f'  zero and constant fills (K4\'s fp32 gradient buffers among '
          f'them): {sum(r["ms_per_iter"] for r in fills):.3f} ms in '
          f'{sum(r["launches_per_iter"] for r in fills):.0f} launches')


def _inference(config, card, iters, hw, batch_size, bf16=False):
    import torch
    from dynamask_torch.apis import (inference_detector, init_detector,
                                     make_test_fn)
    from dynamask_torch.models.cascade_roi_head import CascadeRoIHead
    from dynamask_torch.models.refine_mask_head import RefineRoIHead
    model = init_detector(config, seed=0, init_std=0.05)
    gen = torch.Generator(device='cuda').manual_seed(0)
    h, w = hw
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device='cuda'),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device='cuda'),
             'scale_factor': torch.ones(1, 4, device='cuda')}
    modes = {}
    rh = getattr(model, 'roi_head', None)
    dynamask = hasattr(rh, 'dynamic_inference')
    one = ('dense' if rh is None else
           'refine' if isinstance(rh, RefineRoIHead) else
           'cascade' if isinstance(rh, CascadeRoIHead) else 'fcn')
    stages = DENSE_STAGES if rh is None else STAGES
    for mode, dynamic in ((('faithful', False), ('dynamic', True))
                          if dynamask else ((one, None),)):
        if dynamask:
            model.roi_head.dynamic_inference = dynamic
        run = (functools.partial(make_test_fn(model, hw, bf16=True), batch)
               if bf16 else functools.partial(inference_detector, model,
                                              batch))
        for _ in range(2):
            run()
        modes[mode] = _profile(run, iters, stages)
        _summary(mode, modes[mode], card, 'img')
    return modes


def _train(config, card, iters, hw, batch_size, bf16=False):
    import torch
    from dynamask_torch.apis import (init_trainer, semantic_seg_shape,
                                     synthetic_batch)
    from dynamask_torch.engine import make_train_step
    # an epoch of COCO train2017 (117266 annotated images) at 4 per step
    model, opt = init_trainer(config, steps_per_epoch=117266 // 4, seed=0)
    h, w = hw
    rh = getattr(model, 'roi_head', None)
    batch = synthetic_batch(0, b=batch_size, h=h, w=w, num_gts=20,
                            crop_size=128,
                            num_classes=(model.num_classes if rh is None
                                         else rh.num_classes),
                            device='cuda',
                            with_semantic=getattr(rh, 'with_semantic',
                                                  False),
                            semantic_seg=semantic_seg_shape(model))
    step = make_train_step(model, opt, torch.bfloat16 if bf16 else None)
    gen = torch.Generator(device='cuda').manual_seed(0)
    for _ in range(2):
        step(batch, generator=gen)
    prof = _profile(lambda: step(batch, generator=gen), iters,
                    DENSE_TRAIN_STAGES if rh is None else TRAIN_STAGES)
    st = prof['stages']
    prof['backward_device_ms_by_difference'] = (
        prof['device_ms_per_iter'] - st['forward_train']['device_ms'] -
        st['optimizer']['device_ms'])
    _summary('train', prof, card, 'step')
    print(f'  backward: {prof["backward_device_ms_by_difference"]:.3f} ms of '
          'device time (the step less forward_train and optimizer)')
    return {'train': prof}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--train', action='store_true',
                    help='profile training steps instead of inference')
    ap.add_argument('--config', default=FLAGSHIP,
                    help='the config file (default: the flagship)')
    ap.add_argument('--bf16', action='store_true',
                    help='bf16 compute (the core/fp16.py policy)')
    ap.add_argument('--cudnn-benchmark', action='store_true',
                    help="let cuDNN time its algorithms for each conv "
                    "shape (torch.backends.cudnn.benchmark) instead of "
                    "taking its heuristic's pick")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('profile_torch_port: needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    from dynamask_torch.apis import config_shapes
    test_hw, images, train_hw = config_shapes(args.config)
    run, hw, batch = ((_train, train_hw, images) if args.train
                      else (_inference, test_hw, 1))
    print(f'{os.path.relpath(args.config, ROOT)}, canvas {hw[0]}x{hw[1]}, '
          f'batch {batch}, {"bf16" if args.bf16 else "fp32"}' +
          (', cudnn.benchmark' if args.cudnn_benchmark else ''))
    report = {'card': card, 'config': args.config, 'canvas': hw,
              'batch': batch, 'bf16': args.bf16,
              'cudnn_benchmark': args.cudnn_benchmark,
              'modes': run(args.config, card, args.iters, hw, batch,
                           args.bf16)}
    name = os.path.splitext(os.path.basename(args.config))[0]
    suffix = '' if os.path.abspath(args.config) == FLAGSHIP else f'_{name}'
    suffix += ('_train' if args.train else '') + ('_bf16' if args.bf16
                                                   else '')
    suffix += '_cudnn_benchmark' if args.cudnn_benchmark else ''
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out',
                           f'profile_torch_port{suffix}.json'), 'w') as f:
        json.dump(report, f, indent=1)


if __name__ == '__main__':
    main()
