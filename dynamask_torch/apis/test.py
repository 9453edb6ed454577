"""The test loop (port of ``dynamask_tpu/apis/test.py``): the device-side
det -> canvas mask epilogue, the dataset loop that feeds the dataset's
``evaluate``, and ``run_eval``. The forward, the NMS and the mask paste run
on the device; the masks come to the host once per image, and RLE encoding
and COCO matching stay on the host. A box-only detector (Faster and Fast
R-CNN, the single-stage detectors) skips the paste and gives boxes; an
``RPN`` gives its proposals (the JAX loop pastes always, so it has
neither)."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.fp16 import to_bf16
from ..ops.paste import paste_masks

# the batch keys simple_test reads (a Fast R-CNN batch's proposals among
# them)
TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor', 'proposals',
             'proposal_valid')


def simple_test_inputs(batch: Dict) -> Dict:
    """The keys of ``batch`` that ``simple_test`` reads."""
    return {k: batch[k] for k in TEST_KEYS if k in batch}


def is_proposal_model(model: torch.nn.Module) -> bool:
    """An ``RPN``: its results are proposals, not class dets (a two-stage
    detector has an RoI head, a single-stage one a ``bbox_head``)."""
    return not hasattr(model, 'roi_head') and not hasattr(model,
                                                          'bbox_head')


def paste_epilogue(out: Dict, ch: int, cw: int, mask_thr: float) -> Dict:
    """Paste each det's mask probabilities onto a (ch, cw) canvas and
    threshold them on the device -> dets, labels, valid, masks
    (B, D, ch, cw) bool; without mask probabilities (a box-only detector,
    an RPN) dets, labels, valid."""
    if 'mask_probs' not in out:
        return {'dets': out['dets'], 'labels': out['labels'],
                'valid': out['det_valid']}
    b, d = out['dets'].shape[:2]
    probs = out['mask_probs']
    boxes = out['dets'][..., :4].reshape(b * d, 4)
    pasted = paste_masks(probs.reshape(b * d, *probs.shape[2:]), boxes, ch, cw)
    masks = (pasted >= mask_thr).reshape(b, d, ch, cw)
    return {'dets': out['dets'], 'labels': out['labels'],
            'valid': out['det_valid'], 'masks': masks}


def make_test_fn(model: torch.nn.Module, mask_canvas: Tuple[int, int],
                 mask_thr: float = 0.5, bf16: bool = False) -> Callable:
    """The full test step (port of ``make_test_fn``,
    ``dynamask_tpu/apis/test.py:36-56``), the one every test and inference
    entry point runs: ``simple_test`` + the paste on the model's device.
    Returns ``fn(batch)`` -> dict of padded per-image results
    (:func:`paste_epilogue`), the masks (where the model has a mask head) a
    bool (B, D, canvas_h, canvas_w) tensor thresholded on the device, and
    in the MSM-routed mode the routing statistics under ``msm_routing``.

    With ``bf16=True`` a bf16 copy of the model (``core.fp16.to_bf16``:
    parameters and BatchNorm statistics) computes on a bf16 image; the box
    and score decode stay fp32 (the ``core/fp16.py`` policy). The model
    given is left as it was."""
    ch, cw = mask_canvas
    net = to_bf16(model) if bf16 else model
    dev = net.device

    def fn(batch: Dict[str, torch.Tensor]) -> Dict:
        batch = {k: v.to(dev) for k, v in batch.items()}
        if bf16:
            batch['image'] = batch['image'].to(torch.bfloat16)
        with torch.no_grad():
            out = net.simple_test(batch)
            with record_function('paste'):
                result = paste_epilogue(out, ch, cw, mask_thr)
        if 'msm_routing' in out:
            result['msm_routing'] = out['msm_routing']
        return result

    return fn


def dataset_mask_canvas(dataset, multiple: int = 32) -> Tuple[int, int]:
    """Smallest canvas covering every image's original shape, rounded up to
    ``multiple`` (a fixed canvas would cut larger images short)."""
    infos = getattr(dataset, 'img_infos', None)
    if not infos:
        return (640, 640)
    max_h = max(int(i['height']) for i in infos)
    max_w = max(int(i['width']) for i in infos)
    rnd = lambda v: int(-(-v // multiple) * multiple)  # noqa: E731
    return (rnd(max_h), rnd(max_w))


def single_device_test(model: torch.nn.Module, dataset,
                       samples_per_gpu: int = 1,
                       mask_canvas: Optional[Tuple[int, int]] = None,
                       mask_thr: float = 0.5,
                       max_images: Optional[int] = None,
                       workers_per_gpu: int = 4,
                       progress: bool = True,
                       timings: Optional[Dict[str, float]] = None
                       ) -> List[Dict]:
    """Run ``model`` over ``dataset`` -> one result dict per image for
    ``dataset.evaluate`` (reference single_gpu_test): numpy 'dets' (D, 5)
    in original image coordinates, 'labels', 'valid', and with a mask head
    'masks', D bool (h, w) masks pasted on the dataset's mask canvas in
    original-image coordinates and cropped to the image; for an ``RPN``
    also 'proposals', its valid (k, 5) proposals by score, as
    ``fast_eval_recall`` reads them. An image the sampler repeats to fill a
    batch is kept once.

    ``timings``, given, receives the seconds spent waiting on the loader
    for its first batch ('startup': worker start-up and that batch) and for
    the others ('pipeline': decode, transforms, collate), in
    ``simple_test`` and the paste up to a device synchronise ('device'),
    and copying the masks and dets to the host ('fetch')."""
    from ..data import build_dataloader
    ch, cw = mask_canvas or dataset_mask_canvas(dataset)
    loader = build_dataloader(dataset, samples_per_gpu=samples_per_gpu,
                              workers_per_gpu=workers_per_gpu, shuffle=False,
                              drop_last=False)
    dev = model.device
    step = make_test_fn(model, (ch, cw), mask_thr)
    proposals = is_proposal_model(model)
    clock = dict(startup=0.0, pipeline=0.0, device=0.0, fetch=0.0)
    results: List[Dict] = []
    seen = set()
    t_start = time.perf_counter()
    batches = iter(loader)
    while max_images is None or len(results) < max_images:
        t = time.perf_counter()
        batch = next(batches, None)
        clock['pipeline' if seen else 'startup'] += time.perf_counter() - t
        if batch is None:
            break
        t = time.perf_counter()
        out = step(simple_test_inputs(batch))
        if timings is not None and dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        clock['device'] += time.perf_counter() - t
        t = time.perf_counter()
        dets, labels, valid = (out[k].cpu().numpy()
                               for k in ('dets', 'labels', 'valid'))
        ori = batch['ori_shape'].long().tolist()
        for i, img_id in enumerate(batch['img_id'].tolist()):
            if img_id in seen or (max_images is not None and
                                  len(results) >= max_images):
                continue
            seen.add(img_id)
            res = {'img_id': img_id, 'dets': dets[i], 'labels': labels[i],
                   'valid': valid[i]}
            if 'masks' in out:
                oh, ow = ori[i]
                # one copy per image, (D, w, h): each det's mask is then a
                # column-major (h, w) view, the order the RLE codec reads
                masks = out['masks'][i, :, :oh, :ow].transpose(1, 2) \
                    .contiguous().cpu().numpy()
                res['masks'] = [m.T for m in masks]
            if proposals:
                res['proposals'] = dets[i][valid[i]]
            results.append(res)
        clock['fetch'] += time.perf_counter() - t
        if progress and len(results) % 50 == 0:
            fps = len(results) / max(time.perf_counter() - t_start, 1e-6)
            print(f'\r{len(results)} imgs, {fps:.1f} img/s', end='',
                  flush=True)
    if progress:
        print()
    if timings is not None:
        timings.update(clock)
    return results


def proposal_lists(results: List[Dict]) -> List:
    """An RPN's results as a ``proposal_file``'s list: per image its (k, 5)
    float32 proposals, in the results' order (the test set's, which the
    dataset reading the file must share)."""
    return [np.asarray(r['proposals'], np.float32) for r in results]


def run_test(cfg, checkpoint: Optional[str] = None,
             max_images: Optional[int] = None, device=None
             ) -> Tuple[object, List[Dict]]:
    """Build the config's detector and test dataset and run the test loop
    with the config's loader workers -> (dataset, results)."""
    from ..data import build_dataset
    from .inference import init_detector
    model = init_detector(cfg, checkpoint, device=device)
    data = model.cfg.data
    dataset = build_dataset(dict(data['test']),
                            default_args=dict(test_mode=True))
    return dataset, single_device_test(
        model, dataset, max_images=max_images,
        workers_per_gpu=data.get('workers_per_gpu', 4))


def run_eval(cfg, checkpoint: Optional[str] = None, metrics=('bbox',),
             max_images: Optional[int] = None, device=None,
             classwise: bool = False) -> Dict:
    """:func:`run_test`, then the dataset's metrics (the eval CLI's path)."""
    dataset, results = run_test(cfg, checkpoint, max_images, device)
    return dataset.evaluate(results, metric=list(metrics),
                            classwise=classwise)
