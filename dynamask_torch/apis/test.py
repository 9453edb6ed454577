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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def first_of_each(max_images: Optional[int] = None) -> Callable[[int], bool]:
    """``take(img_id)``: True the first time an image comes, while fewer
    than ``max_images`` are taken; an image the sampler repeats to fill a
    batch is taken once."""
    seen = set()

    def take(img_id: int) -> bool:
        if img_id in seen or (max_images is not None and
                              len(seen) >= max_images):
            return False
        seen.add(img_id)
        return True

    return take


def batch_results(out: Dict, batch: Dict, proposals: bool,
                  take: Callable[[int], bool]) -> List[Dict]:
    """The result dicts of one batch's images that ``take(img_id)`` keeps,
    in the batch's order, from the test step's padded outputs ``out``
    (:func:`single_device_test` says what they hold); the masks of the
    others are not copied to the host."""
    dets, labels, valid = (out[k].cpu().numpy()
                           for k in ('dets', 'labels', 'valid'))
    ori = batch['ori_shape'].long().tolist()
    results = []
    for i, img_id in enumerate(batch['img_id'].tolist()):
        if not take(img_id):
            continue
        res = {'img_id': img_id, 'dets': dets[i], 'labels': labels[i],
               'valid': valid[i]}
        if 'masks' in out:
            res['masks'] = fetch_masks(out['masks'][i], ori[i])
        if proposals:
            res['proposals'] = dets[i][valid[i]]
        results.append(res)
    return results


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
    take = first_of_each(max_images)
    clock = dict(startup=0.0, pipeline=0.0, device=0.0, fetch=0.0)
    results: List[Dict] = []
    t_start = time.perf_counter()
    batches = iter(loader)
    while max_images is None or len(results) < max_images:
        t = time.perf_counter()
        batch = next(batches, None)
        clock['pipeline' if results else 'startup'] += time.perf_counter() - t
        if batch is None:
            break
        t = time.perf_counter()
        out = step(simple_test_inputs(batch))
        if timings is not None and dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        clock['device'] += time.perf_counter() - t
        t = time.perf_counter()
        results += batch_results(out, batch, proposals, take)
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


def multi_device_test(model: torch.nn.Module, dataset,
                      samples_per_device: int = 1,
                      mask_canvas: Optional[Tuple[int, int]] = None,
                      mask_thr: float = 0.5,
                      max_images: Optional[int] = None,
                      workers_per_gpu: int = 4, progress: bool = False,
                      group=None) -> List[Dict]:
    """The data-parallel test loop (port of ``multi_device_test``,
    ``dynamask_tpu/apis/test.py:227-316``; reference multi_gpu_test), run
    by every rank of ``group`` (default: the default process group) with
    its copy of the model. Each rank loads its share of each global batch
    of ``samples_per_device`` x world size images
    (``build_dataloader(num_shards=, shard_index=)``; the sampler wraps
    the last batch of each orientation group around to fill it) and runs
    :func:`make_test_fn` on it; the batch's per-image results are gathered
    to every rank (``all_gather_object``) and put back in the global
    batch's order, rank ``r``'s ``j``-th image at ``r + W * j``; repeats
    are dropped by ``img_id``. So every rank returns
    :func:`single_device_test`'s results, in its order."""
    import torch.distributed as dist
    from ..data import build_dataloader
    group = group or dist.group.WORLD
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    ch, cw = mask_canvas or dataset_mask_canvas(dataset)
    loader = build_dataloader(dataset, samples_per_gpu=samples_per_device,
                              workers_per_gpu=workers_per_gpu, shuffle=False,
                              drop_last=False, num_shards=world,
                              shard_index=rank)
    step = make_test_fn(model, (ch, cw), mask_thr)
    proposals = is_proposal_model(model)
    take = first_of_each(max_images)
    results: List[Dict] = []
    t_start = time.perf_counter()
    # every rank has the same number of batches and, after each gather,
    # the same results: the ranks leave the loop together
    for batch in loader:
        if max_images is not None and len(results) >= max_images:
            break
        out = step(simple_test_inputs(batch))
        local = batch_results(out, batch, proposals, lambda _: True)
        gathered = [None] * world
        dist.all_gather_object(gathered, local, group=group)
        results += [res for j in range(samples_per_device)
                    for res in (part[j] for part in gathered)
                    if take(res['img_id'])]
        if progress and rank == 0 and len(results) % 50 == 0:
            fps = len(results) / max(time.perf_counter() - t_start, 1e-6)
            print(f'\r{len(results)} imgs, {fps:.1f} img/s', end='',
                  flush=True)
    if progress and rank == 0:
        print()
    return results


def fetch_masks(masks: torch.Tensor, ori_hw) -> List[np.ndarray]:
    """One image's (D, ch, cw) bool masks cropped to its original (h, w)
    and copied to the host once, (D, w, h): each det's mask is then a
    column-major (h, w) view, the order the RLE codec reads."""
    oh, ow = ori_hw
    host = masks[:, :oh, :ow].transpose(1, 2).contiguous().cpu().numpy()
    return [m.T for m in host]


def check_aug_test(model: torch.nn.Module) -> None:
    """Raise ``NotImplementedError``, naming why, where the JAX package
    cannot augment ``model``: a detector without ``aug_test`` (the
    single-stage ones, ``RPN``, ``FastRCNN``, guided anchoring's), or an
    RoI head its ``aug_test`` fails on (``StandardRoIHead.
    check_aug_test``)."""
    if not hasattr(model, 'aug_test'):
        raise NotImplementedError(
            f'{type(model).__name__} has no test-time augmentation, as in '
            f'the JAX package (aug_test is the two-stage detectors\')')
    model.roi_head.check_aug_test()


def tta_specs(scales: Optional[Sequence[Tuple[int, int]]], flip: bool
              ) -> List[Tuple[Optional[Tuple[int, int]], bool]]:
    """The (scale, flip) of each augmentation: every scale (None: the
    pipeline's own ``Resize``) unflipped, then flipped where ``flip``."""
    return [(s, f) for s in ([tuple(s) for s in scales] if scales else
                             [None])
            for f in ([False, True] if flip else [False])]


def tta_pipelines(dataset, specs) -> List[List]:
    """Each augmentation's pipeline: the dataset's own, its ``Resize``
    swapped for ``Resize(img_scale=s, keep_ratio=<the original's>)`` where
    the augmentation has a scale."""
    from ..data.transforms import Resize
    return [[Resize(img_scale=s, keep_ratio=t.keep_ratio)
             if s is not None and isinstance(t, Resize) else t
             for t in dataset.pipeline.transforms] for s, _ in specs]


def tta_samples(dataset, idx: int, specs, pipes) -> List[Dict]:
    """Image ``idx`` through each augmentation's pipeline from a fresh
    ``pre_pipeline(idx)``: flipped in its resized region after the
    pipeline where the augmentation flips (the region is where ``Pad``
    put it, so this is the flip before ``Pad``), then ``format_sample``
    onto the dataset's canvases (``ValueError`` where none fits)."""
    from ..data.formatting import format_sample
    samples = []
    for (_, f), ts in zip(specs, pipes):
        r = dataset.pre_pipeline(idx)
        for t in ts:
            r = t(r)
        if f:
            fh, fw = (np.asarray(r['img_shape'][:2]).astype(int)
                      if 'img_shape' in r else r['img'].shape[:2])
            r['img'] = np.ascontiguousarray(r['img'])
            r['img'][:fh, :fw] = r['img'][:fh, :fw][:, ::-1]
            r['flip'] = True
        samples.append(format_sample(
            r, dataset.canvases, dataset.max_gts, dataset.mask_crop_size,
            with_semantic=getattr(dataset, 'with_semantic', False),
            max_proposals=getattr(dataset, 'max_proposals', 1000)))
    return samples


def aug_device_test(model: torch.nn.Module, dataset,
                    scales: Optional[Sequence[Tuple[int, int]]] = None,
                    flip: bool = True,
                    mask_canvas: Optional[Tuple[int, int]] = None,
                    mask_thr: float = 0.5,
                    max_images: Optional[int] = None,
                    bf16: bool = False, progress: bool = True,
                    timings: Optional[Dict[str, float]] = None
                    ) -> List[Dict]:
    """The test-time augmentation loop (port of ``aug_device_test``,
    ``dynamask_tpu/apis/test.py:124-224``), the eval CLI's ``--tta``: one
    image at a time, in this process. Each (scale, flip) of
    :func:`tta_specs` runs the dataset's pipeline with its scale
    (:func:`tta_pipelines`, :func:`tta_samples`: a scale whose image fits
    no canvas raises ``ValueError``, as in JAX); the model's ``aug_test``
    merges the augmentations, then the paste of :func:`paste_epilogue`.
    ``bf16`` as in :func:`make_test_fn`: a bf16 copy of the model on a
    bf16 image, the decode in fp32. Results as
    :func:`single_device_test`'s, in the dataset's order. A detector the
    JAX package cannot augment raises ``NotImplementedError``
    (:func:`check_aug_test`).

    ``timings``, given, receives the seconds of the pipelines
    ('pipeline'), of ``aug_test`` and the paste up to a device
    synchronise ('device') and of the copies to the host ('fetch')."""
    check_aug_test(model)
    ch, cw = mask_canvas or dataset_mask_canvas(dataset)
    specs = tta_specs(scales, flip)
    flips = [f for _, f in specs]
    pipes = tta_pipelines(dataset, specs)
    net = to_bf16(model) if bf16 else model
    dev = net.device
    clock = dict(pipeline=0.0, device=0.0, fetch=0.0)
    n = len(dataset) if max_images is None else min(len(dataset),
                                                    max_images)
    results: List[Dict] = []
    t_start = time.perf_counter()
    for idx in range(n):
        t = time.perf_counter()
        samples = tta_samples(dataset, idx, specs, pipes)
        batches = [{k: torch.from_numpy(s[k])[None].to(dev)
                    for k in ('image', 'img_shape', 'ori_shape',
                              'scale_factor')} for s in samples]
        if bf16:
            for b in batches:
                b['image'] = b['image'].to(torch.bfloat16)
        clock['pipeline'] += time.perf_counter() - t
        t = time.perf_counter()
        with torch.no_grad():
            out = paste_epilogue(net.aug_test(batches, flips), ch, cw,
                                 mask_thr)
        if timings is not None and dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        clock['device'] += time.perf_counter() - t
        t = time.perf_counter()
        res = {'img_id': dataset.sample_id(idx)}
        res.update({k: out[k][0].cpu().numpy()
                    for k in ('dets', 'labels', 'valid')})
        if 'masks' in out:
            res['masks'] = fetch_masks(
                out['masks'][0], samples[0]['ori_shape'].astype(int).tolist())
        results.append(res)
        clock['fetch'] += time.perf_counter() - t
        if progress and (idx + 1) % 20 == 0:
            fps = (idx + 1) / max(time.perf_counter() - t_start, 1e-6)
            print(f'\r{idx + 1} imgs (x{len(specs)} augs), {fps:.1f} img/s',
                  end='', flush=True)
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
             max_images: Optional[int] = None, device=None,
             fuse_conv_bn: bool = False, tta: bool = False,
             tta_scales: Optional[Sequence[Tuple[int, int]]] = None,
             group=None) -> Tuple[object, List[Dict]]:
    """Build the config's detector and test dataset and run the test loop
    with the config's loader workers -> (dataset, results). With
    ``fuse_conv_bn`` the detector's conv+BN pairs are folded first
    (``engine.fuse_conv_bn``; the count is printed); with ``tta`` the loop
    is :func:`aug_device_test` at ``tta_scales`` (None: the pipeline's
    own scale) with flips; else, given a process ``group``, the loop is
    :func:`multi_device_test` over its ranks (each calls ``run_test`` with
    its own ``device``)."""
    from ..data import build_dataset
    from .inference import init_detector
    model = init_detector(cfg, checkpoint, device=device)
    if tta:
        check_aug_test(model)
    if fuse_conv_bn:
        from ..engine.fuse import fuse_conv_bn as fuse
        model, n = fuse(model)
        print(f'fused {n} conv+bn pairs')
    data = model.cfg.data
    dataset = build_dataset(dict(data['test']),
                            default_args=dict(test_mode=True))
    if tta:
        return dataset, aug_device_test(model, dataset, scales=tta_scales,
                                        max_images=max_images)
    if group is not None:
        return dataset, multi_device_test(
            model, dataset, max_images=max_images,
            workers_per_gpu=data.get('workers_per_gpu', 4), group=group)
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
