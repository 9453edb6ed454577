"""The test loop (port of ``dynamask_tpu/apis/test.py``): the device-side
det -> canvas mask epilogue, the dataset loop that feeds
``CocoDataset.evaluate``, and ``run_eval``. The forward, the NMS and the
mask paste run on the device; the masks come to the host once per image,
and RLE encoding and COCO matching stay on the host."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.paste import paste_masks

# the batch keys simple_test reads
TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor')


def paste_epilogue(out: Dict, ch: int, cw: int, mask_thr: float) -> Dict:
    """Paste each det's mask probabilities onto a (ch, cw) canvas and
    threshold them on the device -> dets, labels, valid, masks
    (B, D, ch, cw) bool."""
    b, d = out['dets'].shape[:2]
    probs = out['mask_probs']
    boxes = out['dets'][..., :4].reshape(b * d, 4)
    pasted = paste_masks(probs.reshape(b * d, *probs.shape[2:]), boxes, ch, cw)
    masks = (pasted >= mask_thr).reshape(b, d, ch, cw)
    return {'dets': out['dets'], 'labels': out['labels'],
            'valid': out['det_valid'], 'masks': masks}


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
    in original image coordinates, 'labels', 'valid', and 'masks', D bool
    (h, w) masks pasted on the dataset's mask canvas in original-image
    coordinates and cropped to the image. An image the sampler repeats to
    fill a batch is kept once.

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
        with torch.no_grad():
            out = paste_epilogue(
                model.simple_test({k: batch[k].to(dev) for k in TEST_KEYS}),
                ch, cw, mask_thr)
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
            oh, ow = ori[i]
            # one copy per image, (D, w, h): each det's mask is then a
            # column-major (h, w) view, the order the RLE codec reads
            masks = out['masks'][i, :, :oh, :ow].transpose(1, 2) \
                .contiguous().cpu().numpy()
            results.append({'img_id': img_id, 'dets': dets[i],
                            'labels': labels[i], 'valid': valid[i],
                            'masks': [m.T for m in masks]})
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
