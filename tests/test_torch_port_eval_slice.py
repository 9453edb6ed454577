"""The COCO evaluation path on the CPU: image files -> the test pipeline ->
the loader -> ``simple_test`` + paste on the dataset's mask canvas -> RLE
-> the COCO evaluator, the port (``dynamask_torch.apis.single_device_test``
and ``CocoDataset.evaluate``) against the JAX package's, at the toy DynaMask
config (ResNet-18, 32-channel FPN, 8 classes) on a seeded COCO-format set of
4 images (120x160 and 160x120) resized onto 64x96 / 96x64 canvases.

Margins as in ``test_torch_port_slice.py``: valid detection scores are at
least 1e-4 apart (checked), so NMS order and the kept set are not decided
by fp32 rounding; mask pixels whose pasted probability lies within 1e-3 of
the 0.5 threshold are left out of the binary comparison (both sides' mask
probabilities agree to 2e-4, so a pixel where they threshold differently
lies in that band).
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402,F401

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import toy_pair  # noqa: E402

NUM_IMAGES = 4
CANVASES = [(64, 96), (96, 64)]
NORM = dict(type='Normalize', mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_rgb=True)
TEST_PIPELINE = [dict(type='LoadImageFromFile'),
                 dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
                 NORM, dict(type='Pad', size_divisor=32)]
TRAIN_PIPELINE = [dict(type='LoadImageFromFile'),
                  dict(type='LoadAnnotations', with_bbox=True,
                       with_mask=True),
                  dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
                  dict(type='RandomFlip', flip_ratio=0.5),
                  NORM, dict(type='Pad', size_divisor=32)]


def make_set(root, num_imgs=NUM_IMAGES, seed=0):
    """The recipe of ``tests/test_data.py:make_synthetic_coco`` over the toy
    model's 8 classes: noise images, 3 rectangle-polygon GTs each."""
    import cv2
    from dynamask_torch.data import COCO_CLASSES
    rng = np.random.RandomState(seed)
    images, anns = [], []
    img_dir = root / 'imgs'
    img_dir.mkdir(exist_ok=True)
    for i in range(num_imgs):
        h, w = (120, 160) if i % 2 == 0 else (160, 120)
        name = f'{i:04d}.jpg'
        cv2.imwrite(str(img_dir / name),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        images.append({'id': i + 1, 'file_name': name, 'width': w,
                       'height': h})
        for _ in range(3):
            x, y = rng.randint(0, w - 40), rng.randint(0, h - 40)
            bw, bh = (int(v) for v in rng.randint(15, 40, 2))
            poly = [x + 2, y + 2, x + bw - 2, y + 2, x + bw - 2, y + bh - 2,
                    x + 2, y + bh - 2]
            anns.append({'id': len(anns) + 1, 'image_id': i + 1,
                         'category_id': int(rng.randint(1, 9)),
                         'bbox': [float(x), float(y), float(bw), float(bh)],
                         'area': float(bw * bh), 'iscrowd': 0,
                         'segmentation': [[float(v) for v in poly]]})
    cats = [{'id': k + 1, 'name': n} for k, n in enumerate(COCO_CLASSES[:8])]
    ann_file = root / 'ann.json'
    ann_file.write_text(json.dumps({'images': images, 'annotations': anns,
                                    'categories': cats}))
    return str(ann_file), str(img_dir)


def data_cfg(ann_file, img_dir, pipeline):
    from dynamask_torch.data import COCO_CLASSES
    return dict(type='CocoDataset', ann_file=ann_file, img_prefix=img_dir,
                pipeline=pipeline, canvases=CANVASES,
                classes=COCO_CLASSES[:8])


@pytest.fixture(scope='module')
def coco_set(tmp_path_factory):
    return make_set(tmp_path_factory.mktemp('coco_eval'))


@pytest.fixture(scope='module')
def pair():
    return toy_pair()


@pytest.fixture(scope='module')
def slice_run(coco_set, pair):
    """Both test loops over the set, and the port's pasted probabilities
    (for the threshold band)."""
    from dynamask_tpu.apis.test import single_device_test as jax_test
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.apis import dataset_mask_canvas, single_device_test
    from dynamask_torch.data import build_dataset
    from dynamask_torch.ops.paste import paste_masks
    det, variables, port, _ = pair
    cfg = data_cfg(*coco_set, TEST_PIPELINE)
    jds = jax_build(cfg, dict(test_mode=True))
    pds = build_dataset(cfg, dict(test_mode=True))
    ref = jax_test(det, variables, jds, progress=False)
    got = single_device_test(port, pds, workers_per_gpu=0, progress=False)
    ch, cw = dataset_mask_canvas(pds)
    probs = {}
    for i in range(len(pds)):
        s = pds[i]
        batch = {k: torch.from_numpy(s[k])[None]
                 for k in ('image', 'img_shape', 'ori_shape',
                           'scale_factor')}
        with torch.no_grad():
            out = port.simple_test(batch)
        oh, ow = s['ori_shape'].astype(int)
        probs[pds.sample_id(i)] = paste_masks(
            out['mask_probs'][0], out['dets'][0, :, :4], ch,
            cw)[:, :oh, :ow].numpy()
    return jds, pds, ref, got, probs


def test_mask_canvas_and_order(slice_run):
    from dynamask_tpu.apis.test import dataset_mask_canvas as jax_canvas
    from dynamask_torch.apis import dataset_mask_canvas
    jds, pds, ref, got, _ = slice_run
    assert dataset_mask_canvas(pds) == jax_canvas(jds) == (160, 160)
    # the loader's order: the landscape group, then the portrait one
    assert [r['img_id'] for r in got] == [r['img_id'] for r in ref] == \
        [1, 3, 2, 4]


@pytest.mark.parametrize('idx', range(NUM_IMAGES))
def test_single_device_test_image(slice_run, idx):
    _, _, ref, got, probs = slice_run
    r, g = ref[idx], got[idx]
    valid = r['valid'].astype(bool)
    assert valid.sum() >= 4
    scores = np.sort(r['dets'][valid, 4])
    assert np.min(np.diff(scores)) > 1e-4, 'score margins too small'
    np.testing.assert_array_equal(g['valid'], r['valid'])
    np.testing.assert_array_equal(g['labels'], r['labels'])
    # original-image coordinates up to 160 px from fp32 decode on both sides
    np.testing.assert_allclose(g['dets'], r['dets'], rtol=1e-5, atol=1e-4)
    assert len(g['masks']) == len(r['masks'])
    clear = np.abs(probs[g['img_id']] - 0.5) > 1e-3
    for d in range(len(r['masks'])):
        assert g['masks'][d].shape == r['masks'][d].shape
        assert g['masks'][d].dtype == bool
        np.testing.assert_array_equal(g['masks'][d][clear[d]],
                                      r['masks'][d][clear[d]])
    assert sum(int(g['masks'][d].sum()) for d in np.nonzero(valid)[0]) > 0


def test_padded_batches_kept_once(slice_run, pair):
    """Batches of 3 over orientation groups of 2: the sampler pads each
    group by repeating its first image. The JAX loop returns each repeat as
    a result of its own, 6 results for 4 images (a fault of the reference,
    ROADMAP.md queue 3); the port keeps each image once, as at batch 1."""
    from dynamask_tpu.apis.test import single_device_test as jax_test
    from dynamask_torch.apis import single_device_test
    det, variables, port, _ = pair
    jds, pds, _, got, _ = slice_run
    ref3 = jax_test(det, variables, jds, samples_per_gpu=3, progress=False)
    assert [r['img_id'] for r in ref3] == [1, 3, 1, 2, 4, 2]
    got3 = single_device_test(port, pds, samples_per_gpu=3,
                              workers_per_gpu=0, progress=False)
    assert [r['img_id'] for r in got3] == [r['img_id'] for r in got]
    for a, b in zip(got3, got):
        np.testing.assert_array_equal(a['valid'], b['valid'])
        np.testing.assert_array_equal(a['labels'], b['labels'])
        np.testing.assert_allclose(a['dets'], b['dets'], rtol=1e-5,
                                   atol=1e-4)


def test_evaluate_equal(slice_run):
    jds, pds, ref, got, _ = slice_run
    metric = ['bbox', 'segm']
    want = jds.evaluate(ref, metric=metric)
    # the port's evaluator on the JAX results: exactly the JAX numbers
    assert pds.evaluate(ref, metric=metric) == want
    have = pds.evaluate(got, metric=metric)
    assert list(have) == list(want)
    for k in want:
        assert have[k] == pytest.approx(want[k], abs=1e-6, rel=0), k


def test_inference_detector_image(coco_set, pair, tmp_path):
    """Image-level API: a path through the config's test pipeline, masks
    pasted on the original extent rounded up to 32."""
    from dynamask_tpu.apis.inference import Detector
    from dynamask_tpu.apis.inference import inference_detector as jax_infer
    from dynamask_tpu.utils.config import Config as JaxConfig
    from dynamask_torch.apis import inference_detector, init_detector
    from dynamask_torch.data import COCO_CLASSES, format_sample
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.ops.paste import paste_masks
    from dynamask_torch.utils import Config
    _, variables, _, (model, train_cfg, test_cfg) = pair
    cfg = dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg,
               data=dict(test=data_cfg(*coco_set, TEST_PIPELINE)))
    jd = Detector(JaxConfig(cfg), variables, COCO_CLASSES)
    port = init_detector(Config(cfg), device='cpu')
    load_jax_variables(port, variables)
    # the names of the config's test set (the JAX package's init_detector
    # falls back to COCO's 80 whatever the head's classes; ROADMAP queue 3)
    assert port.CLASSES == COCO_CLASSES[:8] and port.pipeline is not None
    jd.canvases = port.canvases = CANVASES
    path = os.path.join(coco_set[1], '0001.jpg')       # 160x120 portrait
    ref_bbox, ref_segm = jax_infer(jd, path)
    bbox, segm = inference_detector(port, path)
    assert len(bbox) == len(segm) == len(port.CLASSES)
    assert len(ref_bbox) == len(COCO_CLASSES)
    assert not any(len(b) or len(m) for b, m in zip(ref_bbox[8:],
                                                    ref_segm[8:]))

    # the port's probabilities on the same canvas, for the threshold band
    import cv2
    img = cv2.imread(path)
    sample = format_sample(port.pipeline({'img': img, 'img_shape': img.shape,
                                          'ori_shape': img.shape}), CANVASES)
    with torch.no_grad():
        out = port.simple_test({k: torch.from_numpy(sample[k])[None]
                                for k in ('image', 'img_shape',
                                          'scale_factor')})
    probs = paste_masks(out['mask_probs'][0], out['dets'][0, :, :4], 160,
                        128)[:, :160, :120].numpy()
    valid = out['det_valid'][0].numpy().astype(bool)
    labels = out['labels'][0].numpy()
    assert valid.sum() >= 4
    n = 0
    for c in range(len(port.CLASSES)):
        assert bbox[c].dtype == np.float32 and bbox[c].shape[1] == 5
        np.testing.assert_allclose(bbox[c], ref_bbox[c], rtol=1e-5,
                                   atol=1e-4)
        slots = np.nonzero(valid & (labels == c))[0]
        assert len(segm[c]) == len(ref_segm[c]) == len(slots)
        for m, rm, d in zip(segm[c], ref_segm[c], slots):
            clear = np.abs(probs[d] - 0.5) > 1e-3
            assert m.shape == rm.shape == (160, 120)
            np.testing.assert_array_equal(m[clear], rm[clear])
            n += 1
    assert n == valid.sum()

    # show_result draws on a copy, as the JAX one does
    from dynamask_tpu.apis.inference import show_result as jax_show
    from dynamask_torch.apis import show_result
    out_file = str(tmp_path / 'shown.jpg')
    drawn = show_result(img, (ref_bbox, ref_segm), COCO_CLASSES, 0.0,
                        out_file)
    np.testing.assert_array_equal(
        drawn, jax_show(img, (ref_bbox, ref_segm), COCO_CLASSES, 0.0))
    assert os.path.isfile(out_file)


def _write_cfg(path, cfg):
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return str(path)


def test_cli_eval(coco_set, pair, tmp_path, capsys):
    """``python -m dynamask_torch.tools.test cfg --device cpu --eval bbox
    segm --out``: exits 0, writes the results json, prints the metrics."""
    from dynamask_torch.tools.test import main
    _, _, _, (model, train_cfg, test_cfg) = pair
    cfg = _write_cfg(tmp_path / 'cfg.py', dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        data=dict(workers_per_gpu=0,
                  test=data_cfg(*coco_set, TEST_PIPELINE))))
    out = tmp_path / 'results.json'
    show = tmp_path / 'show'
    assert main([cfg, '--device', 'cpu', '--eval', 'bbox', 'segm',
                 '--out', str(out), '--show-dir', str(show),
                 '--show-score-thr', '0.0']) == 0
    res = json.loads(out.read_text())
    assert res['bbox'] and len(res['segm']) == len(res['bbox'])
    assert {r['image_id'] for r in res['bbox']} <= set(
        range(1, NUM_IMAGES + 1))
    assert all(isinstance(r['segmentation']['counts'], str)
               for r in res['segm'])
    printed = capsys.readouterr().out
    assert 'bbox_mAP:' in printed and 'segm_mAP:' in printed
    assert len(os.listdir(show)) == NUM_IMAGES


def test_run_eval(slice_run, pair, coco_set, tmp_path):
    """``run_eval`` from a saved port ``state_dict``: the config's loader
    workers, the same metrics as the test loop on the loaded model."""
    from dynamask_torch.apis import run_eval
    from dynamask_torch.utils import Config
    _, pds, _, got, _ = slice_run
    _, _, port, (model, train_cfg, test_cfg) = pair
    ckpt = str(tmp_path / 'toy.pth')
    torch.save(port.state_dict(), ckpt)
    cfg = Config(dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg,
                      data=dict(workers_per_gpu=0,
                                test=data_cfg(*coco_set, TEST_PIPELINE))))
    metric = ['bbox', 'segm']
    assert run_eval(cfg, ckpt, metric, device='cpu') == pds.evaluate(
        got, metric=metric)


@pytest.mark.parametrize('flags,item', [
    (['--tta'], 'test-time augmentation'),
    (['--devices', '2'], 'multi-device')])
def test_cli_refuses_unported_flags(flags, item, coco_set, pair, tmp_path,
                                    capsys):
    """``--tta`` exits non-zero on a detector the JAX package cannot
    augment (RetinaNet), naming why, before it reads a dataset.
    ``--devices 2 --device cpu`` (the multi-device eval, two ranks spawned
    over gloo, ``multi_device_test``) exits 0 and writes the results
    ``--devices 1`` writes, byte for byte."""
    from dynamask_torch.tools.test import main
    if '--tta' in flags:
        cfg = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           'configs', 'retinanet',
                           'retinanet_r50_fpn_1x_coco.py')
        assert main([cfg, *flags, '--device', 'cpu']) != 0
        err = capsys.readouterr().err
        assert item in err and 'RetinaNet' in err
        return
    _, _, _, (model, train_cfg, test_cfg) = pair
    cfg = _write_cfg(tmp_path / 'cfg.py', dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        data=dict(workers_per_gpu=0,
                  test=data_cfg(*coco_set, TEST_PIPELINE))))
    outs = {n: tmp_path / f'results{n}.json' for n in ('1', '2')}
    for n, out in outs.items():
        assert main([cfg, '--devices', n, '--device', 'cpu', '--eval',
                     'bbox', 'segm', '--out', str(out)]) == 0
    assert outs['2'].read_bytes() == outs['1'].read_bytes()
    res = json.loads(outs['2'].read_text())
    assert res['bbox'] and len(res['segm']) == len(res['bbox'])


def test_train_step_from_loader(coco_set):
    """One optimizer step (``train_steps``) on the CPU from a loader batch
    of the train pipeline (GT crops and windows from the polygons)."""
    from test_dynamask import dynamask_toy_cfg
    from dynamask_torch.apis import init_trainer, train_steps
    from dynamask_torch.data import build_dataloader, build_dataset
    from dynamask_torch.utils import Config
    model, train_cfg, test_cfg = dynamask_toy_cfg()
    cfg = Config(dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        optimizer=dict(type='SGD', lr=0.002, momentum=0.9,
                       weight_decay=1e-4),
        optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=5,
                       warmup_ratio=0.001, step=[8, 11]),
        data=dict(train=data_cfg(*coco_set, TRAIN_PIPELINE))))
    ds = build_dataset(cfg.data['train'],
                       default_args=dict(max_gts=8, mask_crop_size=32))
    loader = build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=0)
    batch = next(iter(loader))
    assert batch['image'].shape[0] == 2 and batch['gt_valid'].sum() == 6
    assert batch['gt_crops'].shape == (2, 8, 32, 32)
    net, opt = init_trainer(cfg, steps_per_epoch=len(loader), device='cpu')
    log, = train_steps(net, opt, [batch],
                          generator=torch.Generator().manual_seed(0))
    assert {'loss', 'grad_norm', 'loss_cls', 'loss_rpn_cls'} <= set(log)
    assert all(torch.isfinite(v).all() for v in log.values())
