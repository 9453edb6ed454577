"""LVIS v1 and Cityscapes in the PyTorch port against the JAX package, on
the CPU, on seeded synthetic sets in each format:

- LVIS: 1-indexed sparse category ids, ``frequency`` bands with an empty
  one (no 'c' category), per-image ``neg_category_ids`` and
  ``not_exhaustive_category_ids``, images named only by ``coco_url``;
- Cityscapes: 2048x1024 PNGs with COCO-format GTs over the 8 classes under
  their official label ids (``tools/convert_datasets/cityscapes.py``).

What is held equal: every batch array through the configs' own pipelines
(bit for bit); ``ClassBalancedDataset``'s repeat indices; LVIS
``evaluate`` on a det set with dets of negative and of unannotated
categories, more than 300 dets on one image and an empty band;
``results2txt``'s files byte for byte; the toy DynaMask at the LVIS
config's head (1203 classes, ``score_thr=1e-4``, 300 slots) in both modes,
slot for slot. The port's fixes of two faults of the JAX package are shown
beside the JAX behaviour (ROADMAP.md, queue 3): a test-mode LVIS dataset
keeps COCO's 80 classes and has no file names, and ``inference_detector``
without a checkpoint falls back to COCO's 80 names whatever the head's
classes. Then the eval CLI on the LVIS set, and the train CLI on
``ClassBalancedDataset(LVISV1Dataset)`` and on Cityscapes at batch 1.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_data import _seeded  # noqa: E402
from test_torch_port_modules import randomize_variables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LVIS_CFG = os.path.join(ROOT, 'configs/dynamask/lvis/r50_dynamask_lvis_1x.py')
CITY_CFG = os.path.join(
    ROOT, 'configs/dynamask/cityscapes/r50_dynamask_cityscapes_1x.py')
# sparse ids; 'r' and 'f' only, so the 'c' band is empty
LVIS_CATS = [(1, 'aerosol_can', 'r'), (2, 'banana', 'f'), (3, 'cat', 'r'),
             (5, 'dog', 'f'), (8, 'zebra', 'f')]
LVIS_IMAGES = 6
CITY_IMAGES = 2


def _rect_ann(rng, aid, img_id, cat, w, h, lo=15, hi=40):
    x, y = int(rng.randint(0, w - hi)), int(rng.randint(0, h - hi))
    bw, bh = (int(v) for v in rng.randint(lo, hi, 2))
    poly = [x + 1, y + 1, x + bw - 1, y + 1, x + bw - 1, y + bh - 1,
            x + 1, y + bh - 1]
    return {'id': aid, 'image_id': img_id, 'category_id': int(cat),
            'bbox': [float(x), float(y), float(bw), float(bh)],
            'area': float(bw * bh), 'iscrowd': 0,
            'segmentation': [[float(v) for v in poly]]}


def make_lvis_set(root, num_imgs=LVIS_IMAGES, seed=0, cats=LVIS_CATS):
    """Noise JPEGs of 128x96 and 96x128 named by ``coco_url`` only, 2-4
    rectangle-polygon GTs each; each image has one negative category
    among those it does not hold, and every third one a not-exhaustive
    category."""
    import cv2
    rng = np.random.RandomState(seed)
    img_dir = root / 'imgs'
    img_dir.mkdir(exist_ok=True)
    ids = [c[0] for c in cats]
    images, anns = [], []
    for i in range(num_imgs):
        h, w = (96, 128) if i % 2 == 0 else (128, 96)
        img_id = 1000 + 7 * i
        name = f'{img_id:012d}.jpg'
        cv2.imwrite(str(img_dir / name),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        held = set()
        for _ in range(int(rng.randint(2, 5))):
            cat = int(rng.choice(ids))
            held.add(cat)
            anns.append(_rect_ann(rng, len(anns) + 1, img_id, cat, w, h))
        absent = [c for c in ids if c not in held]
        images.append({
            'id': img_id, 'width': w, 'height': h,
            'coco_url': f'http://images.cocodataset.org/val2017/{name}',
            'neg_category_ids': absent[:1],
            'not_exhaustive_category_ids': sorted(held)[:1] if i % 3 == 0
            else []})
    categories = [{'id': cid, 'name': n, 'frequency': f,
                   'image_count': 3} for cid, n, f in cats]
    ann_file = root / 'lvis.json'
    ann_file.write_text(json.dumps({'images': images, 'annotations': anns,
                                    'categories': categories}))
    return str(ann_file), str(img_dir)


def make_cityscapes_set(root, num_imgs=CITY_IMAGES, seed=0):
    """Noise PNGs of 2048x1024, 3-5 rectangle GTs each over the 8 classes
    (official label ids as category ids, as the converter writes them)."""
    import cv2
    from dynamask_torch.data import CITYSCAPES_CLASSES, CITYSCAPES_LABEL_IDS
    rng = np.random.RandomState(seed)
    img_dir = root / 'leftImg8bit'
    img_dir.mkdir(exist_ok=True)
    ids = [CITYSCAPES_LABEL_IDS[n] for n in CITYSCAPES_CLASSES]
    images, anns = [], []
    for i in range(num_imgs):
        name = f'city_{i:06d}_000019_leftImg8bit.png'
        cv2.imwrite(str(img_dir / name),
                    rng.uniform(0, 255, (1024, 2048, 3)).astype(np.uint8))
        images.append({'id': i + 1, 'file_name': name, 'width': 2048,
                       'height': 1024})
        for _ in range(int(rng.randint(3, 6))):
            anns.append(_rect_ann(rng, len(anns) + 1, i + 1, rng.choice(ids),
                                  2048, 1024, lo=40, hi=300))
    cats = [{'id': CITYSCAPES_LABEL_IDS[n], 'name': n}
            for n in CITYSCAPES_CLASSES]
    ann_file = root / 'instances.json'
    ann_file.write_text(json.dumps({'images': images, 'annotations': anns,
                                    'categories': cats}))
    return str(ann_file), str(img_dir)


@pytest.fixture(scope='module')
def lvis_set(tmp_path_factory):
    return make_lvis_set(tmp_path_factory.mktemp('lvis'))


@pytest.fixture(scope='module')
def city_set(tmp_path_factory):
    return make_cityscapes_set(tmp_path_factory.mktemp('cityscapes'))


def _data_cfg(path, split, ann_file, img_dir):
    """The config file's ``data[split]`` pointed at a synthetic set (the
    inner dataset's for a wrapper)."""
    from dynamask_torch.utils.config import Config
    data = Config.fromfile(path).data
    cfg = dict(data[split])
    inner = dict(cfg.get('dataset', cfg), ann_file=ann_file,
                 img_prefix=img_dir, data_root=None)
    if 'dataset' in cfg:
        return dict(cfg, dataset=inner), data
    return inner, data


def _pair(path, split, ann_file, img_dir, test_mode=False, **kw):
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.data import build_dataset
    cfg, data = _data_cfg(path, split, ann_file, img_dir)
    cfg.update(kw)
    args = dict(test_mode=test_mode, max_gts=data['max_gts'],
                mask_crop_size=data['mask_crop_size'])
    return jax_build(cfg, args), build_dataset(cfg, args)


def _inner(ds):
    return getattr(ds, 'dataset', ds)


def _assert_samples_equal(ref_ds, ds):
    assert len(ds) == len(ref_ds)
    for i in range(len(ds)):
        ref, got = ref_ds[i], ds[i]
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    return got


# -- datasets -----------------------------------------------------------------

@pytest.mark.parametrize('which,split', [('lvis', 'train'),
                                         ('cityscapes', 'train'),
                                         ('cityscapes', 'test')])
def test_batch_arrays_bit_identical(lvis_set, city_set, which, split):
    """Every array of every sample through the config's own pipeline (the
    LVIS train set inside its ``ClassBalancedDataset``), the random draws
    fixed by one rng per sample on both sides."""
    path, data_set = ((LVIS_CFG, lvis_set) if which == 'lvis'
                      else (CITY_CFG, city_set))
    ref_ds, ds = _pair(path, split, *data_set, test_mode=split == 'test')
    for d in (_inner(ref_ds), _inner(ds)):
        _seeded(d)
    np.testing.assert_array_equal(ds.flags, ref_ds.flags)
    got = _assert_samples_equal(ref_ds, ds)
    canvas = (1024, 2048) if which == 'cityscapes' else None
    if canvas:
        assert got['image'].shape == canvas + (3,)
    inner = _inner(ds)
    assert inner.CLASSES == _inner(ref_ds).CLASSES
    assert inner.cat_ids == _inner(ref_ds).cat_ids
    if which == 'lvis':
        assert type(ds).__name__ == 'ClassBalancedDataset'
        assert inner.CLASSES == tuple(c[1] for c in LVIS_CATS)
        assert all('file_name' in i for i in inner.img_infos)


def test_lvis_test_mode_fault_and_fix(lvis_set):
    """A test-mode LVIS dataset (what the eval CLI builds): the JAX
    package never resolves the json's classes or the ``coco_url`` file
    names there (``_filter_imgs`` only runs in train mode), so its classes
    stay COCO's 80, its ``cat_ids`` are the json's categories whose names
    COCO shares, in COCO's order, and loading an image raises KeyError.
    The port resolves both; its samples equal the JAX train-mode dataset's
    test-pipeline output."""
    from dynamask_torch.data import COCO_CLASSES
    ref_ds, ds = _pair(LVIS_CFG, 'test', *lvis_set, test_mode=True)
    assert ref_ds.CLASSES == COCO_CLASSES
    assert ref_ds.cat_ids == [3, 5, 8, 2]     # cat, dog, zebra, banana
    with pytest.raises(KeyError, match='file_name'):
        ref_ds[0]
    assert ds.CLASSES == tuple(c[1] for c in LVIS_CATS)
    assert ds.cat_ids == [c[0] for c in LVIS_CATS]
    assert len(ds) == LVIS_IMAGES
    ref_train, _ = _pair(LVIS_CFG, 'test', *lvis_set, test_mode=False,
                         filter_empty_gt=False)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor', 'img_id')
    for i in range(len(ds)):
        ref, got = ref_train[i], ds[i]
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize('thr', [0.001, 0.6])
def test_class_balanced_indices_equal(lvis_set, thr):
    """The config's threshold (every category is frequent in 6 images: no
    repeats) and one at which the rare categories repeat."""
    ref_ds, ds = _pair(LVIS_CFG, 'train', *lvis_set, oversample_thr=thr)
    np.testing.assert_array_equal(ds.indices, ref_ds.indices)
    np.testing.assert_array_equal(ds.flags, ref_ds.flags)
    assert (len(ds) > len(ds.dataset)) == (thr > 0.1)


def _lvis_results(ds, seed=0, crowded=350):
    """GT boxes at score 0.9 with noise, dets of each image's negative
    category and of a category it has not annotated, and ``crowded``
    random dets on the first image; masks from the boxes."""
    rng = np.random.RandomState(seed)
    results = []
    for i, info in enumerate(ds.img_infos):
        h, w = info['height'], info['width']
        ann = ds.get_ann_info(i)
        boxes = ann['bboxes'] + rng.uniform(-2, 2, ann['bboxes'].shape)
        labels = list(ann['labels'])
        held = {ds.cat_ids[int(c)] for c in ann['labels']}
        neg = info['neg_category_ids']
        others = [c for c in ds.cat_ids if c not in held and c not in neg]
        extra = [(c, 0.95) for c in neg[:1]] + [(c, 0.97) for c in others[:1]]
        n = (crowded if i == 0 else 0) + len(extra)
        xy = rng.uniform(0, [w - 20, h - 20], (n, 2))
        wh = rng.uniform(8, 20, (n, 2))
        boxes = np.concatenate([boxes, np.concatenate([xy, xy + wh], 1)])
        scores = np.concatenate([np.full(len(labels), 0.9),
                                 [s for _, s in extra],
                                 rng.uniform(0.05, 0.99, n - len(extra))])
        labels += [ds.cat2label[c] for c, _ in extra]
        labels += list(rng.randint(0, len(ds.cat_ids), n - len(extra)))
        dets = np.concatenate([boxes, scores[:, None]], 1).astype(np.float32)
        masks = []
        for x1, y1, x2, y2 in dets[:, :4]:
            m = np.zeros((h, w), np.uint8)
            m[int(max(y1, 0)):int(y2), int(max(x1, 0)):int(x2)] = 1
            masks.append(m)
        results.append({'img_id': info['id'], 'dets': dets,
                        'labels': np.asarray(labels, np.int64),
                        'valid': np.ones(len(dets), bool), 'masks': masks})
    return results


def test_lvis_evaluate_equal(lvis_set):
    """The port's LVIS metrics equal the JAX package's (train-mode
    datasets, where the JAX one resolves its classes): the 300-det cap,
    the federated ignoring and the frequency bands; the 'c' band is empty
    (-1.0). Dets of a category the image has not annotated change
    nothing; dets of its negative category count as false positives."""
    ref_ds, ds = _pair(LVIS_CFG, 'train', *lvis_set)
    ref_ds, ds = _inner(ref_ds), _inner(ds)
    results = _lvis_results(ds)
    assert len(results[0]['dets']) > 300
    metric = ['bbox', 'segm']
    got = ds.evaluate(results, metric=metric)
    assert got == ref_ds.evaluate(results, metric=metric)
    assert got['bbox_mAP_c'] == got['segm_mAP_c'] == -1.0
    assert 0 < got['bbox_mAP_r'] < 1 and 0 < got['bbox_mAP_f'] < 1

    def without(keep):
        out = []
        for res, info in zip(results, ds.img_infos):
            seen = ({a['category_id'] for a in ds.coco.img_anns[info['id']]}
                    | set(info['not_exhaustive_category_ids']))
            cats = np.asarray([ds.cat_ids[int(c)] for c in res['labels']])
            k = np.asarray([keep(c, seen, info) for c in cats])
            out.append(dict(res, valid=res['valid'] & k))
        return out

    unannotated = without(lambda c, seen, info: c in seen or c in
                          info['neg_category_ids'])
    assert ds.evaluate(unannotated, metric=['bbox']) == \
        {k: v for k, v in got.items() if k.startswith('bbox')}
    no_neg = without(lambda c, seen, info: c not in
                     info['neg_category_ids'])
    assert ds.evaluate(no_neg, metric=['bbox'])['bbox_mAP'] > \
        got['bbox_mAP']


def test_lvis_gt_as_predictions(lvis_set, capsys):
    """The port's test-mode LVIS set: its GTs fed back score 1.0 in box
    and mask AP and in each non-empty band; ``classwise`` prints the
    table."""
    from dynamask_torch.data import polygons_to_mask
    _, ds = _pair(LVIS_CFG, 'test', *lvis_set, test_mode=True)
    results = []
    for i, info in enumerate(ds.img_infos):
        ann = ds.get_ann_info(i)
        n = len(ann['bboxes'])
        results.append({
            'img_id': info['id'],
            'dets': np.concatenate([ann['bboxes'],
                                    np.full((n, 1), 0.9, np.float32)], 1),
            'labels': ann['labels'], 'valid': np.ones(n, bool),
            'masks': [polygons_to_mask(m, info['height'], info['width'])
                      for m in ann['masks']]})
    got = ds.evaluate(results, metric=['bbox', 'segm'], classwise=True)
    for m in ('bbox', 'segm'):
        assert got[f'{m}_mAP'] == got[f'{m}_mAP_r'] == \
            got[f'{m}_mAP_f'] == 1.0
        assert got[f'{m}_mAP_c'] == -1.0
    assert 'per-category segm AP' in capsys.readouterr().out


def test_cityscapes_evaluate_and_results2txt_identical(city_set, tmp_path):
    """COCO metrics and the official evaluator's export: each txt and PNG
    byte for byte the JAX package's."""
    ref_ds, ds = _pair(CITY_CFG, 'test', *city_set, test_mode=True)
    assert ds.CLASSES == ref_ds.CLASSES and ds.cat_ids == ref_ds.cat_ids
    rng = np.random.RandomState(1)
    results = []
    for i, info in enumerate(ds.img_infos):
        ann = ds.get_ann_info(i)
        n = len(ann['bboxes'])
        masks = (rng.uniform(size=(n, 64, 128)) > 0.5).repeat(
            16, 1).repeat(16, 2)
        results.append({
            'img_id': info['id'],
            'dets': np.concatenate([ann['bboxes'] + 1.5,
                                    rng.uniform(0.1, 1, (n, 1))],
                                   1).astype(np.float32),
            'labels': ann['labels'], 'valid': rng.uniform(size=n) > 0.2,
            'masks': list(masks)})
    metric = ['bbox', 'segm']
    assert ds.evaluate(results, metric=metric) == \
        ref_ds.evaluate(results, metric=metric)
    ref_files = ref_ds.results2txt(results, str(tmp_path / 'jax'))
    files = ds.results2txt(results, str(tmp_path / 'port'))
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in ref_files]
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(os.listdir(tmp_path / 'port'))
    assert sum(n.endswith('.png') for n in names) == \
        sum(int(r['valid'].sum()) for r in results) > 0
    for n in names:
        assert (tmp_path / 'port' / n).read_bytes() == \
            (tmp_path / 'jax' / n).read_bytes(), n


# -- the LVIS config's head: 1203 classes, 300 slots --------------------------

def lvis_toy_cfg(dynamic=False, num_classes=1203):
    """The toy DynaMask (``tests/test_dynamask.py:dynamask_toy_cfg``) with
    the LVIS config's head: ``num_classes`` classes, ``score_thr=1e-4``,
    300 det slots, the flagship's capacities (1.0, 1.0, 0.01)."""
    from test_dynamask import dynamask_toy_cfg
    model, train_cfg, test_cfg = dynamask_toy_cfg()
    rh = model['roi_head']
    rh['bbox_head']['num_classes'] = num_classes
    rh['mask_head']['stage_num_classes'] = [num_classes] * 3 + [1]
    rh['dynamic_inference'] = dynamic
    rh['dynamic_capacity'] = (1.0, 1.0, 0.01)
    test_cfg['rcnn'].update(score_thr=1e-4, max_per_img=300)
    return model, train_cfg, test_cfg


@pytest.fixture(scope='module')
def lvis_toy_variables():
    from test_models import demo_batch
    from dynamask_tpu.models import build_detector as jax_build
    det = jax_build(*lvis_toy_cfg())
    batch = demo_batch(0, b=1, h=64, w=64, g=3, s=16)
    return randomize_variables(
        jax.jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))


@pytest.mark.parametrize('dynamic', [False, True])
def test_dynamask_300_slots_1203_classes(lvis_toy_variables, dynamic):
    """``simple_test`` + paste slot for slot. All 300 slots fill, most
    labels past COCO's 79; the dynamic mode's capacities are 300/300/3.
    Scores of 300 dets over 3e-3..2e-2 cannot stay 1e-4 apart: here the
    slots agree exactly, the port's score error (~1.6e-8) being of the
    order of the smallest gap between two slots' scores (~1e-8)."""
    from test_models import demo_batch
    from dynamask_tpu.apis.test import _paste_epilogue
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.apis import inference_detector
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    from dynamask_torch.ops.paste import paste_masks

    cfgs = lvis_toy_cfg(dynamic)
    det = jax_build(*cfgs)
    port = build_detector(*cfgs, device='cpu')
    load_jax_variables(port, lvis_toy_variables)
    demo = demo_batch(0, b=1, h=64, w=64, g=3, s=16)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch_np = {k: np.array(demo[k]) for k in keys}

    @jax.jit
    def jax_fn(v, batch):
        out = det.apply(v, batch, method='simple_test')
        return out, _paste_epilogue(out, 64, 64, 0.5)

    ref, ref_epi = jax.tree_util.tree_map(np.asarray, jax_fn(
        lvis_toy_variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    batch_t = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    got = inference_detector(port, batch_t)
    with torch.no_grad():
        out = port.simple_test(batch_t)
    valid = ref['det_valid'][0].astype(bool)
    assert valid.sum() == 300 and (ref['labels'][0] >= 80).sum() > 200
    np.testing.assert_array_equal(got['valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    assert out['mask_probs'].shape == (1, 300, 112, 112)
    np.testing.assert_allclose(out['mask_probs'].numpy(), ref['mask_probs'],
                               atol=2e-4)
    probs = paste_masks(out['mask_probs'][0], out['dets'][0, :, :4], 64,
                        64).numpy()
    clear = np.abs(probs - 0.5) > 1e-3
    np.testing.assert_array_equal(got['masks'].numpy()[0][clear],
                                  ref_epi['masks'][0][clear])
    if dynamic:
        assert got['msm_routing']['capacity'].tolist() == [300, 300, 3]
        assert int(got['msm_routing']['hist'].sum()) == 300


def _lvis_infer_cfg(ann_file, num_classes=1203):
    model, train_cfg, test_cfg = lvis_toy_cfg(num_classes=num_classes)
    norm = dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)
    pipeline = [dict(type='LoadImageFromFile'),
                dict(type='Resize', img_scale=(64, 64), keep_ratio=True),
                norm, dict(type='Pad', size_divisor=32)]
    return dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg,
                data=dict(test=dict(type='LVISV1Dataset', ann_file=ann_file,
                                    img_prefix='', pipeline=pipeline)))


def test_inference_detector_without_checkpoint(lvis_toy_variables,
                                               tmp_path):
    """The LVIS head and no checkpoint: the JAX ``init_detector`` takes
    COCO's 80 names, and ``inference_detector`` raises IndexError on the
    first det labelled past 79. The port names the 1203 classes
    ``class_{i}`` (only the set's json, which it does not read for this,
    holds their names) and returns 1203 lists, equal to the JAX outputs
    split by class."""
    from dynamask_tpu.apis.inference import Detector
    from dynamask_tpu.apis.inference import inference_detector as jinfer
    from dynamask_tpu.core.bbox_transforms import bbox2result as jb2r
    from dynamask_tpu.utils.config import Config as JConfig
    from dynamask_torch.apis import inference_detector, init_detector
    from dynamask_torch.data import COCO_CLASSES, format_sample
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.ops.paste import paste_masks
    from dynamask_torch.utils.config import Config

    cfg = _lvis_infer_cfg(str(tmp_path / 'lvis_v1_val.json'))
    img = np.random.RandomState(5).uniform(0, 255, (64, 64, 3)).astype(
        np.uint8)

    jdet = Detector(JConfig(cfg), lvis_toy_variables, COCO_CLASSES)
    jdet.canvases = [(64, 64)]
    with pytest.raises(IndexError):
        jinfer(jdet, img)
    port = init_detector(Config(cfg), device='cpu')
    assert port.CLASSES == tuple(f'class_{i}' for i in range(1203))
    load_jax_variables(port, lvis_toy_variables)
    port.canvases = ((64, 64),)
    bbox, segm = inference_detector(port, img)
    assert len(bbox) == len(segm) == 1203

    sample = port.pipeline({'img': img, 'img_shape': img.shape,
                            'ori_shape': img.shape})
    s = format_sample(sample, port.canvases)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    out = jax.device_get(jdet._fn_for((64, 64), (64, 64))(
        {k: jnp.asarray(s[k])[None] for k in keys}))
    valid = out['valid'][0].astype(bool)
    assert (out['labels'][0][valid] >= 80).any()
    ref = jb2r(out['dets'][0, :, :4], out['dets'][0, :, 4], out['labels'][0],
               valid, 1203)
    for a, b in zip(bbox, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    with torch.no_grad():
        res = port.simple_test({k: torch.from_numpy(s[k])[None]
                                for k in keys})
    probs = paste_masks(res['mask_probs'][0], res['dets'][0, :, :4], 64,
                        64).numpy()
    order = {}
    for d in np.nonzero(valid)[0]:
        c = int(out['labels'][0, d])
        k = order.setdefault(c, 0)
        order[c] += 1
        clear = np.abs(probs[d] - 0.5) > 1e-3
        np.testing.assert_array_equal(segm[c][k][clear],
                                      out['masks'][0, d][clear])


def test_inference_detector_on_cityscapes_image():
    """The Cityscapes config's data (its test set and pipeline, unchanged)
    with the toy DynaMask at its 8 classes, random weights, on one
    2048x1024 image. The JAX ``init_detector`` gives every model COCO's
    canvases, none of which holds the 1024x2048 input, so its
    ``inference_detector`` raises ValueError. The port takes the canvases
    of the config's test set and returns 8 lists with masks at the
    image's extent."""
    from test_dynamask import dynamask_toy_cfg
    from dynamask_tpu.apis.inference import Detector
    from dynamask_tpu.apis.inference import inference_detector as jinfer
    from dynamask_tpu.utils.config import Config as JConfig
    from dynamask_torch.apis import inference_detector, init_detector
    from dynamask_torch.data import CITYSCAPES_CLASSES
    from dynamask_torch.utils.config import Config

    model, train_cfg, test_cfg = dynamask_toy_cfg()
    toy = dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg)
    img = np.random.RandomState(9).uniform(0, 255, (1024, 2048, 3)).astype(
        np.uint8)

    jcfg = JConfig(dict(JConfig.fromfile(CITY_CFG).to_dict(), **toy))
    with pytest.raises(ValueError, match='no canvas fits'):
        jinfer(Detector(jcfg, None, CITYSCAPES_CLASSES), img)

    cfg = Config(dict(Config.fromfile(CITY_CFG).to_dict(), **toy))
    port = init_detector(cfg, device='cpu', seed=0)
    assert port.canvases == [(1024, 2048), (2048, 1024)]
    assert port.CLASSES == CITYSCAPES_CLASSES
    bbox, segm = inference_detector(port, img)
    assert len(bbox) == len(segm) == 8
    assert sum(len(b) for b in bbox) == sum(len(m) for m in segm)
    for b, ms in zip(bbox, segm):
        assert b.shape[1:] == (5,) and np.isfinite(b).all()
        assert all(m.shape == (1024, 2048) for m in ms)


# -- the CLIs -----------------------------------------------------------------

def _write_cfg(path, cfg):
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return str(path)


def test_eval_cli_on_lvis(lvis_set, tmp_path, capsys):
    """``python -m dynamask_torch.tools.test`` on the LVIS set: the toy at
    the set's 5 classes, random weights; the LVIS metrics with their
    bands, and the results json in the json's category ids."""
    from dynamask_torch.tools.test import main
    ann_file, img_dir = lvis_set
    cfg = _lvis_infer_cfg(ann_file, num_classes=len(LVIS_CATS))
    cfg['data'].update(workers_per_gpu=0)
    cfg['data']['test'].update(img_prefix=img_dir,
                               canvases=[(64, 64), (64, 64)])
    path = _write_cfg(tmp_path / 'lvis_cfg.py', cfg)
    out = tmp_path / 'results.json'
    assert main([path, '--device', 'cpu', '--eval', 'bbox', 'segm',
                 '--out', str(out)]) == 0
    printed = capsys.readouterr().out
    for key in ('bbox_mAP:', 'segm_mAP:', 'bbox_mAP_r:', 'segm_mAP_c: -1'):
        assert key in printed, key
    res = json.loads(out.read_text())
    assert res['bbox'] and len(res['segm']) == len(res['bbox'])
    assert {r['category_id'] for r in res['bbox']} <= \
        {c[0] for c in LVIS_CATS}
    assert len({r['image_id'] for r in res['bbox']}) == LVIS_IMAGES


@pytest.mark.parametrize('which', ['lvis', 'cityscapes'])
def test_train_cli(lvis_set, city_set, tmp_path, which):
    """``python -m dynamask_torch.tools.train`` (its ``main``) one step on
    ``ClassBalancedDataset(LVISV1Dataset)`` at batch 2 and on Cityscapes
    at the config's batch 1, the datasets as the config files build them
    but resized for the toy: a train row with finite losses, a
    checkpoint whose meta carries the dataset's classes."""
    from dynamask_torch.tools.train import main
    path, data_set = ((LVIS_CFG, lvis_set) if which == 'lvis'
                      else (CITY_CFG, city_set))
    num_classes = len(LVIS_CATS) if which == 'lvis' else 8
    model, train_cfg, test_cfg = lvis_toy_cfg(num_classes=num_classes)
    train, data = _data_cfg(path, 'train', *data_set)
    inner = train.get('dataset', train)
    size = (96, 64) if which == 'lvis' else (256, 128)
    for t in inner['pipeline']:
        if t['type'] == 'Resize':
            t['img_scale'] = size
            t.pop('multiscale_mode', None)
    inner['canvases'] = [size[::-1], size]
    cfg = dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg,
               data=dict(samples_per_gpu=data['samples_per_gpu']
                         if which == 'cityscapes' else 2,
                         workers_per_gpu=0, max_gts=16, mask_crop_size=32,
                         train=train),
               optimizer=dict(type='SGD', lr=0.01, momentum=0.9,
                              weight_decay=0.0001),
               optimizer_config=dict(grad_clip=dict(max_norm=35)),
               lr_config=dict(policy='step', step=[8]), total_epochs=1,
               checkpoint_config=dict(interval=1), log_config=dict(
                   interval=1))
    assert cfg['data']['samples_per_gpu'] == (1 if which == 'cityscapes'
                                              else 2)
    work = tmp_path / 'work'
    assert main([_write_cfg(tmp_path / 'cfg.py', cfg), '--device', 'cpu',
                 '--work-dir', str(work), '--max-steps-per-epoch', '1',
                 '--no-validate']) == 0
    rows = [json.loads(line) for f in work.glob('*.log.json')
            for line in open(f)]
    assert [r['mode'] for r in rows] == ['train']
    assert np.isfinite(rows[0]['loss']) and rows[0]['loss_masks'] > 0
    ckpt = torch.load(work / 'epoch_1.pth', map_location='cpu',
                       weights_only=False)
    assert len(ckpt['meta']['CLASSES']) == num_classes


# -- the kernels' launch configurations at the new shapes ---------------------

def test_launch_configs_at_lvis_and_cityscapes_shapes():
    """K1/K3 at n = 300 per SFM stage and K2/K4 at 300 RoIs, on the
    Cityscapes pyramid: shared memory within the card's 227 KB a block,
    the grid within a 32-bit x dimension, and the largest plane's element
    offsets within the kernels' 32-bit arithmetic (only each RoI's base
    is 64-bit)."""
    from dynamask_torch.ops.deform_conv import dcn_launch_config
    from dynamask_torch.ops.roi_align import roi_align_launch_config
    for kernel in ('k1', 'k3'):
        for s, c in ((14, 256), (28, 128), (56, 64)):
            cfg = dcn_launch_config(kernel, 300, s, s, c, 2)
            assert cfg['smem_bytes'] <= 227 * 1024
            assert 300 * 2 * cfg['n_bands'] < 2 ** 31
    for kernel in ('k2', 'k4'):
        for p, s in ((7, 2), (14, 2), (28, 2), (56, 2), (56, 1)):
            cfg = roi_align_launch_config(kernel, 300, p, s, 256)
            assert cfg['smem_bytes'] <= 227 * 1024
            assert 300 * cfg['n_bands'] < 2 ** 31
    # Cityscapes' P2 at the 1024x2048 canvas, 256 channels
    assert (1024 // 4) * (2048 // 4) * 256 < 2 ** 31
