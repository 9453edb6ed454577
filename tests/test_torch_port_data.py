"""The port's host-side data modules (``dynamask_torch.data``) against the
JAX package's (``dynamask_tpu.data``), on the same seeded inputs.

- RLE: the C codec (``dynamask_torch/native/maskc.c`` through ctypes) and
  the numpy plain version give byte-identical strings to the JAX codec;
  decode, area and run-length IoU are exact.
- ``CocoEvaluator``: stats equal to 1e-12 on the same det JSON, bbox and
  segm, with crowd GTs.
- Pipelines: every batch array of ``CocoDataset[i]`` through the
  flagship's test and train pipelines is bit-identical to the JAX
  dataset's (both run cv2 in this process), random draws fixed by one
  ``_rng`` per sample on both sides.
- The loader's batch order equals the JAX loader's.
- The package imports without jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

sys.path.insert(0, os.path.dirname(__file__))

from test_data import make_synthetic_coco  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, 'configs/dynamask/coco/r50_dynamask_1x.py')


def _masks(kind, seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 60, 2)
    if kind == 'random':
        return (rng.uniform(0, 1, (h, w)) > rng.uniform()).astype(np.uint8)
    if kind == 'blob':   # long runs: multi-digit varints, negative deltas
        yy, xx = np.mgrid[:h, :w]
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 30)
        return ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8)
    if kind == 'zeros':
        return np.zeros((h, w), np.uint8)
    if kind == 'ones':
        return np.ones((h, w), np.uint8)
    # a bool view in column-major order, as the test loop hands masks over
    m = rng.uniform(0, 1, (w, h)) > 0.6
    return m.T


KINDS = ['random', 'blob', 'zeros', 'ones', 'bool_fortran']


@pytest.mark.parametrize('kind', KINDS)
def test_rle_strings_byte_identical(kind):
    from dynamask_tpu.data import mask_codec as jc
    from dynamask_torch.data import mask_codec as pc
    for seed in range(20):
        m = _masks(kind, seed)
        ref = jc.encode_mask(np.asarray(m, np.uint8))
        assert pc.encode_mask(m) == ref
        assert pc.encode_mask_plain(m) == ref
        assert pc.rle_counts_to_string(pc.mask_to_rle_counts(m)) == \
            ref['counts'].encode('ascii')


@pytest.mark.parametrize('kind', KINDS)
def test_rle_decode_and_area_exact(kind):
    from dynamask_tpu.data import mask_codec as jc
    from dynamask_torch.data import mask_codec as pc
    for seed in range(20):
        m = np.asarray(_masks(kind, seed), np.uint8)
        rle = jc.encode_mask(m)
        for got in (pc.decode_rle(rle), pc.decode_rle_plain(rle),
                    pc.decode_rle(dict(rle, counts=rle['counts'].encode()))):
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, m)
            np.testing.assert_array_equal(got, jc.decode_rle(rle))
        assert pc.rle_area(rle) == jc.rle_area(rle) == int(m.sum())
        counts = pc.mask_to_rle_counts(m)
        assert pc.rle_area({'counts': counts.tolist()}) == int(m.sum())
        np.testing.assert_array_equal(
            pc.rle_string_to_counts(rle['counts']), counts)


def test_rle_iou_exact_with_crowd():
    from dynamask_tpu.data import mask_codec as jc
    from dynamask_torch.data import mask_codec as pc
    rng = np.random.RandomState(3)
    masks = [(rng.uniform(0, 1, (37, 23)) > t).astype(np.uint8)
             for t in rng.uniform(0.2, 0.95, 9)]
    masks.append(np.zeros((37, 23), np.uint8))      # empty: IoU 0, not NaN
    rles = [jc.encode_mask(m) for m in masks]
    dets, gts = rles[:6], rles[6:]
    crowd = [False, True, False, True]
    got = pc.rle_iou(dets, gts, crowd)
    np.testing.assert_array_equal(got, jc.rle_iou(dets, gts, crowd))
    # and the dense form (uncompressed RLEs) gives the same numbers
    dense = [{'size': r['size'],
              'counts': pc.rle_string_to_counts(r['counts']).tolist()}
             for r in rles]
    np.testing.assert_array_equal(pc.rle_iou(dense[:6], dense[6:], crowd),
                                  got)
    assert pc.rle_iou([], gts, crowd).shape == (0, 4)


def test_polygons_and_segm_iou_equal():
    from dynamask_tpu.data import mask_codec as jc
    from dynamask_torch.data import mask_codec as pc
    rng = np.random.RandomState(4)
    polys = [[list(rng.uniform(0, 40, 10))] for _ in range(5)]
    for p in polys:
        np.testing.assert_array_equal(pc.polygons_to_mask(p, 48, 44),
                                      jc.polygons_to_mask(p, 48, 44))
    dets = [jc.encode_mask(jc.polygons_to_mask(p, 48, 44)) for p in polys]
    crowd = [False, True, False, False, True]
    np.testing.assert_array_equal(pc.segm_iou(dets, polys, crowd, 48, 44),
                                  jc.segm_iou(dets, polys, crowd, 48, 44))


def test_malformed_rle_raises():
    from dynamask_torch.data import mask_codec as pc
    with pytest.raises(ValueError, match='cover'):
        pc.decode_rle({'size': [2, 2], 'counts': '5'})
    # the fourth run decodes to 1 - 6 < 0
    bad = pc.rle_counts_to_string([2, 1, 3, -5])
    with pytest.raises(ValueError, match='negative'):
        pc.rle_area({'size': [2, 2], 'counts': bad})


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A compiler failure raises with its output; no numpy fallback."""
    import dynamask_torch.native as native
    monkeypatch.setattr(native, '_BUILD_DIR', str(tmp_path))
    monkeypatch.setenv('CC', 'false')
    with pytest.raises(RuntimeError, match='cc maskc.c failed'):
        native.build()
    assert not any(f.endswith('.so') for f in os.listdir(tmp_path))


# -- the evaluator ------------------------------------------------------------

def _eval_case(seed=0):
    """GTs with polygons and crowd RLEs over 4 images and 3 categories, and
    noisy dets around them with RLE masks, some unmatched."""
    from dynamask_tpu.data import mask_codec as jc
    rng = np.random.RandomState(seed)
    h, w = 60, 80
    gts, dets, aid = [], [], 0
    for img in range(1, 5):
        for _ in range(rng.randint(2, 6)):
            aid += 1
            cat = int(rng.choice([1, 2, 5]))
            x, y = rng.uniform(0, 50), rng.uniform(0, 30)
            bw, bh = rng.uniform(4, 28, 2)
            crowd = int(rng.uniform() < 0.2)
            poly = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
            segm = ([poly] if not crowd else
                    jc.encode_mask(jc.polygons_to_mask([poly], h, w)))
            gts.append({'id': aid, 'image_id': img, 'category_id': cat,
                        'bbox': [x, y, bw, bh], 'area': bw * bh,
                        'iscrowd': crowd, 'segmentation': segm})
            for _ in range(rng.randint(0, 3)):
                j = rng.normal(0, 3, 4)
                box = [x + j[0], y + j[1], max(bw + j[2], 1),
                       max(bh + j[3], 1)]
                dpoly = [box[0], box[1], box[0] + box[2], box[1],
                         box[0] + box[2], box[1] + box[3], box[0],
                         box[1] + box[3]]
                dets.append({'image_id': img,
                             'category_id': int(rng.choice([cat, 1])),
                             'bbox': box, 'score': float(rng.uniform()),
                             'segmentation': jc.encode_mask(
                                 jc.polygons_to_mask([dpoly], h, w))})
    sizes = {i: (h, w) for i in range(1, 5)}
    return gts, dets, sizes


@pytest.mark.parametrize('iou_type', ['bbox', 'segm'])
@pytest.mark.parametrize('seed', [0, 1])
def test_cocoeval_stats_equal(iou_type, seed):
    from dynamask_tpu.data import CocoEvaluator as JaxEval
    from dynamask_torch.data import CocoEvaluator
    gts, dets, sizes = _eval_case(seed)
    assert any(g['iscrowd'] for g in gts)
    args = (gts, [1, 2, 3, 4], [1, 2, 5], iou_type)
    ref_ev, ev = JaxEval(*args, img_sizes=sizes), \
        CocoEvaluator(*args, img_sizes=sizes)
    ref, got = ref_ev.evaluate(dets), ev.evaluate(dets)
    assert list(got) == list(ref)
    assert 0.0 < ref['mAP'] < 1.0
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-12, rel=0), k
    for c in ref_ev.per_class_ap:
        assert ev.per_class_ap[c] == pytest.approx(ref_ev.per_class_ap[c],
                                                   abs=1e-12, rel=0)


# -- the pipelines --------------------------------------------------------------

def _flagship_data():
    from dynamask_torch.utils.config import Config
    return Config.fromfile(FLAGSHIP).data


def _with_crowd_and_rle(ann_file):
    """Add a crowd RLE and a non-crowd RLE-segmented annotation to the
    synthetic set, so the RLE branches of the crop rasterizer and the
    ignore boxes take part."""
    from dynamask_tpu.data import mask_codec as jc
    with open(ann_file) as f:
        data = json.load(f)
    aid = max(a['id'] for a in data['annotations'])
    for img in data['images'][:3]:
        h, w = img['height'], img['width']
        m = np.zeros((h, w), np.uint8)
        m[10:50, 20:70] = 1
        for crowd in (1, 0):
            aid += 1
            data['annotations'].append({
                'id': aid, 'image_id': img['id'], 'category_id': 1,
                'bbox': [20.0, 10.0, 50.0, 40.0], 'area': 2000.0,
                'iscrowd': crowd, 'segmentation': jc.encode_mask(m)})
    with open(ann_file, 'w') as f:
        json.dump(data, f)


def _seeded(ds):
    """One fixed RandomState per sample index on either side."""
    pre = ds.pre_pipeline
    ds.pre_pipeline = lambda idx: dict(pre(idx),
                                       _rng=np.random.RandomState(idx))
    return ds


@pytest.fixture(scope='module')
def coco_set(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('coco')
    ann_file, img_dir = make_synthetic_coco(tmp)
    _with_crowd_and_rle(ann_file)
    return ann_file, img_dir


def _pair(coco_set, split, seeded=True, **kw):
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.data import build_dataset
    ann_file, img_dir = coco_set
    data = _flagship_data()
    cfg = dict(data[split], ann_file=ann_file, img_prefix=img_dir,
               data_root=None, **kw)
    args = dict(test_mode=split == 'test', max_gts=data['max_gts'],
                mask_crop_size=data['mask_crop_size'])
    ref, got = jax_build(cfg, args), build_dataset(cfg, args)
    return (_seeded(ref), _seeded(got)) if seeded else (ref, got)


@pytest.mark.parametrize('split', ['test', 'train'])
def test_dataset_arrays_bit_identical(coco_set, split):
    ref_ds, ds = _pair(coco_set, split)
    assert len(ds) == len(ref_ds) == 6
    np.testing.assert_array_equal(ds.flags, ref_ds.flags)
    flipped = 0
    for i in range(len(ds)):
        ref, got = ref_ds[i], ds[i]
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        flipped += bool(got['flip'])
        assert got['image'].shape in ((800, 1344, 3), (1344, 800, 3))
    if split == 'train':
        assert 0 < flipped < len(ds)
        assert got['gt_crops'].shape == (100, 128, 128)
        crowd = [ds[i]['gt_ignore_valid'].sum() for i in range(3)]
        assert crowd == [1, 1, 1]


def test_ann_info_and_filtering_equal(coco_set):
    ref_ds, ds = _pair(coco_set, 'train')
    assert [i['id'] for i in ds.img_infos] == \
        [i['id'] for i in ref_ds.img_infos]
    assert ds.cat_ids == ref_ds.cat_ids and ds.cat2label == ref_ds.cat2label
    for i in range(len(ds)):
        ref, got = ref_ds.get_ann_info(i), ds.get_ann_info(i)
        for k in ('bboxes', 'labels', 'bboxes_ignore'):
            np.testing.assert_array_equal(got[k], ref[k])
        assert got['masks'] == ref['masks']
        assert ds.sample_id(i) == ref_ds.sample_id(i)


@pytest.mark.parametrize('mode,scales', [
    ('range', [(1333, 640), (1333, 800)]),
    ('value', [(1333, 640), (1333, 720), (1333, 800)])])
def test_multiscale_resize_equal(coco_set, mode, scales):
    """The r101-3x style multiscale resize draws the same scale from the
    same rng on both sides."""
    pipeline = [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations', with_bbox=True, with_mask=True),
        dict(type='Resize', img_scale=scales, multiscale_mode=mode,
             keep_ratio=True),
        dict(type='RandomFlip', flip_ratio=0.5),
        dict(type='Normalize', mean=[123.675, 116.28, 103.53],
             std=[58.395, 57.12, 57.375], to_rgb=True),
        dict(type='Pad', size_divisor=32)]
    ref_ds, ds = _pair(coco_set, 'train', pipeline=pipeline)
    sizes = set()
    for i in range(len(ds)):
        ref, got = ref_ds[i], ds[i]
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        sizes.add(tuple(got['img_shape']))
    assert len(sizes) > 2


def test_collate_gives_tensors(coco_set):
    from dynamask_tpu.data import collate as jax_collate
    from dynamask_torch.data import collate
    ref_ds, ds = _pair(coco_set, 'train')
    idx = [i for i in range(len(ds)) if ds.flags[i] == 0][:2]
    ref = jax_collate([ref_ds[i] for i in idx])
    got = collate([ds[i] for i in idx])
    for k in ref:
        assert isinstance(got[k], torch.Tensor), k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert got['gt_labels'].dtype == torch.int32
    assert got['gt_valid'].dtype == torch.bool


@pytest.mark.parametrize('shuffle,workers', [(True, 0), (False, 0),
                                             (True, 2)])
def test_loader_batch_order_equal(coco_set, shuffle, workers):
    from dynamask_tpu.data import build_dataloader as jax_loader
    from dynamask_torch.data import build_dataloader
    # the test pipeline draws nothing: unseeded datasets, which pickle for
    # the worker processes
    ref_ds, ds = _pair(coco_set, 'test', seeded=False)
    ref = jax_loader(ref_ds, samples_per_gpu=2, workers_per_gpu=2,
                     shuffle=shuffle, seed=3)
    got = build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=workers,
                           shuffle=shuffle, seed=3)
    assert len(got) == len(ref)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        got.batch_sampler.set_epoch(epoch)
        ref_ids = [b['img_id'].tolist() for b in ref]
        got_ids = [b['img_id'].tolist() for b in got]
        assert got_ids == ref_ids
        if not shuffle:   # evaluation order: every image, groups padded
            assert set(sum(got_ids, [])) == {ds.sample_id(i)
                                             for i in range(len(ds))}


def test_grouped_sampler_equal_with_padding():
    from dynamask_tpu.data import GroupedBatchSampler as JaxSampler
    from dynamask_torch.data import GroupedBatchSampler
    flags = np.random.RandomState(0).randint(0, 2, 23)
    for kw in (dict(shuffle=True, drop_last=True),
               dict(shuffle=False, drop_last=False),
               dict(shuffle=True, drop_last=False, num_shards=2,
                    shard_index=1)):
        ref, got = JaxSampler(flags, 4, seed=5, **kw), \
            GroupedBatchSampler(flags, 4, seed=5, **kw)
        for epoch in (0, 1, 2):
            ref.set_epoch(epoch)
            got.set_epoch(epoch)
            assert [list(map(int, b)) for b in got] == \
                [list(map(int, b)) for b in ref]
            assert len(got) == len(ref)


def test_evaluate_equal_and_gt_predictions(coco_set, capsys):
    """GT-as-predictions (boxes at score 0.9, masks from the polygons) give
    1.0 box and mask AP, and the same table as the JAX evaluate."""
    from dynamask_torch.data import decode_rle, polygons_to_mask
    ref_ds, ds = _pair(coco_set, 'test')
    results = []
    for i, info in enumerate(ds.img_infos):
        ann = ds.get_ann_info(i)
        n = len(ann['bboxes'])
        masks = [polygons_to_mask(m, info['height'], info['width'])
                 if isinstance(m, list) else decode_rle(m)
                 for m in ann['masks']]
        results.append({
            'img_id': info['id'],
            'dets': np.concatenate([ann['bboxes'],
                                    np.full((n, 1), 0.9, np.float32)], 1),
            'labels': ann['labels'], 'valid': np.ones(n, bool),
            'masks': masks})
    metric = ['bbox', 'segm']
    got = ds.evaluate(results, metric=metric, classwise=True)
    table = capsys.readouterr().out
    assert got == ref_ds.evaluate(results, metric=metric, classwise=True)
    assert table == capsys.readouterr().out
    assert 'per-category segm AP' in table and 'person' in table
    assert got['bbox_mAP'] == 1.0 and got['segm_mAP'] == 1.0


def test_not_ported_parts_raise(coco_set):
    """The proposal metrics, refused here until they were ported, give the
    JAX package's values (on no results: every GT missed); a metric no COCO
    set has and a dataset type the port lacks (WIDER Face, which waits for
    SSD) still raise."""
    from dynamask_torch.data import build_dataset
    ref_ds, ds = _pair(coco_set, 'test')
    for metric in ('proposal', 'proposal_fast'):
        assert ds.evaluate([], metric=[metric]) == \
            ref_ds.evaluate([], metric=[metric])
    np.testing.assert_array_equal(ds.fast_eval_recall([]),
                                  ref_ds.fast_eval_recall([]))
    with pytest.raises(KeyError, match='mAP'):
        ds.evaluate([], metric=['mAP'])
    with pytest.raises(KeyError, match='WIDERFaceDataset'):
        build_dataset(dict(type='WIDERFaceDataset', ann_file='x.txt',
                           pipeline=[]))
    # the dataset wrappers are ported: build_dataset builds them
    ann_file, img_dir = coco_set
    inner = dict(_flagship_data()['test'], ann_file=ann_file,
                 img_prefix=img_dir, data_root=None)
    assert len(build_dataset(dict(type='RepeatDataset', times=2,
                                  dataset=inner),
                             dict(test_mode=True))) == 2 * len(ds)


def test_imports_without_jax():
    """No module of the port's data, engine, apis, utils or CLIs, nor
    guided anchoring's or DetectoRS' model modules, imports jax or the JAX
    package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['dynamask_tpu'] = None; "
            "import dynamask_torch.data, dynamask_torch.apis, "
            "dynamask_torch.models.guided_anchor, "
            "dynamask_torch.models.detectors_resnet, "
            "dynamask_torch.models.necks_extra, "
            "dynamask_torch.models.single_stage_builder, "
            "dynamask_torch.tools.test, dynamask_torch.tools.train, "
            "dynamask_torch.engine.checkpoint, "
            "dynamask_torch.engine.pretrained, "
            "dynamask_torch.data.dataset_wrappers, "
            "dynamask_torch.utils.env; "
            "dynamask_torch.utils.env.collect_env(); "
            "assert not [m for m in sys.modules if m.startswith('jax.')]")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)
