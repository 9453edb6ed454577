"""VOC, the custom middle format and precomputed proposals: the port's host
side against the JAX package's, on the CPU.

- ``core.eval_map`` ('area' and '11points', difficult GTs) and
  ``core.eval_recalls`` against JAX's on seeded dets: equal to 1e-12.
- ``VOCDataset`` on a synthetic VOC2007 layout (noise JPEGs, XML with
  difficult objects and a class outside VOC's) and ``CustomDataset`` on a
  json list: ann info equal, batches bit-identical through the VOC
  config's own pipelines (seeded flips), the config's
  ``RepeatDataset(ConcatDataset)`` train set, ``evaluate`` equal.
- ``LoadProposals`` + a ``proposal_file``: the Fast R-CNN config's test
  and train batches bit-identical to JAX's (the proposals resized,
  flipped and padded to 1000 with their validity), the set pickled for a
  loader worker without its proposals, and
  ``fast_eval_recall`` / the ``proposal`` and ``proposal_fast`` metrics
  equal to JAX's.
- The box-only test loop: a mini Faster R-CNN over the VOC set
  (``single_device_test`` gives boxes, no masks; the VOC mAP of its
  results), and a mini RPN over a COCO set whose ``proposal_lists``
  become the ``proposal_file`` a mini Fast R-CNN's test set reads, as the
  eval CLI's ``--out r.pkl`` writes it; the CLI's ``--eval mAP`` and
  ``proposal_fast``.
"""

import copy
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_CFG = os.path.join(ROOT,
                       'configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py')
FAST_CFG = os.path.join(ROOT, 'configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py')
SIZES = ((500, 375), (375, 500), (353, 500), (500, 333))      # w x h


def write_voc(root, year='VOC2007', split='test', per_size=2, seed=0):
    """A seeded VOC layout under ``root/year``: noise JPEGs at VOC sizes,
    each with 2-6 objects (one difficult in three, one in seven of the
    class 'unicorn', which no VOC set has), and the split's id list."""
    import cv2
    from dynamask_torch.data import VOC_CLASSES
    rng = np.random.RandomState(seed)
    base = os.path.join(root, year)
    for d in ('JPEGImages', 'Annotations', 'ImageSets/Main'):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = []
    for i in range(per_size * len(SIZES)):
        w, h = SIZES[i // per_size]
        img_id = f'{i:06d}'
        ids.append(img_id)
        cv2.imwrite(os.path.join(base, 'JPEGImages', f'{img_id}.jpg'),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        objs = []
        for _ in range(rng.randint(2, 7)):
            bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
            x, y = rng.randint(1, w - bw), rng.randint(1, h - bh)
            name = ('unicorn' if rng.rand() < 1 / 7 else
                    VOC_CLASSES[rng.randint(len(VOC_CLASSES))])
            objs.append(
                f'<object><name>{name}</name><difficult>'
                f'{int(rng.rand() < 1 / 3)}</difficult><bndbox><xmin>{x}'
                f'</xmin><ymin>{y}</ymin><xmax>{x + bw}</xmax><ymax>'
                f'{y + bh}</ymax></bndbox></object>')
        with open(os.path.join(base, 'Annotations', f'{img_id}.xml'),
                  'w') as f:
            f.write(f'<annotation><size><width>{w}</width><height>{h}'
                    f'</height><depth>3</depth></size>{"".join(objs)}'
                    '</annotation>')
    with open(os.path.join(base, 'ImageSets/Main', f'{split}.txt'),
              'w') as f:
        f.write('\n'.join(ids) + '\n')
    return root


@pytest.fixture(scope='module')
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('voc'))
    write_voc(root, 'VOC2007', 'test')
    write_voc(root, 'VOC2007', 'trainval', seed=1)
    write_voc(root, 'VOC2012', 'trainval', seed=2)
    return root


def _data(path):
    from dynamask_torch.utils.config import Config
    return Config.fromfile(path).to_dict()['data']


def _voc_cfg(voc_root, split):
    """The VOC config's ``data[split]`` over the synthetic layout."""
    cfg = copy.deepcopy(_data(VOC_CFG)[split])
    inner = [cfg] if cfg['type'] == 'VOCDataset' else \
        cfg['dataset']['datasets']
    for c in inner:
        c['data_root'] = voc_root
    return cfg


def _seeded(ds):
    """One fixed RandomState per sample index (both sides' pipelines read
    ``_rng``)."""
    pre = ds.pre_pipeline
    ds.pre_pipeline = lambda idx: dict(pre(idx),
                                       _rng=np.random.RandomState(idx))
    return ds


def _inner(ds):
    while hasattr(ds, 'dataset') or hasattr(ds, 'datasets'):
        ds = ds.dataset if hasattr(ds, 'dataset') else ds.datasets[0]
    return ds


def _equal_samples(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# -- core.mean_ap --------------------------------------------------------------

def _dets_and_anns(seed, n_img=6, n_cls=4):
    rng = np.random.RandomState(seed)

    def boxes(n):
        xy = rng.uniform(0, 80, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1)

    dets, anns = [], []
    for _ in range(n_img):
        g = rng.randint(0, 6)
        gt = boxes(g).astype(np.float32)
        per = []
        for c in range(n_cls):
            k = rng.randint(0, 5)
            near = gt[rng.randint(0, max(g, 1), k)] + rng.normal(
                0, 3, (k, 4)) if g else boxes(k)
            per.append(np.concatenate([near, rng.uniform(0, 1, (k, 1))],
                                      1).astype(np.float32))
        ig = rng.randint(0, 2)
        anns.append(dict(bboxes=gt, labels=rng.randint(0, n_cls, g),
                         bboxes_ignore=boxes(ig).astype(np.float32),
                         labels_ignore=rng.randint(0, n_cls, ig)))
        dets.append(per)
    return dets, anns


@pytest.mark.parametrize('mode', ['area', '11points'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_eval_map_matches_jax(mode, seed):
    from dynamask_tpu.core.mean_ap import eval_map as jmap
    from dynamask_torch.core import eval_map
    dets, anns = _dets_and_anns(seed)
    ref, ref_cls = jmap(dets, anns, 0.5, mode)
    got, got_cls = eval_map(dets, anns, 0.5, mode)
    assert 0 < ref < 1
    assert abs(got - ref) <= 1e-12
    for r, g in zip(ref_cls, got_cls):
        assert r.keys() == g.keys()
        for k in r:
            assert abs(float(g[k]) - float(r[k])) <= 1e-12, k


def test_eval_recalls_matches_jax():
    from dynamask_tpu.core.mean_ap import eval_recalls as jrec
    from dynamask_torch.core import eval_recalls
    dets, anns = _dets_and_anns(4, n_img=8)
    gts = [a['bboxes'] for a in anns]
    props = [np.concatenate(d, 0) for d in dets]
    props = [p[np.argsort(-p[:, 4])] for p in props]
    thrs = np.arange(0.5, 0.96, 0.05)
    ref = jrec(gts, props, (1, 3, 10), thrs)
    got = eval_recalls(gts, props, (1, 3, 10), thrs)
    assert ref.max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# -- VOCDataset / CustomDataset ------------------------------------------------

@pytest.mark.parametrize('split', ['test', 'train'])
def test_voc_batches_bit_identical(voc_root, split):
    """The VOC config's test set (VOC2007 test) and train set
    (``RepeatDataset(ConcatDataset([VOC2007, VOC2012]), 3)``): length,
    flags, ann info, every sample bit for bit."""
    from dynamask_tpu.data import build_dataset as jbuild
    from dynamask_torch.data import build_dataset
    data = _data(VOC_CFG)
    cfg = _voc_cfg(voc_root, split)
    args = dict(test_mode=split == 'test', max_gts=data['max_gts'],
                mask_crop_size=data['mask_crop_size'])
    ref, got = jbuild(cfg, args), build_dataset(cfg, args)
    assert len(got) == len(ref) == (8 if split == 'test' else 3 * 16)
    np.testing.assert_array_equal(got.flags, ref.flags)
    for d in ([got] if split == 'test' else got.dataset.datasets):
        _seeded(d)
    for d in ([ref] if split == 'test' else ref.dataset.datasets):
        _seeded(d)
    gi, ri = _inner(got), _inner(ref)
    assert gi.CLASSES == ri.CLASSES and len(gi.CLASSES) == 20
    assert gi.year == ri.year == 2007
    for i in range(len(gi)):
        _equal_samples(gi.get_ann_info(i), {
            k: v for k, v in ri.get_ann_info(i).items()})
    n_ig = sum(len(gi.get_ann_info(i)['bboxes_ignore'])
               for i in range(len(gi)))
    assert n_ig > 0
    for i in range(0, len(got), 5 if split == 'train' else 1):
        _equal_samples(got[i], ref[i])
    if split == 'train':
        assert 'gt_boxes' in got[0] and 'gt_crops' not in got[0]


def test_voc_evaluate_matches_jax(voc_root):
    """mAP (VOC2007: '11points') and recall of dets near the GTs, on both
    sides; 'bbox' is 'mAP'; a COCO metric raises."""
    from dynamask_tpu.data import build_dataset as jbuild
    from dynamask_torch.data import build_dataset
    cfg = _voc_cfg(voc_root, 'test')
    ref = jbuild(cfg, dict(test_mode=True))
    got = build_dataset(cfg, dict(test_mode=True))
    rng = np.random.RandomState(0)
    results = []
    for i in range(len(got)):
        ann = got.get_ann_info(i)
        xy = rng.uniform(0, 300, (3, 2))
        boxes = np.concatenate([ann['bboxes'] + rng.normal(0, 4, (len(
            ann['bboxes']), 4)), np.concatenate([xy, xy + 60], 1)])
        n = len(boxes)
        results.append(dict(
            img_id=i, dets=np.concatenate([boxes, rng.uniform(
                0, 1, (n, 1))], 1).astype(np.float32),
            labels=np.concatenate([ann['labels'], rng.randint(0, 20, 3)]),
            valid=rng.uniform(size=n) > 0.1))
    for metric in (['mAP'], ['bbox'], ['mAP', 'recall']):
        want = ref.evaluate(results, metric=metric)
        have = got.evaluate(results, metric=metric)
        assert have == want and 0 < want['mAP'] < 1
    with pytest.raises(KeyError, match='segm'):
        got.evaluate(results, metric=['segm'])


def test_custom_dataset_matches_jax(tmp_path):
    from dynamask_tpu.data import build_dataset as jbuild
    from dynamask_torch.data import build_dataset
    import cv2
    rng = np.random.RandomState(5)
    infos = []
    for i in range(5):
        w, h = (96, 64) if i % 2 else (64, 96)
        name = f'{i}.jpg'
        cv2.imwrite(str(tmp_path / name),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        n = i % 3
        xy = rng.uniform(0, 30, (n, 2))
        infos.append(dict(filename=name, width=w, height=h, ann=dict(
            bboxes=np.concatenate([xy, xy + 20], 1).tolist(),
            labels=rng.randint(0, 3, n).tolist(),
            bboxes_ignore=[[1., 1., 9., 9.]] if i == 1 else [],
            labels_ignore=[2] if i == 1 else [])))
    ann = tmp_path / 'ann.pkl'
    with open(ann, 'wb') as f:
        pickle.dump(infos, f)
    pipe = [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True),
            dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
            dict(type='RandomFlip', flip_ratio=0.5),
            dict(type='Pad', size_divisor=32)]
    cfg = dict(type='CustomDataset', ann_file=str(ann),
               img_prefix=str(tmp_path), pipeline=pipe,
               classes=('a', 'b', 'c'))
    ref, got = _seeded(jbuild(cfg)), _seeded(build_dataset(cfg))
    assert len(got) == len(ref) == 3     # the images without GTs dropped
    for i in range(len(got)):
        _equal_samples(got.get_ann_info(i), ref.get_ann_info(i))
        _equal_samples(got[i], ref[i])
    results = [dict(img_id=i, dets=np.concatenate([
        got.get_ann_info(i)['bboxes'], np.full((len(got.get_ann_info(i)[
            'bboxes']), 1), 0.9)], 1), labels=got.get_ann_info(i)['labels'],
        valid=np.ones(len(got.get_ann_info(i)['labels']), bool))
        for i in range(len(got))]
    assert got.evaluate(results) == ref.evaluate(results) == {'mAP': 1.0}


# -- proposals -----------------------------------------------------------------

@pytest.fixture(scope='module')
def coco_props(tmp_path_factory):
    """A COCO set of the eval slice's recipe, and a seeded proposal file
    for it: per image 30-60 (N, 5) proposals, scores descending."""
    from test_torch_port_eval_slice import make_set
    root = tmp_path_factory.mktemp('props')
    ann_file, img_dir = make_set(root)
    rng = np.random.RandomState(9)
    from dynamask_torch.data.coco import CocoIndex
    plist = []
    for img in CocoIndex(ann_file).imgs.values():
        n = rng.randint(30, 61)
        xy = rng.uniform(0, [img['width'] - 20, img['height'] - 20], (n, 2))
        p = np.concatenate([xy, xy + rng.uniform(8, 60, (n, 2)),
                            np.sort(rng.uniform(size=(n, 1)), 0)[::-1]], 1)
        plist.append(p.astype(np.float32))
    prop_file = str(root / 'proposals.pkl')
    with open(prop_file, 'wb') as f:
        pickle.dump(plist, f)
    return ann_file, img_dir, prop_file, plist


def _fast_cfg(coco_props, split):
    ann_file, img_dir, prop_file, _ = coco_props
    cfg = copy.deepcopy(_data(FAST_CFG)[split])
    cfg.update(ann_file=ann_file, img_prefix=img_dir, data_root=None,
               proposal_file=prop_file)
    return cfg


@pytest.mark.parametrize('split', ['test', 'train'])
def test_proposal_batches_bit_identical(coco_props, split):
    """The Fast R-CNN config's pipelines (``LoadProposals`` with 2000 and
    with no cap) over the proposal file: every sample bit for bit, the
    proposals scaled (and flipped) with the image, 1000 slots and their
    validity."""
    from dynamask_tpu.data import build_dataset as jbuild
    from dynamask_torch.data import build_dataset
    cfg = _fast_cfg(coco_props, split)
    args = dict(test_mode=split == 'test')
    ref, got = _seeded(jbuild(cfg, args)), _seeded(build_dataset(cfg, args))
    assert len(got) == len(ref) > 0
    flips = 0
    for i in range(len(got)):
        a, b = got[i], ref[i]
        _equal_samples(a, b)
        assert a['proposals'].shape == (1000, 4)
        n = int(a['proposal_valid'].sum())
        assert 30 <= n <= 60 and not a['proposals'][n:].any()
        flips += int(a['flip'])
    assert split == 'test' or flips > 0


def test_proposal_set_pickles_without_its_proposals(coco_props):
    """A loader worker gets the dataset without its proposals and reads
    the file itself (a pickle over a pipe's 64 KiB would start the spawned
    workers one at a time), and the unpickled set gives the same
    samples."""
    from dynamask_torch.data import build_dataset
    ds = build_dataset(_fast_cfg(coco_props, 'test'), dict(test_mode=True))
    assert ds.proposals is not None
    twin = pickle.loads(pickle.dumps(ds))
    assert twin._proposals is None
    for i in range(len(ds)):
        _equal_samples(twin[i], ds[i])


def test_fast_eval_recall_and_proposal_metrics(coco_props):
    """Results holding proposals (an RPN's) and results holding dets:
    ``fast_eval_recall`` and the 'proposal' / 'proposal_fast' metrics equal
    to JAX's."""
    from dynamask_tpu.data import build_dataset as jbuild
    from dynamask_torch.data import build_dataset
    _, _, _, plist = coco_props
    cfg = _fast_cfg(coco_props, 'test')
    ref = jbuild(cfg, dict(test_mode=True))
    got = build_dataset(cfg, dict(test_mode=True))
    as_props = [dict(img_id=info['id'], proposals=p, dets=p,
                     labels=np.zeros(len(p), np.int64),
                     valid=np.ones(len(p), bool))
                for info, p in zip(got.img_infos, plist)]
    as_dets = [{k: v for k, v in r.items() if k != 'proposals'}
               for r in as_props]
    for results in (as_props, as_dets):
        np.testing.assert_array_equal(
            got.fast_eval_recall(results, (10, 30, 100)),
            ref.fast_eval_recall(results, (10, 30, 100)))
        want = ref.evaluate(results, metric=['proposal', 'proposal_fast'])
        assert got.evaluate(results, metric=['proposal',
                                             'proposal_fast']) == want
        assert want['AR@100'] > 0


# -- the box-only test loop ----------------------------------------------------

def _mini(kind):
    from test_torch_port_box_only import box_cfg
    from dynamask_torch.models import build_detector
    model, train_cfg, test_cfg = box_cfg(kind)
    if kind != 'rpn':
        model['roi_head']['bbox_head']['num_classes'] = 20
    return build_detector(model, train_cfg, test_cfg, device='cpu',
                          seed=1, init_std=0.05)


def test_faster_rcnn_test_loop_on_voc(voc_root):
    """A mini Faster R-CNN (20 classes) through ``single_device_test`` on
    the VOC test set: boxes only, each image's dets those of its own
    ``simple_test``; ``evaluate`` gives the VOC mAP."""
    from dynamask_torch.apis import single_device_test
    from dynamask_torch.data import build_dataset
    model = _mini('faster')
    cfg = _voc_cfg(voc_root, 'test')
    cfg['pipeline'][1]['img_scale'] = (96, 64)
    cfg['canvases'] = [(64, 96), (96, 64), (96, 96)]
    ds = build_dataset(cfg, dict(test_mode=True))
    results = single_device_test(model, ds, workers_per_gpu=0,
                                 progress=False)
    assert sorted(r['img_id'] for r in results) == list(range(len(ds)))
    for r in results[:3]:
        assert 'masks' not in r and 'proposals' not in r
        s = ds[r['img_id']]
        out = model.simple_test({k: torch.from_numpy(s[k])[None] for k in
                                 ('image', 'img_shape', 'scale_factor')})
        np.testing.assert_array_equal(r['dets'], out['dets'][0].numpy())
        np.testing.assert_array_equal(r['valid'], out['det_valid'][0])
    metrics = ds.evaluate(results, metric=['mAP'])
    assert set(metrics) == {'mAP'} and 0 <= metrics['mAP'] <= 1


def test_rpn_proposals_feed_fast_rcnn(coco_props, tmp_path, capsys):
    """A mini RPN's test loop writes its proposals (``proposal_lists``);
    the Fast R-CNN test set reading them as its ``proposal_file`` gives
    each image those proposals at the input's scale; a mini Fast R-CNN
    runs its test loop on them. Through the eval CLI: the RPN with
    ``--out r.pkl`` writes the same file, ``--eval proposal_fast`` prints
    the AR."""
    from test_torch_port_eval_slice import TEST_PIPELINE
    from dynamask_torch.apis import single_device_test
    from dynamask_torch.apis.test import proposal_lists
    from dynamask_torch.data import build_dataset
    from dynamask_torch.tools.test import main
    ann_file, img_dir, _, _ = coco_props
    canv = [(64, 96), (96, 64), (96, 96)]
    data = dict(type='CocoDataset', ann_file=ann_file, img_prefix=img_dir,
                pipeline=TEST_PIPELINE, canvases=canv)
    rpn = _mini('rpn')
    ds = build_dataset(data, dict(test_mode=True))
    results = single_device_test(rpn, ds, workers_per_gpu=0,
                                 progress=False)
    plist = proposal_lists(results)
    assert all(p.shape[1] == 5 and len(p) > 0 for p in plist)
    assert all(np.all(np.diff(p[:, 4]) <= 0) for p in plist)
    ar = ds.evaluate(results, metric=['proposal_fast'])
    assert set(ar) == {'AR@100', 'AR@300', 'AR@1000'}
    prop_file = str(tmp_path / 'rpn.pkl')
    with open(prop_file, 'wb') as f:
        pickle.dump(plist, f)
    fast_pipe = [TEST_PIPELINE[0], dict(type='LoadProposals',
                                        num_max_proposals=None),
                 *TEST_PIPELINE[1:]]
    fds = build_dataset(dict(data, pipeline=fast_pipe,
                             proposal_file=prop_file), dict(test_mode=True))
    s = fds[0]
    n = int(s['proposal_valid'].sum())
    assert n == len(plist[0])
    np.testing.assert_allclose(s['proposals'][:n], plist[0][:, :4] *
                               s['scale_factor'], rtol=1e-6, atol=1e-4)
    fast = _mini('fast')
    fres = single_device_test(fast, fds, workers_per_gpu=0, progress=False)
    assert len(fres) == len(fds) and 'masks' not in fres[0]

    # the eval CLI on a config of the mini RPN and this set
    from test_torch_port_box_only import box_cfg
    model, train_cfg, test_cfg = box_cfg('rpn')
    path = tmp_path / 'rpn_cfg.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        data=dict(workers_per_gpu=0, test=data)).items()))
    out = str(tmp_path / 'cli.pkl')
    assert main([str(path), '--device', 'cpu', '--eval', 'proposal_fast',
                 '--out', out]) == 0
    assert 'AR@1000' in capsys.readouterr().out
    with open(out, 'rb') as f:
        cli = pickle.load(f)
    assert len(cli) == len(plist)


def test_box_only_train_step_from_loader(voc_root, coco_props):
    """One ``train_steps`` step of the mini Faster R-CNN on a VOC train
    loader batch (no masks in the batch) and of the mini Fast R-CNN on a
    proposal-file batch (proposals in the batch): finite losses, box
    losses only."""
    from dynamask_torch.apis import train_steps
    from dynamask_torch.data import build_dataloader, build_dataset
    from dynamask_torch.engine import DetectorSGD
    voc = _voc_cfg(voc_root, 'train')
    for c in voc['dataset']['datasets']:
        c['pipeline'][2]['img_scale'] = (96, 64)
        c['canvases'] = [(64, 96), (96, 64), (96, 96)]
    fast = _fast_cfg(coco_props, 'train')
    fast['pipeline'][3]['img_scale'] = (96, 64)
    fast['canvases'] = [(64, 96), (96, 64), (96, 96)]
    for kind, cfg in (('faster', voc), ('fast', fast)):
        ds = build_dataset(cfg, dict(max_gts=20))
        batch = next(iter(build_dataloader(ds, 2, workers_per_gpu=0)))
        assert ('proposals' in batch) == (kind == 'fast')
        assert 'gt_crops' not in batch or kind == 'fast'
        model = _mini(kind).train()
        log, = train_steps(model, DetectorSGD(model, 0.01), [batch],
                           torch.Generator().manual_seed(0))
        assert {'loss_cls', 'loss_bbox', 'loss'} <= set(log)
        assert not any(k.startswith('loss_mask') for k in log)
        assert all(torch.isfinite(v) for v in log.values())
