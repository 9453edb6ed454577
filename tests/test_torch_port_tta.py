"""Test-time augmentation on the CPU: the port's ``aug_test`` and
``aug_device_test`` against the JAX package's on the same seeded inputs,
the JAX weights carried across by ``dynamask_torch.engine.convert``.

- The merge helpers and ``bbox_flip`` / ``bbox_mapping(_back)`` against
  JAX's (abs 1e-6).
- ``aug_test`` slot for slot on two augmentations of one image, the first
  at a scale of 1.25, the second at 1.5 and flipped, on canvases of their
  own: the mini Mask R-CNN of ``tests/test_models.py``, its box-only
  Faster R-CNN and the toy DynaMask in its faithful and its MSM-routed
  mode. Tolerances of the ``simple_test`` twins
  (``test_torch_port_slice.py``): dets rtol 1e-5 / atol 1e-4, labels and
  validity exact, mask probabilities atol 2e-4.
- Which RoI heads run: ``jax.eval_shape`` of JAX's ``aug_test`` on every
  RoI-head class the port builds (a trace, no compile); where it traces,
  the port's ``aug_test`` runs, where it raises, the port raises
  ``NotImplementedError``; the detectors JAX has no ``aug_test`` for are
  refused by name.
- ``aug_device_test`` over two images of ``make_synthetic_coco`` at two
  scales with flips against JAX's, the results' order and fields; a scale
  no canvas fits raises in both.
- The eval CLI: ``--tta`` exits non-zero on RetinaNet and runs with
  ``--fuse-conv-bn --device cpu`` on a toy set.

JAX's ``aug_test`` runs at ``jax.jit`` (it thresholds, ranks and
suppresses), one compile a program; the toys' inits at ``fast_jit`` with
``randomize_variables`` (the twins' weights), the other detectors'
variables drawn on the tree of ``jax.eval_shape(det.init)``.
"""

import copy
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import fast_jit, randomize_variables  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_RTOL, DET_ATOL = 1e-5, 1e-4
MASK_ATOL = 2e-4
FLIPS = [False, True]
# the original image and each augmentation's (scale, flip, canvas)
ORI_HW = (40, 48)
AUGS = [(1.25, False, (64, 64)), (1.5, True, (64, 96))]


def draw_variables(det, batch, seed=0):
    """The JAX detector's variables drawn from ``seed`` on the tree of
    ``jax.eval_shape(det.init)``: kernels N(0, 1 / fan-in), biases and BN
    means N(0, 0.1), norm scales and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(det.init, {'params': jax.random.PRNGKey(0)},
                            {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = path[-1].key
        if len(x.shape) >= 2:
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, x.shape).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0, 0.1, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def aug_batches(seed=0, b=1, augs=AUGS, ori_hw=ORI_HW):
    """One batch an augmentation of ``b`` seeded images of ``ori_hw``:
    each image resized by the augmentation's scale (cv2, bilinear),
    flipped in its resized region where the augmentation flips, and put at
    the top left of its canvas; ``img_shape`` the resized region,
    ``scale_factor`` its 4-vector."""
    import cv2
    rng = np.random.RandomState(seed)
    h, w = ori_hw
    images = rng.randn(b, h, w, 3).astype(np.float32)
    out = []
    for scale, flip, (ch, cw) in augs:
        nw, nh = int(w * scale + 0.5), int(h * scale + 0.5)
        canvas = np.zeros((b, ch, cw, 3), np.float32)
        for i in range(b):
            region = cv2.resize(images[i], (nw, nh),
                                interpolation=cv2.INTER_LINEAR)
            canvas[i, :nh, :nw] = region[:, ::-1] if flip else region
        sf = np.array([nw / w, nh / h] * 2, np.float32)
        out.append({'image': canvas,
                    'img_shape': np.tile([[nh, nw]], (b, 1)).astype(
                        np.float32),
                    'ori_shape': np.tile([[h, w]], (b, 1)).astype(
                        np.float32),
                    'scale_factor': np.tile(sf, (b, 1))})
    return out


# -- the merge helpers --------------------------------------------------------

def _boxes(rng, n=7, w=60.0, h=50.0):
    xy = rng.uniform(0, [w, h], (n, 2))
    wh = rng.uniform(1, 20, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize('flip', [False, True])
@pytest.mark.parametrize('fn', ['bbox_flip', 'bbox_mapping',
                                'bbox_mapping_back', 'recover_boxes',
                                'to_aug_frame'])
def test_box_maps_match_jax(fn, flip):
    """Every box map at a non-unit, anisotropic scale on a batch of
    (B, P, 4) boxes, the image shapes broadcast per image."""
    from dynamask_tpu.core import bbox_transforms as jb, merge_augs as jm
    from dynamask_torch.core import bbox_transforms as pb, merge_augs as pm
    rng = np.random.RandomState(3)
    boxes = np.stack([_boxes(rng), _boxes(rng)])
    shape = np.array([[50., 60.], [45., 70.]], np.float32)
    scale = np.array([[1.25, 1.5, 1.25, 1.5], [0.8, 0.75, 0.8, 0.75]],
                     np.float32)
    if fn == 'bbox_flip':
        direction = 'vertical' if flip else 'horizontal'
        ref = jax.vmap(lambda bx, sh: jb.bbox_flip(bx, sh, direction))(
            boxes, shape)
        got = pb.bbox_flip(torch.from_numpy(boxes),
                           torch.from_numpy(shape)[:, None], direction)
    else:
        jfn = getattr(jb if fn.startswith('bbox') else jm, fn)
        pfn = getattr(pb if fn.startswith('bbox') else pm, fn)
        ref = jax.vmap(lambda bx, sh, sc: jfn(bx, sh, sc, flip))(
            boxes, shape, scale)
        got = pfn(torch.from_numpy(boxes), torch.from_numpy(shape)[:, None],
                  torch.from_numpy(scale)[:, None], flip)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_round_trip_and_mask_merge_match_jax():
    """``recover_boxes`` undoes ``to_aug_frame``; ``merge_aug_bboxes``,
    ``merge_aug_scores`` and ``merge_aug_masks`` (flipped back on the last
    axis) equal JAX's."""
    from dynamask_tpu.core import merge_augs as jm
    from dynamask_torch.core import merge_augs as pm
    rng = np.random.RandomState(4)
    boxes = _boxes(rng)
    shape, scale = np.array([50., 60.]), np.array([2., 1.5, 2., 1.5])
    t = torch.from_numpy(boxes)
    back = pm.recover_boxes(pm.to_aug_frame(t, shape, scale, True), shape,
                            scale, True)
    np.testing.assert_allclose(back.numpy(), boxes, atol=1e-5)
    masks = [rng.uniform(size=(2, 3, 5, 5)).astype(np.float32)
             for _ in range(3)]
    flips = [False, True, True]
    np.testing.assert_allclose(
        pm.merge_aug_masks([torch.from_numpy(m) for m in masks],
                           flips).numpy(),
        np.asarray(jm.merge_aug_masks([jnp.asarray(m) for m in masks],
                                      flips)), atol=1e-6)
    scores = [rng.uniform(size=(4, 9)).astype(np.float32) for _ in range(3)]
    bxs = [_boxes(rng, 4) for _ in range(3)]
    got = pm.merge_aug_bboxes([torch.from_numpy(b) for b in bxs],
                              [torch.from_numpy(s) for s in scores])
    ref = jm.merge_aug_bboxes([jnp.asarray(b) for b in bxs],
                              [jnp.asarray(s) for s in scores])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    np.testing.assert_allclose(
        pm.merge_aug_scores([torch.from_numpy(s) for s in scores]).numpy(),
        np.asarray(jm.merge_aug_scores([jnp.asarray(s) for s in scores])),
        atol=1e-6)


# -- aug_test against JAX's ---------------------------------------------------

def toy_cfg(kind):
    """(model, train_cfg, test_cfg) of the toy ``kind``."""
    from test_dynamask import dynamask_toy_cfg
    from test_models import mini_mask_rcnn_cfg
    if kind.startswith('dynamask'):
        model, train_cfg, test_cfg = dynamask_toy_cfg()
        model['roi_head'].update(dynamic_inference=kind == 'dynamask_dynamic',
                                 dynamic_capacity=(1.0, 0.5, 0.25))
        return model, train_cfg, test_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    if kind == 'faster_rcnn':
        model['type'] = 'FasterRCNN'
        rh = model['roi_head']
        rh['mask_head'] = rh['mask_roi_extractor'] = None
    return model, train_cfg, test_cfg


def _init_batch():
    from test_models import demo_batch
    return {k: np.asarray(v) for k, v in
            demo_batch(0, b=1, h=64, w=64, g=3, s=16).items()}


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its drawn variables, the port loaded from
    them). The DynaMask modes share one tree of variables."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    det = jax_build(*copy.deepcopy(cfg))
    if kind == 'dynamask_dynamic':
        variables = twin('dynamask_faithful')[1]
    else:
        variables = randomize_variables(fast_jit(det.init)(
            {'params': jax.random.PRNGKey(0)},
            {k: jnp.asarray(v) for k, v in _init_batch().items()}))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


def jax_aug_test(det, variables, batches, flips):
    fn = jax.jit(lambda v, bs: det.apply(v, bs, list(flips),
                                         method='aug_test'))
    out = fn(variables, [{k: jnp.asarray(v) for k, v in b.items()}
                         for b in batches])
    return jax.tree_util.tree_map(np.asarray, out)


def port_aug_test(port, batches, flips):
    return port.aug_test([{k: torch.from_numpy(v) for k, v in b.items()}
                          for b in batches], flips)


def check_aug_out(got, ref, masks=True):
    """The twins' ``simple_test`` comparison."""
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'],
                               rtol=DET_RTOL, atol=DET_ATOL)
    assert ('mask_probs' in got) == masks == ('mask_probs' in ref)
    if masks:
        np.testing.assert_allclose(got['mask_probs'].numpy(),
                                   ref['mask_probs'], atol=MASK_ATOL)


AUG_KINDS = ['mask_rcnn', 'faster_rcnn', 'dynamask_faithful',
             'dynamask_dynamic']


@pytest.mark.parametrize('kind', AUG_KINDS)
def test_aug_test_matches_jax(kind):
    """Both frames differ from the original (scale 1.25, then 1.5 and
    flipped): a box flipped in the padded canvas, or scaled after the
    flip, would part from JAX's here."""
    det, variables, port = twin(kind)
    batches = aug_batches()
    ref = jax_aug_test(det, variables, batches, FLIPS)
    got = port_aug_test(port, batches, FLIPS)
    valid = ref['det_valid'][0].astype(bool)
    assert valid.sum() >= 3
    scores = np.sort(ref['dets'][0, valid, 4])
    print(kind, 'valid', valid.sum(), 'least score gap',
          np.min(np.diff(scores)))
    check_aug_out(got, ref, masks=kind != 'faster_rcnn')


# -- which RoI heads run ------------------------------------------------------

def head_cfg(kind):
    """(model, train_cfg, test_cfg) of a toy of each RoI-head class the
    port builds, from the port tests that hold that head."""
    import test_torch_port_cascade as cascade
    import test_torch_port_item9_c4 as c4
    import test_torch_port_item9_detectors as item9
    import test_torch_port_item9_dpool as dpool
    import test_torch_port_item9_pisa_detectors as pisa
    import test_torch_port_refinemask as refine
    import test_torch_port_two_stage_twins as two_stage
    if kind in ('cascade', 'htc_nosem'):
        return cascade.toy_cfg(kind)
    if kind in ('dh', 'groie'):
        return two_stage.toy_cfg(kind)
    if kind in ('point_refine', 'point_rend', 'ms_rcnn', 'grid', 'dynamic'):
        return item9.toy_cfg(kind)
    if kind in ('refine', 'simple'):
        return refine.toy_cfg(kind)
    return {'c4': lambda: c4.c4_toy_cfg('mask'),
            'pisa': pisa.pisa_two_stage_cfg,
            'dpool': lambda: dpool.dpool_toy_cfg(False)}[kind]()


# each toy's RoI head, and whether JAX's aug_test traces on it (the
# mini Mask and Faster R-CNN's and DynaMask's run it in
# test_aug_test_matches_jax)
HEAD_KINDS = {
    'groie': ('StandardRoIHead', True),
    'pisa': ('PISARoIHead', True),
    'ms_rcnn': ('MaskScoringRoIHead', True),
    'point_rend': ('PointRendRoIHead', True),
    'point_refine': ('PointRefineRoIHead', True),
    'refine': ('RefineRoIHead', True),
    'simple': ('SimpleRefineRoIHead', True),
    'dynamic': ('DynamicRoIHead', True),
    'dpool': ('StandardRoIHead', True),
    'cascade': ('CascadeRoIHead', False),
    'htc_nosem': ('HybridTaskCascadeRoIHead', False),
    'dh': ('DoubleHeadRoIHead', False),
    'grid': ('GridRoIHead', False),
    'c4': ('StandardRoIHead', False),
}


def jax_aug_test_shapes(kind):
    """``jax.eval_shape`` of JAX's ``aug_test`` on the toy (a trace), or
    the exception it raises."""
    from dynamask_tpu.models import build_detector as jax_build
    det = jax_build(*copy.deepcopy(head_cfg(kind)))
    init = {k: jnp.asarray(v) for k, v in _init_batch().items()}
    if kind in ('refine', 'simple', 'point_refine'):
        init['gt_semantic'] = jnp.zeros((1, 16, 16), jnp.uint8)
    shapes = jax.eval_shape(det.init, {'params': jax.random.PRNGKey(0)},
                            init)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in aug_batches()]
    try:
        return jax.eval_shape(
            lambda v, bs: det.apply(v, bs, FLIPS, method='aug_test'),
            shapes, batches)
    except Exception as e:  # noqa: BLE001 - which heads JAX refuses
        return e


@pytest.mark.parametrize('kind', sorted(HEAD_KINDS))
def test_heads_that_run_tta_are_jaxs(kind):
    """Where JAX's ``aug_test`` traces, the port's runs, with JAX's output
    shapes; where it raises, the port raises ``NotImplementedError``
    naming why (the port's toy at its own random init, on the CPU)."""
    from dynamask_torch.models import build_detector
    head, runs = HEAD_KINDS[kind]
    ref = jax_aug_test_shapes(kind)
    assert isinstance(ref, Exception) != runs, ref
    port = build_detector(*head_cfg(kind), device='cpu', seed=0)
    assert type(port.roi_head).__name__ == head
    if not runs:
        with pytest.raises(NotImplementedError, match='JAX'):
            port_aug_test(port, aug_batches(), FLIPS)
        return
    got = port_aug_test(port, aug_batches(), FLIPS)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


@pytest.mark.parametrize('rel', [
    'retinanet/retinanet_r50_fpn_1x_coco.py', 'rpn/rpn_r50_fpn_1x_coco.py',
    'fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py',
    'guided_anchoring/ga_faster_r50_caffe_fpn_1x_coco.py'])
def test_detectors_without_aug_test_refused(rel):
    """The single-stage detectors, ``RPN``, ``FastRCNN`` and
    ``GAFasterRCNN`` have no ``aug_test`` in JAX: the port refuses them
    by name."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_tpu.utils.config import Config as JConfig
    from dynamask_torch.apis.test import check_aug_test
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    jcfg = JConfig.fromfile(os.path.join(ROOT, 'configs', rel))
    det = jax_build(jcfg.model, jcfg.get('train_cfg'), jcfg.get('test_cfg'))
    assert not hasattr(det, 'aug_test')
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', rel))
    port = build_detector(cfg.model, cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')
    name = type(port).__name__
    assert name == type(det).__name__
    with pytest.raises(NotImplementedError, match=name):
        check_aug_test(port)


# -- aug_device_test against JAX's --------------------------------------------

CANVAS = (192, 192)
TTA_SCALES = [(160, 128), (192, 160)]
TEST_PIPELINE = [dict(type='LoadImageFromFile'),
                 dict(type='Resize', img_scale=(160, 128), keep_ratio=True),
                 dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                      std=[58.395, 57.12, 57.375], to_rgb=True),
                 dict(type='Pad', size_divisor=32)]


def coco_cfg(ann_file, img_dir):
    return dict(type='CocoDataset', ann_file=ann_file, img_prefix=img_dir,
                pipeline=TEST_PIPELINE, canvases=[CANVAS], max_gts=10,
                mask_crop_size=32)


@pytest.fixture(scope='module')
def coco_set(tmp_path_factory):
    """Two images of ``make_synthetic_coco``, one landscape (120x160) and
    one portrait (160x120): at both scales each fits the one 192x192
    canvas, so JAX compiles its ``aug_test`` once."""
    from test_data import make_synthetic_coco
    return make_synthetic_coco(tmp_path_factory.mktemp('tta_coco'), 2)


@pytest.fixture(scope='module')
def tta_run(coco_set):
    from dynamask_tpu.apis.test import aug_device_test as jax_tta
    from dynamask_tpu.data import build_dataset as jax_dataset
    from dynamask_torch.apis import aug_device_test
    from dynamask_torch.data import build_dataset
    det, variables, port = twin('mask_rcnn')
    cfg = coco_cfg(*coco_set)
    jds = jax_dataset(dict(cfg), dict(test_mode=True))
    pds = build_dataset(dict(cfg), dict(test_mode=True))
    ref = jax_tta(det, variables, jds, scales=TTA_SCALES, progress=False)
    got = aug_device_test(port, pds, scales=TTA_SCALES, progress=False)
    return pds, ref, got


def test_aug_device_test_matches_jax(tta_run):
    """Two images, 2 scales x 2 flips: the results' order and fields,
    dets slot for slot, and the pasted masks equal wherever the port's
    merged probability is clear of the threshold by 1e-3."""
    from dynamask_torch.apis.test import tta_pipelines, tta_samples, tta_specs
    from dynamask_torch.ops.paste import paste_masks
    pds, ref, got = tta_run
    _, _, port = twin('mask_rcnn')
    assert [r['img_id'] for r in got] == [r['img_id'] for r in ref] == [1, 2]
    specs = tta_specs(TTA_SCALES, True)
    pipes = tta_pipelines(pds, specs)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r) == {'img_id', 'dets', 'labels', 'valid',
                                    'masks'}
        assert g['valid'].sum() >= 3
        np.testing.assert_array_equal(g['valid'], r['valid'])
        np.testing.assert_array_equal(g['labels'], r['labels'])
        np.testing.assert_allclose(g['dets'], r['dets'], rtol=DET_RTOL,
                                   atol=DET_ATOL)
        samples = tta_samples(pds, i, specs, pipes)
        out = port_aug_test(port, [{k: s[k][None] for k in (
            'image', 'img_shape', 'ori_shape', 'scale_factor')}
            for s in samples], [f for _, f in specs])
        oh, ow = samples[0]['ori_shape'].astype(int)
        probs = paste_masks(out['mask_probs'][0], out['dets'][0, :, :4],
                            *CANVAS)[:, :oh, :ow].numpy()
        clear = np.abs(probs - 0.5) > 1e-3
        gm, rm = np.stack(g['masks']), np.stack(r['masks'])
        assert gm.shape == rm.shape == probs.shape
        np.testing.assert_array_equal(gm[clear], rm[clear])


def test_scale_without_canvas_raises_in_both(coco_set):
    """A scale whose image fits none of the dataset's canvases raises
    ``ValueError`` in both loops (JAX's own help example, ``--tta-scales
    800 1333 1000 1666``, does so on a 640x427 image)."""
    from dynamask_tpu.apis.test import aug_device_test as jax_tta
    from dynamask_tpu.data import build_dataset as jax_dataset
    from dynamask_torch.apis import aug_device_test
    from dynamask_torch.data import build_dataset
    det, variables, port = twin('mask_rcnn')
    cfg = coco_cfg(*coco_set)
    scales = [(160, 128), (256, 200)]
    with pytest.raises(ValueError, match='no canvas fits'):
        jax_tta(det, variables, jax_dataset(dict(cfg), dict(test_mode=True)),
                scales=scales, progress=False)
    with pytest.raises(ValueError, match='no canvas fits'):
        aug_device_test(port, build_dataset(dict(cfg), dict(test_mode=True)),
                        scales=scales, progress=False)


def test_cli_tta_and_fuse(coco_set, tmp_path, capsys):
    """``--tta --tta-scales ... --fuse-conv-bn --device cpu`` on the toy
    set: the folded pairs' count printed (JAX's for this model), the
    metrics printed, the results those of ``aug_device_test`` on the
    folded model; ``--tta`` on RetinaNet exits non-zero, naming why."""
    from test_torch_port_eval_slice import _write_cfg
    from dynamask_torch.engine import fuse_conv_bn
    from dynamask_torch.tools.test import main
    det, variables, port = twin('mask_rcnn')
    model, train_cfg, test_cfg = toy_cfg('mask_rcnn')
    ckpt = str(tmp_path / 'toy.pth')
    torch.save(port.state_dict(), ckpt)
    cfg_path = _write_cfg(tmp_path / 'toy_cfg.py', dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        data=dict(workers_per_gpu=0, test=coco_cfg(*coco_set))))
    out_json = str(tmp_path / 'r.json')
    argv = [cfg_path, ckpt, '--tta', '--tta-scales', '128', '160', '160',
            '192', '--fuse-conv-bn', '--eval', 'bbox', 'segm', '--device',
            'cpu', '--out', out_json]
    assert main(argv) == 0
    printed = capsys.readouterr().out
    assert f'fused {fuse_conv_bn(port)[1]} conv+bn pairs' in printed
    assert 'bbox_mAP:' in printed and 'segm_mAP:' in printed
    assert os.path.exists(out_json)
    retina = os.path.join(ROOT, 'configs', 'retinanet',
                          'retinanet_r50_fpn_1x_coco.py')
    assert main([retina, '--tta', '--device', 'cpu']) != 0
    assert 'RetinaNet' in capsys.readouterr().err


# -- JAX's departures from mmdet, which the port keeps ------------------------

def test_aug_test_departures_from_mmdet_3bz_3cc(monkeypatch):
    """JAX's ``aug_test`` and so the port's: the RPN runs on the first
    augmentation alone (3bz; mmdet merges every augmentation's
    proposals); the decoded boxes are not clipped to the frame (3ca): a
    box head pushing its boxes past the image's bottom edge gives dets past
    it; the NMS is greedy whatever the config's ``nms`` (3cb): a Soft-NMS
    head's ``aug_test`` calls ``multiclass_nms`` without its
    ``nms_type``; a DeformRoIPool head's box crop is RoIAlign's (3cc):
    its extractor runs in ``simple_test`` and not in ``aug_test``."""
    import test_torch_port_item9_dpool as dpool
    import test_torch_port_two_stage_twins as two_stage
    from dynamask_torch.models import build_detector, detectors
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in aug_batches()]
    port = build_detector(*toy_cfg('mask_rcnn'), device='cpu', seed=0)
    calls = []
    rpn = port.rpn_proposals
    monkeypatch.setattr(port, 'rpn_proposals',
                        lambda *a: calls.append(1) or rpn(*a))
    port.aug_test(batches, FLIPS)
    assert len(calls) == 1 and len(batches) == 2

    head = port.roi_head.bbox_head
    forward = head.forward

    def past_the_edge(x):       # class 0 sure, boxes 3 heights down
        cls, deltas = forward(x)
        cls = torch.full_like(cls, -10.0)
        cls[:, 0] = 10.0
        deltas = torch.zeros_like(deltas)
        deltas[:, 1::4] = 3.0 / 0.1          # dy of 3 heights at std 0.1
        return cls, deltas

    monkeypatch.setattr(head, 'forward', past_the_edge)
    out = port.aug_test(batches, FLIPS)
    valid = out['det_valid'][0]
    assert valid.any() and (out['dets'][0, valid, 3] > ORI_HW[0]).all()

    soft = build_detector(*two_stage.toy_cfg('soft_nms'), device='cpu',
                          seed=0)
    assert soft.roi_head.nms_cfg.get('nms_type') == 'soft_nms'
    seen = []
    nms = detectors.multiclass_nms
    monkeypatch.setattr(detectors, 'multiclass_nms',
                        lambda *a, **kw: seen.append(kw) or nms(*a, **kw))
    soft.aug_test(batches, FLIPS)
    assert seen and all('nms_type' not in kw for kw in seen)

    pool = build_detector(*dpool.dpool_toy_cfg(False), device='cpu', seed=0)
    ran = []
    ext = pool.roi_head.bbox_roi_extractor
    monkeypatch.setattr(ext, 'forward',
                        lambda *a, f=ext.forward: ran.append(1) or f(*a))
    pool.aug_test(batches, FLIPS)
    assert not ran
    pool.simple_test(batches[0])
    assert ran
