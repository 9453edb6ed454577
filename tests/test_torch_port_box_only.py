"""The box-only detectors of the port against the JAX package's, on the CPU:
mini twins of ``FasterRCNN``, ``FastRCNN`` and ``RPN`` (the schema of
``tests/test_models.py:mini_mask_rcnn_cfg``: ResNet-18, 32-channel FPN,
8 classes, 64x64), built on both sides from one config, the JAX weights
carried into the port (``engine/convert.py``).

- ``simple_test``: dets, labels and validity slot for slot, dets within
  ``rtol=1e-5, atol=1e-4`` (``test_torch_port_slice.py``'s); the RPN's
  proposals as (N, 5) score-ranked dets; Fast R-CNN on the batch's
  proposals.
- ``forward_train``: every loss within 1e-4 relative (the twins' LOSS_RTOL)
  with the sampler priorities injected into both sides.
- Fault 3b: the box head's SmoothL1 (``SmoothL1Loss``, ``beta``) against
  JAX's ``smooth_l1`` on the same deltas (fp32, 1e-6), and a twin whose
  box head trains with it; the RPN's SmoothL1 key, which JAX applies as L1
  (ROADMAP.md queue 3), the port applies as L1 too.
- Fault 3a stays fixed: the GRoIE config builds with the all-level
  extract, as JAX builds it, not with FPN routing.
- Each config file of ``chip_smoke.py`` phase 11 builds on the CPU from the
  file as it is, every state-dict key maps through the JAX importer to the
  port's own path, with the test NMS each detector type reads.
"""

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import fast_jit, randomize_variables  # noqa: E402
from test_torch_port_train_slice import jax_draws        # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
N_PROPOSALS = 40
PHASE11 = {
    'faster_rcnn': 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py',
    'faster_rcnn_fp16': 'configs/fp16/faster_rcnn_r50_fpn_fp16_1x_coco.py',
    'x101': 'configs/mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py',
    'caffe': 'configs/mask_rcnn/mask_rcnn_r50_caffe_fpn_1x_coco.py',
    'rpn': 'configs/rpn/rpn_r50_fpn_1x_coco.py',
    'fast_rcnn': 'configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py',
    'voc': 'configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py',
}


def box_cfg(kind):
    """(model, train_cfg, test_cfg) of the mini twin ``kind``: 'faster',
    'faster_smoothl1' (the v1 losses: SmoothL1 beta 1/9 on the RPN, 1.0 on
    the box head), 'fast' or 'rpn'."""
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    rh = model['roi_head']
    rh['mask_head'] = rh['mask_roi_extractor'] = None
    model['type'] = 'FasterRCNN'
    if kind == 'faster_smoothl1':
        model['rpn_head']['loss_bbox'] = dict(type='SmoothL1Loss',
                                              beta=0.1111, loss_weight=1.0)
        rh['bbox_head']['loss_bbox'] = dict(type='SmoothL1Loss', beta=1.0,
                                            loss_weight=1.0)
    elif kind == 'fast':
        model['type'] = 'FastRCNN'
        del model['rpn_head']
        for k in ('rpn', 'rpn_proposal'):
            train_cfg.pop(k, None)
        test_cfg.pop('rpn', None)
    elif kind == 'rpn':
        model['type'] = 'RPN'
        del model['roi_head']
        train_cfg.pop('rcnn')
        test_cfg['rpn'] = dict(nms_pre=32, max_num=16, nms_thr=0.7)
    return model, train_cfg, test_cfg


def _proposals(b, seed=5):
    """(B, N_PROPOSALS, 4) boxes inside 64x64, the last 7 slots invalid."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 44, (b, N_PROPOSALS, 2))
    wh = rng.uniform(6, 30, (b, N_PROPOSALS, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 64.0)], -1)
    valid = np.broadcast_to(np.arange(N_PROPOSALS) < N_PROPOSALS - 7,
                            (b, N_PROPOSALS)).copy()
    return boxes.astype(np.float32), valid


def _batch(kind, b=1):
    from test_models import demo_batch
    batch = {k: np.array(v) for k, v in demo_batch(
        0, b=b, h=64, w=64, g=3, s=16).items()}
    if kind == 'fast':
        batch['proposals'], batch['proposal_valid'] = _proposals(b)
    return batch


_PAIRS = {}


def twin(kind):
    """(JAX detector, its randomised variables, the port loaded from
    them)."""
    if kind not in _PAIRS:
        from dynamask_tpu.models import build_detector as jax_build
        from dynamask_torch.engine import load_jax_variables
        from dynamask_torch.models import build_detector
        cfg = box_cfg(kind)
        det = jax_build(*cfg)
        batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
        variables = randomize_variables(fast_jit(det.init)(
            {'params': jax.random.PRNGKey(0)}, batch))
        port = build_detector(*cfg, device='cpu')
        load_jax_variables(port, variables)
        _PAIRS[kind] = det, variables, port
    return _PAIRS[kind]


@pytest.mark.parametrize('kind,b', [('faster', 1), ('faster', 2),
                                    ('fast', 1), ('fast', 2), ('rpn', 2)])
def test_simple_test_slot_for_slot(kind, b):
    det, variables, port = twin(kind)
    batch = _batch(kind, b)
    batch['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, x: det.apply(
        v, x, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = port.simple_test({k: torch.from_numpy(v) for k, v in
                            batch.items()})
    assert 'mask_probs' not in got and 'mask_probs' not in ref
    slots = 16 if kind == 'rpn' else 8
    assert got['dets'].shape == (b, slots, 5)
    for i in range(b):
        valid = ref['det_valid'][i].astype(bool)
        assert valid.sum() >= 4
        scores = ref['dets'][i, valid, 4]
        # no two within the two sides' rounding of a score (~1e-7)
        assert np.min(np.abs(np.diff(np.sort(scores)))) > 1e-6, 'ties'
        if kind == 'rpn':       # score-ranked
            assert np.all(np.diff(scores) <= 0)
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)


def _noise(kind):
    """Sampler priorities for both sides: 'rpn' over the anchors, 'rcnn'
    over the GTs + proposals (the slot count sizes each table, so a
    detector without one of the samplers gets an unused table of another
    size)."""
    rng = np.random.RandomState(12)
    n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    cands = 3 + (N_PROPOSALS if kind == 'fast' else 32)
    return {'rpn': rng.uniform(size=(1, n_anchors)).astype(np.float32),
            'rcnn': rng.uniform(size=(1, cands)).astype(np.float32),
            'gumbel': np.zeros((8, 4), np.float32)}


def _losses(kind):
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(kind)
    port = copy.deepcopy(port).train()
    batch, noise = _batch(kind), _noise(kind)
    with jax_draws(noise):
        ref, _ = det.apply(variables, {k: jnp.asarray(v) for k, v in
                                       batch.items()},
                           method='forward_train',
                           rngs={'sampling': jax.random.PRNGKey(0)},
                           mutable=['batch_stats'])
    ref = jax.device_get(jparse(ref)[1])
    _, got = parse_losses(port.forward_train(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v) for k, v in noise.items()}))
    return ({k: float(v) for k, v in ref.items()},
            {k: float(v) for k, v in got.items()})


@pytest.mark.parametrize('kind,keys', [
    ('faster', {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox',
                'acc'}),
    ('faster_smoothl1', {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                         'loss_bbox', 'acc'}),
    ('fast', {'loss_cls', 'loss_bbox', 'acc'}),
    ('rpn', {'loss_rpn_cls', 'loss_rpn_bbox'})])
def test_forward_train_losses(kind, keys):
    ref, got = _losses(kind)
    assert {k for k in ref if 'loss' in k or k == 'acc'} == keys | {'loss'}
    assert set(got) == set(ref)
    for k in sorted(ref):
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    if 'loss_bbox' in ref:
        assert ref['loss_bbox'] > 0


def test_smooth_l1_box_loss_matches_jax():
    """Fault 3b: ``bbox_head_loss`` with SmoothL1 (beta 1.0, the legacy v1
    box head's) on the same logits, deltas and targets as JAX's
    ``reg_loss_type='smooth_l1'``, deltas on both sides of beta; the L1
    loss it replaced is another number."""
    from dynamask_tpu.models.bbox_head import BBoxTargets as JT
    from dynamask_tpu.models.bbox_head import bbox_head_loss as jloss
    from dynamask_torch.models.bbox_head import BBoxTargets, bbox_head_loss
    rng = np.random.RandomState(0)
    n, c = 64, 8
    logits = rng.randn(n, c + 1).astype(np.float32)
    deltas = (rng.randn(n, 4 * c) * 1.5).astype(np.float32)
    labels = rng.randint(0, c + 1, n).astype(np.int64)
    pos = (labels < c).astype(np.float32)
    tgt = (rng.randn(n, 4) * pos[:, None]).astype(np.float32)
    lw = (rng.uniform(size=n) > 0.1).astype(np.float32)
    ref = jloss(jnp.asarray(logits), jnp.asarray(deltas),
                JT(jnp.asarray(labels), jnp.asarray(lw), jnp.asarray(tgt),
                   jnp.asarray(pos)), c, reg_loss_type='smooth_l1',
                smoothl1_beta=1.0)
    args = (torch.from_numpy(logits), torch.from_numpy(deltas),
            BBoxTargets(*(torch.from_numpy(a) for a in (labels, lw, tgt,
                                                          pos))), c)
    got = bbox_head_loss(*args, smooth_l1_beta=1.0)
    for k in ('loss_cls', 'loss_bbox', 'acc'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
    sel = np.abs(deltas.reshape(n, c, 4)[np.arange(n), np.minimum(
        labels, c - 1)] - tgt)[pos > 0]
    assert (sel < 1).any() and (sel > 1).any()     # both branches
    assert abs(float(bbox_head_loss(*args)['loss_bbox']) -
               float(ref['loss_bbox'])) > 1e-2


def test_legacy_v1_losses_built_as_jax_builds_them():
    """``mask_rcnn_r50_caffe_fpn_poly_1x_coco_v1.py`` names SmoothL1 on the
    RPN (beta 1/9) and on the box head (beta 1.0): the box head trains with
    SmoothL1(1.0) on both sides, the RPN with L1 on both (JAX's stock RPN
    reads no ``loss_bbox.type``); the fully legacy config (its anchor
    generator, coder and ``aligned=False``, which JAX drops, 3c) is
    refused."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/mask_rcnn/mask_rcnn_r50_caffe_fpn_poly_1x_coco_v1.py'))
    port = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                          device='meta')
    d = cfg.to_dict()
    jdet = jax_build(d['model'], d['train_cfg'], d['test_cfg'])
    assert jdet.roi_head.reg_loss_type == 'smooth_l1'
    assert port.roi_head.smooth_l1_beta == jdet.roi_head.smoothl1_beta == 1.0
    legacy = Config.fromfile(os.path.join(
        ROOT, 'configs/legacy_1.x/mask_rcnn_r50_fpn_1x_coco_v1.py'))
    with pytest.raises(NotImplementedError, match='3c'):
        build_detector(legacy.model, legacy.train_cfg, legacy.test_cfg,
                       device='meta')


def test_groie_refused():
    """Fault 3a stays fixed: the GRoIE config's ``GenericRoIExtractor``
    (every level pooled and summed in JAX) is not built with FPN routing:
    it builds with the all-level extract as JAX builds it, and a GRoIE
    extractor with the ``pre_cfg`` / ``post_cfg`` modules, which the JAX
    builder drops, is refused, naming 3w."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.apis import init_detector
    from dynamask_torch.utils.config import Config
    path = os.path.join(ROOT,
                        'configs/groie/mask_rcnn_r50_fpn_groie_1x_coco.py')
    d = Config.fromfile(path).to_dict()
    mode = jax_build(d['model'], d['train_cfg'],
                     d['test_cfg']).roi_head.roi_extract_mode
    assert init_detector(path, device='meta').roi_head.roi_extract_mode \
        == mode == 'generic_sum'
    # GRoIE's Grid R-CNN builds too (item 9's heads), the all-level extract
    # its box and grid crops'
    assert init_detector(os.path.join(
        ROOT, 'configs/groie/grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py'),
        device='meta').roi_head.roi_extract_mode == 'generic_sum'
    from dynamask_torch.models import build_detector
    d['model']['roi_head']['bbox_roi_extractor']['pre_cfg'] = dict(
        type='ConvModule', in_channels=256, out_channels=256, kernel_size=5,
        padding=2, inplace=False)
    with pytest.raises(NotImplementedError, match='3w'):
        build_detector(d['model'], d['train_cfg'], d['test_cfg'],
                       device='meta')


@pytest.mark.parametrize('name', sorted(PHASE11))
def test_phase11_config_builds(name):
    """The config file, unchanged, builds on the CPU with its seeded init;
    every state-dict key maps through the JAX importer to the path the
    port's key map gives; the detector type and its test NMS (the RPN's
    from ``test_cfg.rpn``, the two-stage detectors' from
    ``train_cfg.rpn_proposal``)."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.apis import init_detector
    from dynamask_torch.engine.convert import mmdet_key
    model = init_detector(os.path.join(ROOT, PHASE11[name]), device='cpu')
    keys = [k for k in model.state_dict()
            if not k.endswith('num_batches_tracked')]
    for k in keys:
        ref = _mmdet_key(k)
        assert ref is not None, f'the JAX importer skips {k}'
        assert (ref[0], ref[1]) == mmdet_key(k)[:2], k
    kind = type(model).__name__
    assert kind == {'x101': 'MaskRCNN', 'caffe': 'MaskRCNN', 'rpn': 'RPN',
                    'fast_rcnn': 'FastRCNN'}.get(name, 'FasterRCNN')
    masks = any(k.startswith('roi_head.mask_head') for k in keys)
    assert masks == (name in ('x101', 'caffe'))
    assert any(k.startswith('rpn_head') for k in keys) == (
        name != 'fast_rcnn')
    assert any(k.startswith('roi_head') for k in keys) == (name != 'rpn')
    if name == 'rpn':
        assert (model.rpn_nms_pre_test, model.rpn_max_num,
                model.rpn_nms_thr) == (2000, 1000, 0.7)
        assert len(model.CLASSES) == 80
    elif name != 'fast_rcnn':
        assert (model.rpn_nms_pre_test, model.rpn_max_num,
                model.rpn_nms_thr) == (1000, 1000, 0.7)
    if name != 'rpn':
        classes = 20 if name == 'voc' else 80
        assert model.roi_head.num_classes == len(model.CLASSES) == classes
    bb = model.backbone
    if name == 'x101':
        assert bb.layer3[22].conv2.groups == 32
    if name == 'caffe':
        assert bb.layer2[0].conv1.stride == (2, 2)
