"""The JAX faults that the single-stage detectors reproduce on the CPU
(ROADMAP.md queue 3, 3aa-3af), each shown against the JAX package or
against mmdet's formula; the refusals of the keys JAX drops; the phase-14
config files built from their unchanged files as JAX builds them (on the
``meta`` device); the ``fp16/`` RetinaNet in bf16 against JAX in bf16.
"""

import copy
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import fast_jit  # noqa: E402
from test_torch_port_single_stage import (CONFIGS, demo,  # noqa: E402
                                          toy_cfg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE14 = {
    'retinanet': 'configs/retinanet/retinanet_r50_fpn_1x_coco.py',
    'retinanet_fp16': 'configs/fp16/retinanet_r50_fpn_fp16_1x_coco.py',
    'retinanet_v1': 'configs/legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py',
    'ghm': 'configs/ghm/retinanet_ghm_r50_fpn_1x_coco.py',
    'free_anchor':
        'configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py',
    'crop640': 'configs/nas_fpn/retinanet_r50_fpn_crop640_50e_coco.py',
    'atss': 'configs/atss/atss_r50_fpn_1x_coco.py',
    'fcos': 'configs/fcos/fcos_r50_caffe_fpn_gn-head_4x4_1x_coco.py',
    'fcos_center': 'configs/fcos/fcos_center-normbbox-centeronreg-giou_'
                   'r50_caffe_fpn_gn-head_4x4_1x_coco.py',
}


def _jax_tree(kind):
    """The JAX toy detector of ``kind`` and zeros in the shape of its
    variables (``eval_shape``: nothing is compiled)."""
    from dynamask_tpu.models import build_detector as jax_build
    det = jax_build(*toy_cfg(kind))
    shapes = jax.eval_shape(det.init, {'params': jax.random.PRNGKey(0)},
                            {k: jnp.asarray(v) for k, v in demo().items()})
    return det, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


# -- 3aa: the JAX importer has no rule for the dense heads --------------------

# the keys without a JAX rule: the dense heads, and the FPN's norms (3t)
SKIPPED = re.compile(r'^(bbox_head\.|neck\.(lateral|fpn)_convs\.\d+\.'
                     r'(gn|bn)\.)')


@pytest.mark.parametrize('kind', ['retina', 'sepbn', 'atss', 'fcos'])
def test_jax_importer_skips_the_dense_heads_and_extra_convs_3aa(kind):
    """3aa: ``convert_torch_weights`` over the port's state dict skips
    every ``bbox_head.`` key (no rule; nor for the FPN's BatchNorms, as
    for its GroupNorms in 3t) and the FPN's extra convs (its
    ``fpn_convs.{n}`` rule names ``fpn_conv_{n}``, which the JAX FPN does
    not have: it names them ``extra_conv_{i}``), leaving them at their
    init; every other key loads. The port's key map takes them all."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    from dynamask_torch.engine.convert import mmdet_key, neck_laterals
    from dynamask_torch.models import build_detector
    det, variables = _jax_tree(kind)
    port = build_detector(*toy_cfg(kind), device='cpu')
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _, _, report = convert_torch_weights(sd, variables['params'],
                                         variables.get('batch_stats', {}),
                                         scope='mmdet')
    laterals = neck_laterals(port)
    extra = re.compile(r'^neck\.fpn_convs\.([%s-9])\.' % laterals)
    skipped = set(report['skipped'])
    want = {k for k in sd if SKIPPED.match(k) or extra.match(k)}
    assert want and skipped == want, sorted(skipped ^ want)
    assert 'fpn_conv_3' not in variables['params']['neck']
    assert {'extra_conv_0', 'extra_conv_1'} <= set(variables['params']['neck'])
    for k in sd:
        if k.endswith('num_batches_tracked'):
            continue
        path, _, _ = mmdet_key(k, laterals)
        if extra.match(k):
            assert path[-1].startswith('extra_'), (k, path)


# -- 3ab: GHM's momentum is dropped -------------------------------------------

def _mmdet_ghmc_weights(g, valid, bins, momentum, acc_sum):
    """mmdet's ``GHMC`` weights (losses/ghm_loss.py), its running
    ``acc_sum`` updated in place."""
    edges = [float(x) / bins for x in range(bins + 1)]
    edges[-1] += 1e-6
    tot = max(valid.sum(), 1.0)
    weights = np.zeros_like(g)
    n = 0
    for i in range(bins):
        inds = (g >= edges[i]) & (g < edges[i + 1]) & valid
        num = inds.sum()
        if num > 0:
            if momentum > 0:
                acc_sum[i] = momentum * acc_sum[i] + (1 - momentum) * num
                weights[inds] = tot / acc_sum[i]
            else:
                weights[inds] = tot / num
            n += 1
    return weights / max(n, 1)


def test_ghm_momentum_is_dropped_3ab():
    """3ab: ``configs/ghm`` sets ``momentum=0.75`` on GHM-C; JAX (and the
    port) weight by this batch's density alone. At momentum 0 mmdet's
    weights are the port's; at 0.75 its running density gives other
    weights on a second step. The port's GHM model computes the same
    losses whatever ``momentum`` says."""
    from dynamask_torch.models import build_detector
    from dynamask_torch.models.losses import _ghm_edges, _ghm_weights
    rng = np.random.RandomState(3)
    acc = np.zeros(30)
    for step in range(2):
        g = np.abs(rng.uniform(size=(400,)) ** (step + 1) -
                   (rng.uniform(size=400) > 0.9)).astype(np.float32)
        valid = rng.uniform(size=400) > 0.1
        port = _ghm_weights(torch.from_numpy(g), torch.from_numpy(valid),
                            _ghm_edges(30, 1.0 + 1e-6, None),
                            torch.tensor(float(valid.sum()))).numpy()
        stateless = _mmdet_ghmc_weights(g, valid, 30, 0.0, np.zeros(30))
        np.testing.assert_allclose(port, stateless, rtol=1e-6)
        running = _mmdet_ghmc_weights(g, valid, 30, 0.75, acc)
    assert np.abs(running - stateless).max() > 0.1 * stateless.max()
    m, tr, te = toy_cfg('ghm')
    losses = []
    for momentum in (0.75, 0.0):
        mm = copy.deepcopy(m)
        mm['bbox_head']['loss_cls']['momentum'] = momentum
        det = build_detector(mm, tr, te, device='cpu', seed=2).train()
        losses.append(det.forward_train(
            {k: torch.from_numpy(v) for k, v in demo(2).items()}))
    for k in losses[0]:
        assert torch.equal(losses[0][k], losses[1][k]), k


# -- 3ac: ATSS's biased standard deviation ------------------------------------

def _atss_numpy(anchors, n_lvl, gt, ddof, topk=9):
    """One GT's ATSS positives by mmdet's recipe in numpy, the threshold's
    standard deviation with ``ddof`` (0 as JAX, 1 as mmdet's
    ``Tensor.std``)."""
    lt = np.maximum(anchors[:, :2], gt[:2])
    rb = np.minimum(anchors[:, 2:], gt[2:])
    inter = np.prod(np.clip(rb - lt, 0, None), 1)
    area = np.prod(anchors[:, 2:] - anchors[:, :2], 1)
    ious = inter / (area + np.prod(gt[2:] - gt[:2]) - inter)
    ac = (anchors[:, :2] + anchors[:, 2:]) / 2
    dist = np.linalg.norm(ac - (gt[:2] + gt[2:]) / 2, axis=-1)
    cand, start = [], 0
    for n in n_lvl:
        cand += list(start + np.argsort(dist[start:start + n],
                                        kind='stable')[:topk])
        start += n
    c = ious[cand]
    inside = ((ac[cand, 0] > gt[0]) & (ac[cand, 0] < gt[2]) &
              (ac[cand, 1] > gt[1]) & (ac[cand, 1] < gt[3]))
    pos = np.zeros(len(anchors), bool)
    pos[np.asarray(cand)[(c >= c.mean() + c.std(ddof=ddof)) & inside]] = True
    return pos


# GTs where a candidate's IoU lies between the two thresholds (found by a
# seeded search of random GTs over the anchors below, about 1 in 300)
BETWEEN = [[67.42686462402344, 13.867606163024902, 131.61322021484375,
            124.55994415283203],
           [17.452083587646484, 96.22959899902344, 85.56619262695312,
            226.57640075683594]]


def test_atss_threshold_std_is_biased_3ac():
    """3ac: with 9 x 5 candidates a GT, the port's positives are those of
    the biased deviation (JAX's ``nanmean`` of squares); where a
    candidate's IoU falls between the biased threshold and mmdet's
    unbiased one (a deviation sqrt(45/44) larger), mmdet leaves it out."""
    from dynamask_torch.core.anchors import AnchorGenerator
    from dynamask_torch.core.assigners import ATSSAssigner
    gen = AnchorGenerator((8, 16, 32, 64, 128), (1.0,), scales=(8,))
    mlvl = gen.grid_anchors([(24, 24), (12, 12), (6, 6), (3, 3), (2, 2)])
    anchors = torch.cat(mlvl)
    n_lvl = [m.shape[0] for m in mlvl]
    r = np.random.RandomState(1)
    xy = r.uniform(10, 120, (6, 2))
    gts = np.concatenate([BETWEEN, np.concatenate(
        [xy, xy + r.uniform(8, 70, (6, 2))], 1)]).astype(np.float32)
    for j, gt in enumerate(gts):
        biased = _atss_numpy(anchors.numpy(), n_lvl, gt, 0)
        unbiased = _atss_numpy(anchors.numpy(), n_lvl, gt, 1)
        got = ATSSAssigner(9)(
            anchors, torch.ones(len(anchors), dtype=torch.bool),
            torch.from_numpy(gt[None]), torch.ones(1, dtype=torch.bool),
            num_level_anchors=n_lvl).gt_inds.numpy() > 0
        np.testing.assert_array_equal(got, biased, err_msg=str(j))
        assert biased.any() and not (unbiased & ~biased).any()
        assert (biased & ~unbiased).any() == (j < len(BETWEEN)), j


# -- 3ad: the valid flags come from img_shape ---------------------------------

@pytest.mark.parametrize('kind', ['retina', 'atss'])
def test_valid_flags_come_from_img_shape_3ad(kind):
    """3ad: the anchors over the canvas padding are left out by the
    un-padded ``img_shape``, as JAX does, where mmdet's ``get_anchors``
    takes ``pad_shape``: the step's losses change when the same batch
    says its image fills the canvas."""
    from dynamask_torch.models import build_detector
    det = build_detector(*toy_cfg(kind), device='cpu', seed=1).train()
    batch = {k: torch.from_numpy(v) for k, v in demo(2).items()}
    batch['img_shape'][1] = torch.tensor([40., 36.])
    short = det.forward_train(batch)
    full = det.forward_train(dict(batch, img_shape=torch.full((2, 2), 64.)))
    assert not torch.equal(short['loss_cls'], full['loss_cls'])


# -- 3ae: FCOS's distances and its box loss -----------------------------------

def test_fcos_distances_and_box_loss_3ae():
    """3ae: JAX's FCOS multiplies the distances by the level's stride on
    both paths; mmdet's ``exp`` branch does not (a factor of the stride at
    test time), and its ``norm_on_bbox`` branch regresses stride units in
    training (the same GIoU, a scale-invariant loss). JAX averages the box
    loss per image over each image's centerness sum, mmdet over the
    batch's; a config without ``loss_bbox`` trains GIoU in JAX, mmdet's
    default ``IoULoss`` (-log IoU)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    for kind, norm in (('fcos_plain', False), ('fcos', True)):
        det = build_detector(*toy_cfg(kind), device='cpu', seed=1)
        head = det.bbox_head
        feats = [torch.randn(1, 32, 4, 4) for _ in range(5)]
        with torch.no_grad():
            _, reg, _ = head(feats)
            for lvl, (x, s) in enumerate(zip(feats, head.strides)):
                r = x
                for conv in head.reg_convs:
                    r = conv(r)
                raw = head.scales[lvl](head.conv_reg(r))
                mmdet = raw.relu() * s if norm else raw.exp()
                torch.testing.assert_close(reg[lvl], mmdet * (1 if norm
                                                              else s))
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS['fcos_plain']))
    assert 'loss_bbox' not in cfg.model['bbox_head']
    assert jax_build(cfg.model, cfg.get('train_cfg'),
                     cfg.get('test_cfg')).reg_loss_mode == 'giou'
    assert build_detector(cfg.model, cfg.get('train_cfg'),
                          cfg.get('test_cfg'),
                          device='meta').reg_loss_mode == 'giou'
    # the per-image mean against mmdet's batch average on two images with
    # unequal centerness sums
    loss = np.array([0.3, 0.9])
    csum = np.array([1.5, 6.0])
    assert abs(np.mean(loss / np.maximum(csum, 1)) -
               loss.sum() / csum.sum()) > 1e-2


# -- 3af: RetinaNet's SmoothL1Loss regresses with L1 --------------------------

def test_retinanet_smooth_l1_is_l1_3af():
    """3af: the legacy v1 RetinaNet names ``SmoothL1Loss(beta=0.11)``;
    JAX's single-stage builder reads only GHM-R or Balanced L1 and
    regresses with L1 otherwise, and the port builds it so: its box loss
    is the L1 of the positives' deltas, not mmdet's SmoothL1."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.models import build_detector
    from dynamask_torch.models.losses import smooth_l1_elementwise
    m, tr, te = toy_cfg('legacy')
    assert m['bbox_head']['loss_bbox'] == dict(type='SmoothL1Loss',
                                               beta=0.11, loss_weight=1.0)
    assert jax_build(m, tr, te).reg_loss_type == 'l1'
    det = build_detector(m, tr, te, device='cpu')
    assert det.loss_cfg['reg_loss_type'] == 'l1'
    d = torch.linspace(-0.3, 0.3, 13)
    assert not torch.allclose(smooth_l1_elementwise(d, torch.zeros(13),
                                                    0.11), d.abs())


# -- the keys JAX drops, refused ----------------------------------------------

def _edit(kind, fn):
    m, tr, te = toy_cfg(kind)
    fn(m['bbox_head'], m['neck'], te)
    return m, tr, te


REFUSALS = {
    'focal_weight': ('retina', lambda h, n, t: h['loss_cls'].update(
        loss_weight=2.0), '3w'),
    'l1_weight': ('retina', lambda h, n, t: h['loss_bbox'].update(
        loss_weight=2.0), '3w'),
    'center_offset': ('retina', lambda h, n, t: h['anchor_generator'].update(
        center_offset=0.5), '3w'),
    'legacy_anchor_alone': ('retina', lambda h, n, t: h[
        'anchor_generator'].update(type='LegacyAnchorGenerator'), '3w'),
    'soft_nms': ('retina', lambda h, n, t: t.update(nms=dict(
        type='soft_nms', iou_threshold=0.5)), '3w'),
    'on_lateral': ('retina', lambda h, n, t: n.update(
        add_extra_convs='on_lateral'), '3w'),
    'balanced_l1': ('retina', lambda h, n, t: h.update(loss_bbox=dict(
        type='BalancedL1Loss')), '3w'),
    'atss_giou_weight': ('atss', lambda h, n, t: h['loss_bbox'].update(
        loss_weight=1.0), '3w'),
    'atss_gn16': ('atss', lambda h, n, t: h.update(norm_cfg=dict(
        type='GN', num_groups=16)), '3w'),
    'fcos_dcn': ('fcos', lambda h, n, t: h.update(
        dcn_on_last_conv=True, conv_cfg=dict(type='DCNv2')), '3w'),
    'fcos_conv_bias': ('fcos', lambda h, n, t: h.update(conv_bias=True),
                       '3w'),
    'fcos_linear_iou': ('fcos_plain', lambda h, n, t: h.update(
        loss_bbox=dict(type='IoULoss', linear=True, loss_weight=1.0)),
        '3w'),
    'free_anchor_l1': ('free_anchor', lambda h, n, t: h.update(
        loss_bbox=dict(type='L1Loss', loss_weight=0.75)), '3w'),
}


@pytest.mark.parametrize('name', sorted(REFUSALS))
def test_dropped_keys_refused(name):
    from dynamask_torch.models import build_detector
    kind, fn, what = REFUSALS[name]
    with pytest.raises(NotImplementedError, match=what):
        build_detector(*_edit(kind, fn), device='meta')


# -- the phase-14 configs -----------------------------------------------------

@pytest.mark.parametrize('name', sorted(PHASE14))
def test_phase14_config_builds(name):
    """Each phase-14 config from its unchanged file on the ``meta`` device,
    at full width: the FPN's extra convs where JAX puts them, the heads'
    forms, the config's shapes."""
    from dynamask_torch.apis import config_shapes
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, PHASE14[name]))
    det = build_detector(cfg.model, cfg.get('train_cfg'),
                         cfg.get('test_cfg'), device='meta')
    neck = det.neck
    assert len(neck.lateral_convs) == 3 and len(neck.fpn_convs) == 5
    on_input = cfg.model['neck']['add_extra_convs'] == 'on_input'
    assert neck.fpn_convs[3].conv.in_channels == (2048 if on_input else 256)
    kind = type(det).__name__
    want = {'retinanet': 'RetinaNet', 'retinanet_fp16': 'RetinaNet',
            'retinanet_v1': 'RetinaNet', 'ghm': 'RetinaNet',
            'free_anchor': 'FreeAnchor', 'crop640': 'RetinaNet',
            'atss': 'ATSS', 'fcos': 'FCOS', 'fcos_center': 'FCOS'}[name]
    assert kind == want
    assert det.num_classes == 80
    if name == 'crop640':
        assert type(det.bbox_head).__name__ == 'RetinaSepBNHead'
        assert hasattr(neck.fpn_convs[0], 'bn') and not hasattr(
            neck.lateral_convs[0], 'bn')
    if name == 'retinanet_v1':
        assert type(det.anchor_generator).__name__ == 'LegacyAnchorGenerator'
    if name == 'ghm':
        assert det.loss_cfg['cls_loss_type'] == 'ghmc'
        assert det.loss_cfg['reg_loss_type'] == 'ghmr'
    if name.startswith('fcos'):
        assert det.center_sampling == (name == 'fcos_center')
        assert det.bbox_head.norm_on_bbox == (name == 'fcos_center')
    test_hw, images, train_hw = config_shapes(cfg)
    assert test_hw == (800, 1344) and images in (2, 4)


# -- bf16: the fp16/ RetinaNet against JAX in bf16 ----------------------------

def _fp16_mini():
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, PHASE14['retinanet_fp16']))
    assert cfg.get('fp16') == {'loss_scale': 512.0}
    m, tr, te = toy_cfg('retina')
    assert copy.deepcopy(cfg.model['bbox_head']['loss_cls']) == \
        m['bbox_head']['loss_cls']
    return m, tr, te


def test_fp16_retinanet_in_bf16_matches_jax():
    """The ``fp16/`` RetinaNet at mini width in bf16 against JAX in bf16:
    the FPN levels and the head's maps within STAGE_RL2 relative L2, and
    the bf16 step's losses within LOSS_RTOL_JAX of JAX's bf16 step (JAX's
    focal sum runs on the head's bf16 logits, the port's in fp32:
    ``core/fp16.py``); fp32 masters and gradients."""
    from test_torch_port_bf16 import LOSS_RTOL_JAX, STAGE_RL2, _rel_l2
    from test_torch_port_modules import randomize_variables
    from dynamask_tpu.core.fp16 import to_bf16 as jto
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     make_train_step as jstep)
    from dynamask_tpu.engine.optimizer import step_lr_schedule
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.core.fp16 import to_bf16
    from dynamask_torch.engine import (DetectorSGD, load_jax_variables,
                                       make_train_step)
    from dynamask_torch.engine import step_lr_schedule as tsched
    from dynamask_torch.models import build_detector
    cfg = _fp16_mini()
    det = jax_build(*cfg)
    batch = demo(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = randomize_variables(fast_jit(det.init)(
        {'params': jax.random.PRNGKey(0)}, jb))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    v16 = jto(variables)
    feats = det.apply(v16, jb['image'].astype(jnp.bfloat16),
                      method=det.extract_feat)
    cls, reg = det.apply(v16, {'image': jb['image'].astype(jnp.bfloat16)})
    p16 = to_bf16(port)
    with torch.no_grad():
        tfeats = p16.extract_feat(p16.images(
            {'image': torch.from_numpy(batch['image']).bfloat16()}))
        tcls, treg = p16.bbox_head(tfeats)
    nhwc = (lambda t: t.permute(0, 2, 3, 1))
    pairs = ([(nhwc(a), b) for a, b in zip(tfeats, feats)] +
             [(nhwc(a), b) for a, b in zip(tcls, cls)] +
             [(nhwc(a), b) for a, b in zip(treg, reg)])
    for i, (got, ref) in enumerate(pairs):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, i
        assert _rel_l2(got, ref) <= STAGE_RL2, i
    lr = 0.01
    tx = build_optimizer(variables['params'], lr, 0.9, 1e-4, 35.0,
                         step_lr_schedule(lr, 10, warmup_iters=0),
                         frozen_backbone_prefixes=det.backbone
                         .frozen_param_paths())
    _, ref = jax.jit(jstep(det, tx, compute_dtype=jnp.bfloat16))(
        create_train_state(variables, tx), jb, jax.random.PRNGKey(0))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    port = copy.deepcopy(port).train()
    got = make_train_step(port, DetectorSGD(port, lr, 0.9, 1e-4, 35.0,
                                            tsched(lr, 10, warmup_iters=0)),
                          torch.bfloat16)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ('loss_cls', 'loss_bbox', 'loss'):
        assert abs(float(got[k]) - ref[k]) <= LOSS_RTOL_JAX * abs(ref[k]), (
            k, float(got[k]), ref[k])
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(p.grad.dtype == torch.float32 for p in port.parameters()
               if p.grad is not None)
