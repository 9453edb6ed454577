"""Libra R-CNN and NAS-FPN on the CPU: the PyTorch port
(``dynamask_torch/core/samplers.py``, ``models/necks_extra.py``,
``models/losses.py:balanced_l1_loss``) against the JAX package on the same
seeded inputs and draws, the JAX weights carried across by
``dynamask_torch.engine.convert``.

- The samplers: ``RandomSampler`` with ``neg_pos_ub``,
  ``InstanceBalancedPosSampler``, ``IoUBalancedNegSampler`` and Libra's
  ``CombinedSampler`` over them: every slot exactly, each of JAX's keys
  (the sampler's own, ``fold_in(key, 1)``, ``101`` and ``202``) given its
  own table on both sides (``jax_named_draws``).
- ``balanced_l1_loss`` and its gradient (1e-6 relative); ``BFP`` (conv
  and non-local refinement) and ``NASFPN`` on small pyramids of 4-16
  channels, fp32 within 1e-5 relative L2.
- 3bj: JAX's resize by whole-number ratios and a window minimum; BFP on an
  800x1344 pyramid (P2-P6) raises a ``ValueError`` naming 3bj in the port
  where JAX raises ``TypeError``, and runs on the canvases where JAX's is
  defined (768x1344 for P2-P6, 768x1280 for RetinaNet's P3-P7).
- The config files on the ``meta`` device. The toy detectors are in
  ``tests/test_torch_port_item8_libra_nasfpn_detectors.py``.
"""

import contextlib
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_train_modules import _assign_inputs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = 3
P = 32
NECK_RL2 = 1e-5
# JAX's fold-in path of a sampler key -> the port's draw name
DRAW_NAMES = {'': '', '1': 'n', '101': 'pos', '101/1': 'pos_n', '202': 'neg',
              '202/1': 'neg_n'}
LIBRA_NECK = [dict(type='FPN', in_channels=[64, 128, 256, 512],
                   out_channels=32, num_outs=5),
              dict(type='BFP', in_channels=32, num_levels=5, refine_level=2,
                   refine_type='non_local')]
COMBINED = dict(type='CombinedSampler', num=32, pos_fraction=0.25,
                add_gt_as_proposals=True,
                pos_sampler=dict(type='InstanceBalancedPosSampler'),
                neg_sampler=dict(type='IoUBalancedNegSampler', floor_thr=-1,
                                 floor_fraction=0, num_bins=3))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


class _Tag(str):
    """A sampler key's fold-in path, standing for the key while drawn."""


@contextlib.contextmanager
def jax_named_draws(tables):
    """While active, the JAX samplers' ``jax.random.uniform(key, (n,))``
    returns ``tables[(name, n)]``, ``name`` the key's fold-in path ('' the
    key a sampler is given, '101/1' ``fold_in(fold_in(key, 101), 1)``)."""
    import dynamask_tpu.core.samplers as js
    saved = js.jax

    class _Proxy(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jax, name)

    def fold_in(key, data):
        return _Tag(f'{key}/{data}' if isinstance(key, _Tag) else str(data))

    def uniform(key, shape, *a, **kw):
        name = key if isinstance(key, _Tag) else ''
        return jnp.asarray(tables[(name, shape[0])])

    proxy = _Proxy('jax')
    proxy.random = types.SimpleNamespace(uniform=uniform, fold_in=fold_in)
    js.jax = proxy
    try:
        yield
    finally:
        js.jax = saved


def _tables(n, seed=11):
    rng = np.random.RandomState(seed)
    return {(name, n): rng.uniform(size=n).astype(np.float32)
            for name in DRAW_NAMES}


# -- samplers -----------------------------------------------------------------

def _assign():
    from dynamask_tpu.core.assigners import MaxIoUAssigner
    from dynamask_torch.core.assigners import AssignResult
    boxes, bvalid, gts, gvalid, labels = _assign_inputs(seed=8)
    ref = MaxIoUAssigner(0.5, 0.5, 0.5)(*(jnp.asarray(x) for x in (
        boxes, bvalid, gts, gvalid, labels)))
    port = AssignResult(*(torch.tensor(np.asarray(x)).long() if i != 1 else
                          torch.tensor(np.asarray(x))
                          for i, x in enumerate(ref)))
    return ref, port, boxes, gts


SAMPLERS = {
    'random_ub': (dict(type='RandomSampler', num=64, pos_fraction=0.25,
                       neg_pos_ub=3), ('',)),
    'instance_balanced': (dict(type='InstanceBalancedPosSampler', num=64,
                               pos_fraction=0.5), ('', '1')),
    'iou_balanced': (dict(type='IoUBalancedNegSampler', num=64,
                          pos_fraction=0.25, floor_thr=-1, num_bins=3),
                     ('',)),
    'combined': (dict(COMBINED, num=64), ('101', '101/1', '202')),
}


def _port_sampler(cfg):
    from dynamask_torch.core import samplers as ps
    from dynamask_torch.models.builder import build_sampler
    if cfg['type'] == 'CombinedSampler':
        return build_sampler(cfg)
    kw = {k: v for k, v in cfg.items() if k not in ('type',)}
    return getattr(ps, cfg['type'])(**kw)


@pytest.mark.parametrize('kind', sorted(SAMPLERS))
def test_sampler_slots_exact(kind):
    """Every field of the packed result slot for slot; Libra's pair takes
    its positives from the instance-balanced sampler and the rest from the
    IoU-balanced one, each on its own draw."""
    from dynamask_tpu.utils.registry import BBOX_SAMPLERS
    cfg, used = SAMPLERS[kind]
    ref_a, a, boxes, gts = _assign()
    n = len(boxes)
    tables = _tables(n)
    with jax_named_draws(tables):
        ref = jax.device_get(jax.jit(lambda asg, b, g: BBOX_SAMPLERS.build(
            dict(cfg))(jax.random.PRNGKey(0), asg, b, g))(
                ref_a, jnp.asarray(boxes), jnp.asarray(gts)))
    draws = {DRAW_NAMES[k]: torch.from_numpy(tables[(k, n)]) for k in used}
    got = _port_sampler(cfg)(a, torch.from_numpy(boxes),
                             torch.from_numpy(gts), draws)
    for f, x, y in zip(got._fields, got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
    pos = np.asarray(ref.is_pos)
    assert 0 < pos.sum() < np.asarray(ref.valid).sum()
    if kind == 'random_ub':
        assert np.asarray(ref.valid).sum() == 4 * pos.sum()


def test_iou_balanced_bands():
    """The negatives spread round-robin over the 3 IoU bands of [0, the
    largest negative IoU], JAX's bands (mmdet's reach to ``neg_iou_thr``):
    the first three negatives taken are one of each band."""
    cfg, _ = SAMPLERS['iou_balanced']
    _, a, boxes, gts = _assign()
    sampler = _port_sampler(cfg)
    got = sampler(a, torch.from_numpy(boxes), torch.from_numpy(gts),
                  torch.from_numpy(_tables(len(boxes))[('', len(boxes))]))
    neg = got.valid & ~got.is_pos
    iou = a.max_overlaps[got.inds[neg]]
    hi = a.max_overlaps[a.gt_inds == 0].max()
    bands = (iou / hi * 3).long().clamp(max=2)
    assert sorted(bands[:3].tolist()) == [0, 1, 2]


# -- losses and necks ---------------------------------------------------------

@pytest.mark.parametrize('beta', [1.0, 0.11])
def test_balanced_l1(beta):
    from dynamask_tpu.models.losses import balanced_l1_loss as jbl1
    from dynamask_torch.models.losses import balanced_l1_loss
    rng = np.random.RandomState(9)
    pred = rng.normal(0, 1, (40, 4)).astype(np.float32)
    tgt = rng.normal(0, 1, (40, 4)).astype(np.float32)
    w = (rng.uniform(size=(40, 4)) > 0.3).astype(np.float32)
    ref, g = jax.value_and_grad(lambda p: jbl1(
        p, jnp.asarray(tgt), beta=beta, weight=jnp.asarray(w),
        avg_factor=7.0))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = balanced_l1_loss(tp, torch.from_numpy(tgt), beta,
                           weight=torch.from_numpy(w), avg_factor=7.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    assert rel_l2(tp.grad.numpy(), g) < 1e-6


def _pyramid(sizes, c, seed=10):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (1, h, w, c)).astype(np.float32)
            for h, w in sizes]


def _neck_pair(jneck, port_neck, feats, prefix, **hints):
    """The JAX neck's output on NHWC ``feats`` and the port's, its weights
    drawn (N(0, 1 / fan-in), biases N(0, 0.1)) and carried through the
    port's key map."""
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    xs = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(jneck.init, jax.random.PRNGKey(0), xs)
    rng = np.random.RandomState(12)

    def fill(path, s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    ref = jax.device_get(jax.jit(jneck.apply)(variables, xs))
    with torch.no_grad():
        for k, t in port_neck.state_dict().items():
            r = mmdet_key(prefix + k, **hints)
            t.copy_(torch.from_numpy(_torch_layout(
                {'neck': variables['params']}, {}, *r)))
        got = port_neck([torch.from_numpy(f).permute(0, 3, 1, 2)
                         for f in feats])
    return ([g.permute(0, 2, 3, 1).numpy() for g in got],
            [np.asarray(r) for r in ref])


@pytest.mark.parametrize('refine', ['non_local', 'conv'])
def test_bfp(refine):
    from dynamask_tpu.models.necks_extra import BFP as JBFP
    from dynamask_torch.models.necks_extra import BFP
    feats = _pyramid(((32, 48), (16, 24), (8, 12), (4, 6), (2, 3)), 8)
    got, ref = _neck_pair(JBFP(8, 5, 2, refine), BFP(8, 5, 2, refine),
                          feats, 'neck.')
    for g, r, f in zip(got, ref, feats):
        assert g.shape == f.shape and rel_l2(g, r) < NECK_RL2
        assert rel_l2(r, f) > 1e-3


def test_nasfpn():
    """Seven stacks of the searched cells on a 4-channel C2-C5 pyramid from
    ``start_level`` 1: P3-P7 within 1e-5 relative L2."""
    from dynamask_tpu.models.necks_extra import NASFPN as JNAS
    from dynamask_torch.models.necks_extra import NASFPN
    feats = _pyramid(((64, 64), (32, 32), (16, 16), (8, 8)), 4)
    feats = [f[..., :c] if c <= 4 else np.repeat(f, c // 4, -1)
             for f, c in zip(feats, (4, 8, 12, 16))]
    got, ref = _neck_pair(JNAS((8, 12, 16), 8, 5, 7, 1),
                          NASFPN((8, 12, 16), 8, 5, 7, 1), feats, 'neck.',
                          neck='NASFPN')
    assert [g.shape[1:3] for g in got] == [(32, 32), (16, 16), (8, 8),
                                           (4, 4), (2, 2)]
    for g, r in zip(got, ref):
        assert rel_l2(g, r) < NECK_RL2


def test_resize_window_minimum_3bj():
    """3bj: JAX's ``_resize_to`` shrinks 4x4 to 2x2 by the window minimum
    (``-max_pool(-x)``), where mmcv's merge cells and BFP take the maximum;
    the port computes JAX's."""
    from dynamask_tpu.models.necks_extra import _resize_to
    from dynamask_torch.models.necks_extra import resize_to
    x = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    ref = np.asarray(_resize_to(jnp.asarray(x), (2, 2)))[0, ..., 0]
    got = resize_to(torch.from_numpy(x).permute(0, 3, 1, 2), (2, 2))[0, 0]
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, [[0, 2], [8, 10]])
    mmcv = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2)[0, 0]
    np.testing.assert_array_equal(mmcv.numpy(), [[5, 7], [13, 15]])


def _levels(h, w, strides):
    import math
    return [(math.ceil(h / s), math.ceil(w / s)) for s in strides]


P2_P6 = (4, 8, 16, 32, 64)
P3_P7 = (8, 16, 32, 64, 128)


@pytest.mark.parametrize('hw,strides,refine_level,ok', [
    ((800, 1344), P2_P6, 2, False), ((768, 1344), P2_P6, 2, True),
    ((768, 1344), P3_P7, 1, False), ((768, 1280), P3_P7, 1, True)])
def test_bfp_canvases_3bj(hw, strides, refine_level, ok):
    """Libra R-CNN's BFP (P2-P6, refine level 2) on an 800x1344 canvas and
    Libra RetinaNet's (P3-P7, level 1) on 768x1344: JAX's integer-ratio
    resize misses the gather size (50x84 against 39x84; 48x84 against
    48x77) and its sum raises ``TypeError``; the port raises a
    ``ValueError`` naming 3bj and both shapes. 768x1344 (P2-P6) and
    768x1280 (P3-P7) run in both, within 1e-5 relative L2."""
    from dynamask_tpu.models.necks_extra import BFP as JBFP
    from dynamask_torch.models.necks_extra import BFP
    feats = _pyramid(_levels(*hw, strides), 2)
    jneck = JBFP(2, 5, refine_level, 'non_local')
    neck = BFP(2, 5, refine_level, 'non_local')
    if not ok:
        with pytest.raises(TypeError):
            jax.eval_shape(jneck.init, jax.random.PRNGKey(0),
                           [jnp.asarray(f) for f in feats])
        with pytest.raises(ValueError, match='3bj'):
            neck([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
        return
    got, ref = _neck_pair(jneck, neck, feats, 'neck.')
    for g, r in zip(got, ref):
        assert rel_l2(g, r) < NECK_RL2


LIBRA_FILES = ('libra_fast_rcnn_r50_fpn_1x_coco.py',
               'libra_faster_rcnn_r101_fpn_1x_coco.py',
               'libra_faster_rcnn_r50_fpn_1x_coco.py',
               'libra_faster_rcnn_x101_64x4d_fpn_1x_coco.py',
               'libra_retinanet_r50_fpn_1x_coco.py')


@pytest.mark.parametrize('rel', LIBRA_FILES)
def test_libra_files_build(rel):
    """Libra's files at full width: FPN then BFP (non-local at level 2, 1
    on RetinaNet), the balanced L1 loss (beta 1.0 on the box head, 0.11 on
    RetinaNet) and on the two-stage files the combined sampler."""
    from dynamask_torch.core.samplers import CombinedSampler
    from dynamask_torch.models import build_detector
    from dynamask_torch.models.necks_extra import BFP, NeckChain
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs/libra_rcnn', rel))
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           device='meta')
    assert isinstance(model.neck, NeckChain) and isinstance(model.neck[1],
                                                            BFP)
    assert model.neck[1].refine_level == (1 if 'retina' in rel else 2)
    if 'retina' in rel:
        assert model.loss_cfg['reg_loss_type'] == 'balanced_l1'
        return
    rh = model.roi_head
    assert rh.reg_loss_type == 'balanced_l1' and rh.smooth_l1_beta == 1.0
    assert isinstance(rh.sampler, CombinedSampler)
