"""The single-stage detectors' modules on the CPU, each against its JAX
counterpart on the same seeded numpy inputs, weights carried across by
``load_jax_variables``: the anchors (octave scales, ATSS's one ratio, the
legacy v1 form, the valid flags), the FPN with its extra levels (every
``add_extra_convs`` mode, ``relu_before_extra_convs``, BN and GN), the
focal, GHM-C and GHM-R losses with their gradients, ``RetinaHead``,
``RetinaSepBNHead``, ``anchor_head_loss`` (focal + L1, GHM, legacy),
``anchor_head_get_dets``, ``ATSSAssigner``, ``ATSSHead``, ``FCOSHead``,
``fcos_points`` and ``fcos_targets``.

Tolerances: 1e-5 relative L2 on fp32 outputs, losses within 1e-5 relative,
labels, assignments and the validity of dets exact.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import randomize_variables  # noqa: E402
from test_torch_port_train_slice import rel_l2  # noqa: E402

RL2 = 1e-5
LOSS_RTOL = 1e-5


def _rng(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


class _Holder(torch.nn.Module):
    """A module under the name the key map reads (``neck``, ``bbox_head``)."""

    def __init__(self, **modules):
        super().__init__()
        for k, v in modules.items():
            setattr(self, k, v)


def _load(name, module, variables):
    from dynamask_torch.engine import load_jax_variables
    holder = _Holder(**{name: module})
    load_jax_variables(holder, {
        'params': {name: variables['params']},
        'batch_stats': {name: variables.get('batch_stats', {})}})
    return module


def _boxes(seed, n, size=64.0):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, size * 0.7, (n, 2))
    wh = r.uniform(4, size * 0.5, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], 1).astype(
        np.float32)


# -- anchors ------------------------------------------------------------------

ANCHORS = {
    'retina': dict(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
                   octave_base_scale=4, scales_per_octave=3),
    'atss': dict(strides=(8, 16, 32, 64, 128), ratios=(1.0,), scales=(8,)),
    'legacy': dict(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
                   octave_base_scale=4, scales_per_octave=3,
                   center_offset=0.5),
}


@pytest.mark.parametrize('kind', sorted(ANCHORS))
def test_anchors_and_valid_flags(kind):
    """Grid anchors bit for bit, and the valid flags of two un-padded
    extents, as JAX computes them (from ``img_shape``: 3ad)."""
    from dynamask_tpu.core import anchors as ja
    from dynamask_torch.core import anchors as ta
    name = 'LegacyAnchorGenerator' if kind == 'legacy' else 'AnchorGenerator'
    jgen = getattr(ja, name)(**ANCHORS[kind])
    tgen = getattr(ta, name)(**ANCHORS[kind])
    sizes = [(13, 21), (7, 11), (4, 6), (2, 3), (1, 2)]
    for a, b in zip(jgen.grid_anchors(sizes), tgen.grid_anchors(sizes)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    shapes = np.array([[100., 168.], [61., 90.]], np.float32)
    got = tgen.valid_flags(sizes, torch.from_numpy(shapes))
    for i, sh in enumerate(shapes):
        ref = jgen.valid_flags(sizes, jnp.asarray(sh))
        for lvl in range(len(sizes)):
            np.testing.assert_array_equal(got[lvl][i].numpy(),
                                          np.asarray(ref[lvl]))
    assert tgen.num_base_anchors == jgen.num_base_anchors[0]


def test_legacy_coder_matches_jax():
    from dynamask_tpu.core.coders import LegacyDeltaXYWHBBoxCoder as J
    from dynamask_torch.core.coders import LegacyDeltaXYWHBBoxCoder as T
    a, g = _boxes(1, 50), _boxes(2, 50)
    stds = (0.1, 0.1, 0.2, 0.2)
    enc = T((0., 0., 0., 0.), stds).encode(torch.from_numpy(a),
                                           torch.from_numpy(g))
    np.testing.assert_allclose(enc.numpy(), np.asarray(
        J((0., 0., 0., 0.), stds).encode(jnp.asarray(a), jnp.asarray(g))),
        rtol=1e-6, atol=1e-6)
    d = _rng(3, 50, 4)
    dec = T((0., 0., 0., 0.), stds).decode(torch.from_numpy(a),
                                           torch.from_numpy(d))
    np.testing.assert_allclose(dec.numpy(), np.asarray(
        J((0., 0., 0., 0.), stds).decode(jnp.asarray(a), jnp.asarray(d))),
        rtol=1e-6, atol=1e-4)


# -- the FPN's extra levels ---------------------------------------------------

FPNS = {
    'on_input': dict(start_level=1, add_extra_convs='on_input'),
    'on_output_relu': dict(start_level=1, add_extra_convs='on_output',
                           relu_before_extra_convs=True),
    'true_on_inputs': dict(start_level=1, add_extra_convs=True),
    'true_on_outputs': dict(start_level=1, add_extra_convs=True,
                            extra_convs_on_inputs=False),
    'bn_crop640': dict(start_level=1, add_extra_convs='on_input',
                       relu_before_extra_convs=True, no_norm_on_lateral=True,
                       norm='bn'),
    'gn_extra': dict(start_level=1, add_extra_convs='on_output', norm='gn',
                     gn_groups=8),
    'max_pool': dict(start_level=1),
    'end_level': dict(start_level=0, end_level=3, num_outs=4),
}
IN_CH = (16, 24, 32, 48)


def _feats(b=2):
    return [_rng(10 + i, b, 32 // 2 ** i, 48 // 2 ** i, c)
            for i, c in enumerate(IN_CH)]


@pytest.mark.parametrize('name', sorted(FPNS))
@pytest.mark.parametrize('train', [False, True])
def test_fpn_extra_levels(name, train):
    """Every level within 1e-5 relative L2 of JAX's; BN's batch statistics
    in training (and the running ones it leaves: flax's momentum 0.9 and
    biased variance)."""
    from dynamask_tpu.models.fpn import FPN as JFPN
    from dynamask_torch.models.fpn import FPN
    kw = dict(FPNS[name])
    kw.setdefault('num_outs', 5)
    feats = _feats()
    jf = JFPN(in_channels=IN_CH, out_channels=16, **kw)
    variables = randomize_variables(jf.init(jax.random.PRNGKey(0),
                                            [jnp.asarray(f) for f in feats]))
    port = _load('neck', FPN(in_channels=IN_CH, out_channels=16, **kw),
                 variables)
    port.train(train)
    if train:
        ref, upd = jf.apply(variables, [jnp.asarray(f) for f in feats],
                            train=True, mutable=['batch_stats'])
    else:
        ref = jf.apply(variables, [jnp.asarray(f) for f in feats])
    got = port([_nchw(f) for f in feats])
    assert len(got) == len(ref) == kw['num_outs']
    for g, r in zip(got, ref):
        assert g.shape == _nchw(r).shape
        assert rel_l2(_nhwc(g), np.asarray(r)) < RL2
    if train and kw.get('norm') == 'bn':
        stats = jax.device_get(upd['batch_stats'])
        assert rel_l2(port.fpn_convs[4].bn.running_var.numpy(),
                      stats['extra_gn_1']['var']) < RL2
    expected_extra = 2 if kw.get('add_extra_convs') else 0
    assert len(port.fpn_convs) - len(port.lateral_convs) == expected_extra


# -- the losses ---------------------------------------------------------------

def _logits_targets(seed, n=300, c=6):
    r = np.random.RandomState(seed)
    logits = (r.randn(n, c) * 3).astype(np.float32)
    onehot = np.eye(c + 1, dtype=np.float32)[r.randint(0, c + 1, n)][:, :c]
    weights = (r.uniform(size=(n, c)) > 0.2).astype(np.float32)
    return logits, onehot, weights


def _loss_and_grad(jfn, tfn, *arrays):
    """(port value, JAX value, port grad, JAX grad) w.r.t. the first."""
    jv, jg = jax.value_and_grad(jfn)(*map(jnp.asarray, arrays))
    x = torch.from_numpy(arrays[0]).requires_grad_()
    tv = tfn(x, *map(torch.from_numpy, arrays[1:]))
    tv.backward()
    return float(tv.detach()), float(jv), x.grad.numpy(), np.asarray(jg)


@pytest.mark.parametrize('which', ['focal', 'ghm_c', 'ghm_r'])
def test_losses_and_gradients(which):
    """The focal loss (JAX ``_focal_elementwise`` summed), GHM-C and GHM-R
    (stateless, 3ab), their values within 1e-5 and their gradients within
    1e-5 relative L2; GHM's bins are exact integer counts."""
    from dynamask_tpu.models import losses as jl
    from dynamask_tpu.models.single_stage import _focal_elementwise
    from dynamask_torch.models import losses as tl
    logits, onehot, weights = _logits_targets(4)
    if which == 'focal':
        got, ref, tg, jg = _loss_and_grad(
            lambda x, t, w: jnp.sum(_focal_elementwise(x, t, 2.0, 0.25) * w),
            lambda x, t, w: (tl.focal_elementwise(x, t, 2.0, 0.25) *
                             w).sum(), logits, onehot, weights)
    elif which == 'ghm_c':
        got, ref, tg, jg = _loss_and_grad(
            lambda x, t, w: jl.ghm_c_loss(x, t, w, 30),
            lambda x, t, w: tl.ghm_c_loss(x, t, w, 30),
            logits, onehot, weights)
    else:
        pred, tgt = _rng(5, 200, 4, scale=0.5), _rng(6, 200, 4, scale=0.5)
        w = (np.random.RandomState(7).uniform(size=(200, 4)) > 0.5).astype(
            np.float32)
        got, ref, tg, jg = _loss_and_grad(
            lambda x, t, w: jl.ghm_r_loss(x, t, w, 0.02, 10),
            lambda x, t, w: tl.ghm_r_loss(x, t, w, 0.02, 10), pred, tgt, w)
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert rel_l2(tg, jg) < RL2


def test_ghm_edges_are_jax_linspace():
    """GHM's bin edges are the float32 values of ``jnp.linspace``."""
    from dynamask_torch.models.losses import _ghm_edges
    for bins in (10, 30):
        want = np.asarray(jnp.linspace(0, 1, bins + 1))
        got = _ghm_edges(bins, 1.0, None).numpy()
        np.testing.assert_array_equal(got, want)


# -- the heads ----------------------------------------------------------------

def _level_feats(b=2, c=32, sizes=((8, 12), (4, 6), (2, 3))):
    return [_rng(20 + i, b, h, w, c) for i, (h, w) in enumerate(sizes)]


HEADS = ['retina', 'sepbn', 'atss', 'fcos_gn', 'fcos_plain']


def _heads(kind):
    from dynamask_tpu.models import atss as jatss, fcos as jfcos
    from dynamask_tpu.models import single_stage as jss
    from dynamask_torch.models import atss, fcos, single_stage as ss
    common = dict(num_classes=5, in_channels=32, feat_channels=32,
                  stacked_convs=2)
    if kind == 'retina':
        return jss.RetinaHead(**common, num_anchors=9), \
            ss.RetinaHead(**common, num_anchors=9)
    if kind == 'sepbn':
        return jss.RetinaSepBNHead(**common, num_ins=3, num_anchors=9), \
            ss.RetinaSepBNHead(**common, num_ins=3, num_anchors=9)
    if kind == 'atss':
        return jatss.ATSSHead(**common, num_levels=3, gn_groups=8), \
            atss.ATSSHead(**common, num_levels=3, gn_groups=8)
    gn = kind == 'fcos_gn'
    kw = dict(common, strides=(8, 16, 32))
    return (jfcos.FCOSHead(**kw, norm='gn' if gn else None, gn_groups=8,
                           centerness_on_reg=gn, norm_on_bbox=gn),
            fcos.FCOSHead(**kw, gn_groups=8 if gn else None,
                          centerness_on_reg=gn, norm_on_bbox=gn))


@pytest.mark.parametrize('kind', HEADS)
def test_heads_match_jax(kind):
    """Every output of every level within 1e-5 relative L2 of JAX's, the
    learned scales set per level; ``RetinaSepBNHead`` in training too
    (its per-level BatchNorms on batch statistics)."""
    jhead, port = _heads(kind)
    feats = _level_feats()
    jin = [jnp.asarray(f) for f in feats]
    variables = randomize_variables(jhead.init(jax.random.PRNGKey(0), jin))
    if 'scales' in variables['params']:
        variables['params']['scales'] = np.array([0.8, 1.3, 1.1], np.float32)
    _load('bbox_head', port, variables)
    for train in ([False, True] if kind == 'sepbn' else [False]):
        port.train(train)
        ref = (jhead.apply(variables, jin, train=True,
                           mutable=['batch_stats'])[0] if train
               else jhead.apply(variables, jin))
        got = port([_nchw(f) for f in feats])
        assert len(got) == len(ref)
        for gs, rs in zip(got, ref):
            for g, r in zip(gs, rs):
                assert rel_l2(_nhwc(g), np.asarray(r)) < RL2


# -- the dense anchor loss and decode -----------------------------------------

def _dense_case(seed=0, b=2, num_classes=5):
    """Head outputs over the toy levels of the ``retina`` anchors, with
    GTs over a 64x96 canvas, the second image's extent short of it."""
    from dynamask_torch.core.anchors import AnchorGenerator
    sizes = ((8, 12), (4, 6), (2, 3))
    gen = AnchorGenerator((8, 16, 32), (0.5, 1.0, 2.0), octave_base_scale=4,
                          scales_per_octave=3)
    cls = [_rng(seed + i, b, h, w, 9 * num_classes, scale=2.0)
           for i, (h, w) in enumerate(sizes)]
    reg = [_rng(seed + 10 + i, b, h, w, 36, scale=0.3)
           for i, (h, w) in enumerate(sizes)]
    gts = np.stack([_boxes(seed + 20 + i, 4, 64.0) for i in range(b)])
    labels = np.random.RandomState(seed).randint(0, num_classes, (b, 4))
    valid = np.ones((b, 4), bool)
    valid[1, 3] = False
    shapes = np.array([[64., 96.], [50., 70.]], np.float32)[:b]
    return gen, sizes, cls, reg, gts, labels.astype(np.int32), valid, shapes


LOSSES = {'focal': {}, 'ghm': dict(cls_loss_type='ghmc',
                                   reg_loss_type='ghmr'),
          'legacy': dict(legacy=True)}


@pytest.mark.parametrize('name', sorted(LOSSES))
def test_anchor_head_loss_matches_jax(name):
    """``anchor_head_loss`` on the same head outputs, anchors, valid flags
    and GTs: both losses within 1e-5."""
    from dynamask_tpu.core.assigners import MaxIoUAssigner as JA
    from dynamask_tpu.models.single_stage import anchor_head_loss as jloss
    from dynamask_torch.core.assigners import MaxIoUAssigner
    from dynamask_torch.core.coders import (DeltaXYWHBBoxCoder,
                                            LegacyDeltaXYWHBBoxCoder)
    from dynamask_torch.models.single_stage import anchor_head_loss
    gen, sizes, cls, reg, gts, labels, valid, shapes = _dense_case()
    anchors = torch.cat(gen.grid_anchors(sizes))
    av = torch.cat(gen.valid_flags(sizes, torch.from_numpy(shapes)), 1)
    kw = dict(LOSSES[name])
    legacy = kw.pop('legacy', False)
    stds = (0.1, 0.1, 0.2, 0.2) if legacy else (1., 1., 1., 1.)
    ref = jloss([jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
                jnp.asarray(anchors.numpy()), jnp.asarray(gts),
                jnp.asarray(labels), jnp.asarray(valid), 5,
                JA(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
                   match_low_quality=True), target_stds=stds,
                anchor_valid=jnp.asarray(av.numpy()), legacy=legacy, **kw)
    coder = (LegacyDeltaXYWHBBoxCoder if legacy else DeltaXYWHBBoxCoder)(
        (0., 0., 0., 0.), stds)
    got = anchor_head_loss(
        [_nchw(c) for c in cls], [_nchw(r) for r in reg], anchors, av,
        torch.from_numpy(gts), torch.from_numpy(labels).long(),
        torch.from_numpy(valid), 5, MaxIoUAssigner(0.5, 0.4, 0.0), coder,
        **kw)
    for k in ('loss_cls', 'loss_bbox'):
        assert float(ref[k]) > 0
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize('legacy', [False, True])
def test_anchor_head_get_dets_matches_jax(legacy):
    """Per level top-``nms_pre``, decode, clip, rescale, multiclass NMS:
    labels and validity equal, dets within 1e-5."""
    from dynamask_tpu.models.single_stage import anchor_head_get_dets as jget
    from dynamask_torch.core.coders import (DeltaXYWHBBoxCoder,
                                            LegacyDeltaXYWHBBoxCoder)
    from dynamask_torch.models.single_stage import anchor_head_get_dets
    gen, sizes, cls, reg, _, _, _, shapes = _dense_case(3)
    mlvl = gen.grid_anchors(sizes)
    scale = np.array([[1., 1., 1., 1.], [0.8, 0.8, 0.8, 0.8]], np.float32)
    ref = jget([jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
               [jnp.asarray(a.numpy()) for a in mlvl], jnp.asarray(shapes),
               jnp.asarray(scale), 5, nms_pre=60, max_per_img=30,
               legacy=legacy)
    coder = (LegacyDeltaXYWHBBoxCoder if legacy else DeltaXYWHBBoxCoder)()
    got = anchor_head_get_dets(
        [_nchw(c) for c in cls], [_nchw(r) for r in reg], mlvl,
        {'img_shape': torch.from_numpy(shapes),
         'scale_factor': torch.from_numpy(scale)}, 5, coder, nms_pre=60,
        max_per_img=30)
    dets, labels, valid = map(np.asarray, ref)
    assert valid.sum() >= 20
    np.testing.assert_array_equal(got['det_valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(), labels)
    np.testing.assert_allclose(got['dets'].numpy(), dets, rtol=1e-5,
                               atol=1e-5)


def test_free_anchor_object_probability_is_the_dense_max():
    """FreeAnchor's (anchor, class) object probability, one
    ``scatter_reduce``, equals JAX's dense max over the (GT, anchor, class)
    products, invalid GT slots and repeated labels among them."""
    r = np.random.RandomState(8)
    obj = r.uniform(size=(6, 40)).astype(np.float32)
    labels = np.array([2, 0, 2, 4, 1, 2])
    gvf = np.array([1, 1, 1, 0, 1, 1], np.float32)
    onehot = np.eye(5, dtype=np.float32)[labels] * gvf[:, None]
    want = np.max(obj[:, :, None] * onehot[:, None, :], 0)
    got = torch.zeros(40, 5).scatter_reduce_(
        1, torch.from_numpy(labels)[None].expand(40, -1),
        torch.from_numpy(obj * gvf[:, None]).T, reduce='amax')
    np.testing.assert_array_equal(got.numpy(), want)


# -- ATSS and FCOS ------------------------------------------------------------

def test_atss_assigner_matches_jax():
    """Candidates, thresholds and the claims of several GTs over five
    levels, with invalid anchors and GT slots: the assignment exact."""
    from dynamask_tpu.core.assigners import ATSSAssigner as JA
    from dynamask_torch.core.anchors import AnchorGenerator
    from dynamask_torch.core.assigners import ATSSAssigner
    gen = AnchorGenerator((8, 16, 32, 64, 128), (1.0,), scales=(8,))
    sizes = [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)]
    mlvl = gen.grid_anchors(sizes)
    anchors = torch.cat(mlvl)
    valid = torch.cat(gen.valid_flags(sizes, torch.tensor([[90., 110.]])),
                      1)[0]
    gts = np.concatenate([_boxes(30, 6, 96.0), _boxes(31, 2, 96.0) * 0.3])
    gvalid = np.ones(8, bool)
    gvalid[5] = False
    labels = np.arange(8, dtype=np.int32)
    n_lvl = tuple(m.shape[0] for m in mlvl)
    ref = JA(topk=9)(jnp.asarray(anchors.numpy()), jnp.asarray(valid.numpy()),
                     jnp.asarray(gts), jnp.asarray(gvalid),
                     jnp.asarray(labels), num_level_anchors=n_lvl)
    got = ATSSAssigner(9)(anchors, valid, torch.from_numpy(gts),
                          torch.from_numpy(gvalid),
                          torch.from_numpy(labels), n_lvl)
    assert int((np.asarray(ref.gt_inds) > 0).sum()) >= 6
    np.testing.assert_array_equal(got.gt_inds.numpy(),
                                  np.asarray(ref.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(ref.max_overlaps), atol=1e-6)


def test_atss_centerness_target_matches_jax():
    from dynamask_tpu.models.atss import atss_centerness_target as jct
    from dynamask_torch.models.atss import atss_centerness_target
    a, g = _boxes(40, 80), _boxes(41, 80)
    np.testing.assert_allclose(
        atss_centerness_target(torch.from_numpy(a), torch.from_numpy(g)),
        np.asarray(jct(jnp.asarray(a), jnp.asarray(g))), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize('center_sampling', [False, True])
def test_fcos_points_and_targets_match_jax(center_sampling):
    """The points of every level bit for bit; the labels, positives, ltrb
    targets and centerness of each point, with and without center
    sampling (radius 1.5)."""
    from dynamask_tpu.models import fcos as jf
    from dynamask_torch.models import fcos as tf
    sizes, strides = [(16, 20), (8, 10), (4, 5)], (8, 16, 32)
    jpts = jf.fcos_points(sizes, strides)
    tpts = tf.fcos_points(sizes, strides)
    for a, b in zip(jpts, tpts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    pts = torch.cat(tpts)
    ranges = ((-1, 32), (32, 64), (64, 1e8))
    rr = torch.cat([torch.tensor(r, dtype=torch.float32).expand(p.shape[0], 2)
                    for r, p in zip(ranges, tpts)])
    ps = torch.cat([torch.full((p.shape[0],), float(s))
                    for p, s in zip(tpts, strides)]) \
        if center_sampling else None
    gts = _boxes(50, 7, 128.0)
    labels = np.arange(7, dtype=np.int32) % 5
    gvalid = np.array([1, 1, 1, 0, 1, 1, 1], bool)
    ref = jf.fcos_targets(jnp.asarray(pts.numpy()), jnp.asarray(rr.numpy()),
                          jnp.asarray(gts), jnp.asarray(labels),
                          jnp.asarray(gvalid), 5,
                          None if ps is None else jnp.asarray(ps.numpy()))
    got = tf.fcos_targets(pts, rr, torch.from_numpy(gts),
                          torch.from_numpy(labels), torch.from_numpy(gvalid),
                          5, ps)
    assert int(np.asarray(ref[3]).sum()) >= 10
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-6)
