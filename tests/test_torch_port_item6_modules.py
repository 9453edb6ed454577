"""Item 6's FPN dense detectors' modules on the CPU, each against its JAX
counterpart on the same seeded numpy inputs, weights carried across by
``load_jax_variables``: ``TBLRBBoxCoder``, ``PointAssigner`` and
``CenterRegionAssigner`` (their tie rules), GFL's Quality and
Distribution Focal Losses and integral, RepPoints' point transforms and
grid, FoveaBox's targets, the five heads (GFL, FoveaBox plain and align,
RepPoints moment and grid, NAS-FCOS), the NAS-FCOS neck, the exact-gather
DCN at RepPoints' roaming offsets, the dense decode's top-k tie order, the
JAX faults 3be-3bh (ROADMAP.md queue 3), the keys the builder refuses, and
the entry points' shapes.

Tolerances, stated in each check: forward outputs within 1e-4 relative of
the largest value (``FWD_RTOL``), losses within 1e-5 relative, gradients
within 1e-4 relative L2; where an exact tie rule is at stake, float64 at
1e-9 (the exact gather at 1e-7: JAX sums it in fp32 under x64);
assignments, labels and orders exact.
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

from test_torch_port_item7_ops import (_jax_exact, _port,  # noqa: E402
                                       _reference)
from test_torch_port_modules import fast_jit, randomize_variables  # noqa: E402
from test_torch_port_single_stage_modules import (  # noqa: E402
    _boxes, _level_feats, _load, _nchw, _nhwc, _rng)
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
TIE_TOL = 1e-9


def close_to_largest(got, ref, tol=FWD_RTOL):
    """Every value within ``tol`` of the largest magnitude of ``ref``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, \
        np.abs(got - ref).max() / scale


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the coder and the assigners ---------------------------------------------

def test_tblr_coder_matches_jax():
    """Encode, decode and decode with ``max_shape`` (FSAF's clamp to the
    image) within 1e-6 relative of JAX's."""
    from dynamask_tpu.core.coders import TBLRBBoxCoder as J
    from dynamask_torch.core.coders import TBLRBBoxCoder as T
    priors, gts = _boxes(0, 40), _boxes(1, 40)
    tblr = _rng(2, 40, 4, scale=0.5)
    for norm in (4.0, 1.0):
        j, t = J(norm), T(norm)
        close_to_largest(t.encode(_t(priors), _t(gts)),
                         j.encode(priors, gts), 1e-6)
        close_to_largest(t.decode(_t(priors), _t(tblr)),
                         j.decode(priors, tblr), 1e-6)
        close_to_largest(t.decode(_t(priors), _t(tblr), (40, 50)),
                         j.decode(priors, tblr, (40, 50)), 1e-6)
    back = T().decode(_t(priors), T().encode(_t(priors), _t(gts)))
    np.testing.assert_allclose(back.numpy(), gts, rtol=1e-5, atol=1e-4)


def _points(sizes=((8, 8), (4, 4), (2, 2)), strides=(8, 16, 32)):
    from dynamask_torch.models.reppoints import reppoints_points
    return torch.cat(reppoints_points(sizes, strides)).numpy()


def _assign_both(jax_assigner, port_assigner, boxes, valid, gts, gvalid,
                 labels):
    ref = jax_assigner(jnp.asarray(boxes), jnp.asarray(valid),
                       jnp.asarray(gts), jnp.asarray(gvalid),
                       jnp.asarray(labels))
    got = port_assigner(_t(boxes), _t(valid), _t(gts), _t(gvalid),
                        _t(labels))
    return got, ref


def test_point_assigner_matches_jax():
    """Random GTs over three levels' points, an invalid GT slot and
    invalid points: every point's GT and label exact, the overlaps'
    stand-in within 1e-6."""
    from dynamask_tpu.core.assigners import PointAssigner as J
    from dynamask_torch.core.assigners import PointAssigner as T
    pts = _points()
    valid = np.ones(len(pts), bool)
    valid[::7] = False
    gts = _boxes(3, 6)
    gvalid = np.array([True] * 5 + [False])
    labels = np.arange(6, dtype=np.int64)
    for pos_num in (1, 3):
        got, ref = _assign_both(J(4, pos_num), T(4, pos_num), pts, valid, gts,
                                gvalid, labels)
        np.testing.assert_array_equal(got.gt_inds.numpy(), ref.gt_inds)
        np.testing.assert_array_equal(got.labels.numpy(), ref.labels)
        close_to_largest(got.max_overlaps, ref.max_overlaps, 1e-6)
        assert (np.asarray(ref.gt_inds) > 0).sum() >= 5


def test_point_assigner_takes_every_tie_3be():
    """3be: a GT whose centre lies halfway between two points of its level
    ties them at the ``pos_num``-th distance; JAX (and the port) make both
    positive where mmdet's ``topk`` takes exactly ``pos_num`` = 1."""
    from dynamask_tpu.core.assigners import PointAssigner as J
    from dynamask_torch.core.assigners import PointAssigner as T
    pts = _points()
    valid = np.ones(len(pts), bool)
    # 16 x 16 at scale 4: level log2(4) = 2 -> clipped to the stride-8
    # level 3; centre (20, 16) halfway between the points (16, 16), (24, 16)
    gts = np.array([[12., 8., 28., 24.]], np.float32)
    got, ref = _assign_both(J(4, 1), T(4, 1), pts, valid, gts,
                            np.array([True]), np.array([3]))
    np.testing.assert_array_equal(got.gt_inds.numpy(), ref.gt_inds)
    hit = np.flatnonzero(np.asarray(ref.gt_inds) > 0)
    assert len(hit) == 2 > 1
    np.testing.assert_array_equal(pts[hit, :2], [[16., 16.], [24., 16.]])


def test_center_region_assigner_matches_jax():
    """FSAF's cores and shadows over one-anchor-a-cell priors of three
    levels, overlapping GTs, an invalid GT and invalid anchors: the GT of
    every anchor, its label and the shadowed (anchor, GT) mask exact."""
    from dynamask_tpu.core.assigners import CenterRegionAssigner as J
    from dynamask_torch.core.assigners import CenterRegionAssigner as T
    pts = _points()
    half = pts[:, 2:3] / 2
    anchors = np.concatenate([pts[:, :2] + half - half,
                              pts[:, :2] + 2 * half], 1).astype(np.float32)
    valid = np.ones(len(anchors), bool)
    valid[::5] = False
    gts = _boxes(4, 6)
    gts[3] = gts[2] * 0.9 + 2
    gvalid = np.array([True] * 5 + [False])
    labels = np.arange(6, dtype=np.int64)
    for scales in ((0.2, 0.2), (0.5, 1.0)):
        j, t = J(*scales, 0.01), T(*scales, 0.01)
        ref, rsh = j.assign_with_shadow(*map(jnp.asarray, (
            anchors, valid, gts, gvalid, labels)))
        got, gsh = t.assign_with_shadow(*map(_t, (anchors, valid, gts,
                                                  gvalid, labels)))
        np.testing.assert_array_equal(got.gt_inds.numpy(), ref.gt_inds)
        np.testing.assert_array_equal(got.labels.numpy(), ref.labels)
        np.testing.assert_array_equal(gsh.numpy(), rsh)
        close_to_largest(got.max_overlaps, ref.max_overlaps, 1e-6)
        assert (np.asarray(ref.gt_inds) > 0).sum() >= 3


def test_center_region_assigner_tie_takes_the_first_gt():
    """Two GTs of equal area whose cores both hold an anchor: ``argmin``
    takes the first, on both sides."""
    from dynamask_tpu.core.assigners import CenterRegionAssigner as J
    from dynamask_torch.core.assigners import CenterRegionAssigner as T
    anchors = np.array([[8., 8., 16., 16.]], np.float32)
    gts = np.array([[0., 4., 24., 20.], [4., 0., 20., 24.]], np.float32)
    for order in ([0, 1], [1, 0]):
        g = gts[order]
        got, ref = _assign_both(J(0.5, 0.5), T(0.5, 0.5), anchors,
                                np.ones(1, bool), g, np.ones(2, bool),
                                np.array([5, 6]))
        assert int(ref.gt_inds[0]) == int(got.gt_inds[0]) == 1


# -- GFL's losses and integral -----------------------------------------------

def test_gfl_losses_and_gradients_float64():
    """QFL and DFL (targets on and between the integer bins: the floor's
    tie rule) and their gradients in float64 within 1e-9 of JAX's."""
    from dynamask_tpu.models.losses import (distribution_focal_loss as jdfl,
                                            quality_focal_loss as jqfl)
    from dynamask_torch.models.losses import (distribution_focal_loss,
                                              quality_focal_loss)
    rng = np.random.RandomState(5)
    logits = rng.randn(60, 6) * 2
    onehot = np.eye(7)[rng.randint(0, 7, 60)][:, :6]
    score = rng.uniform(size=60)
    weight = rng.uniform(size=(60, 1))
    dlog = rng.randn(60, 4, 17)
    target = np.where(rng.uniform(size=(60, 4)) < 0.3,
                      rng.randint(0, 16, (60, 4)), rng.uniform(0, 15.9,
                                                               (60, 4)))
    dw = rng.uniform(size=(60, 4))
    with jax.enable_x64(True):
        rq, gq = jax.value_and_grad(lambda x: jqfl(
            x, onehot, score, weight=weight, avg_factor=7.0))(logits)
        rd, gd = jax.value_and_grad(lambda x: jdfl(
            x, target, weight=dw, avg_factor=3.0))(dlog)
    x = _t(logits).requires_grad_()
    q = quality_focal_loss(x, _t(onehot), _t(score), weight=_t(weight),
                           avg_factor=7.0)
    q.backward()
    d_in = _t(dlog).requires_grad_()
    d = distribution_focal_loss(d_in, _t(target), weight=_t(dw),
                                avg_factor=3.0)
    d.backward()
    assert abs(q.item() - float(rq)) <= TIE_TOL * abs(float(rq))
    assert abs(d.item() - float(rd)) <= TIE_TOL * abs(float(rd))
    assert rel_l2(x.grad.numpy(), gq) < TIE_TOL
    assert rel_l2(d_in.grad.numpy(), gd) < TIE_TOL


def test_integral_and_distances_match_jax():
    from dynamask_tpu.models import gfl as jgfl
    from dynamask_torch.models import gfl
    logits = _rng(6, 30, 4 * 17, scale=3.0)
    close_to_largest(gfl.integral_decode(_t(logits), 16),
                     jgfl.integral_decode(logits, 16), 1e-6)
    pts = _rng(7, 30, 2, scale=20.0)
    boxes = _boxes(8, 30)
    close_to_largest(gfl.bbox2distance(_t(pts), _t(boxes), 16),
                     jgfl.bbox2distance(pts, boxes, 16), 1e-6)


# -- RepPoints' transforms, FoveaBox's targets --------------------------------

@pytest.mark.parametrize('method', ['moment', 'minmax', 'partial_minmax'])
def test_points2bbox_matches_jax(method):
    """Boxes and the gradient of their sum (weighted) in the points and the
    moment transfer within 1e-5 relative L2."""
    from dynamask_tpu.models import reppoints as jrp
    from dynamask_torch.models import reppoints as rp
    pts = _rng(9, 50, 9, 2, scale=10.0)
    mt = np.array([0.3, -0.2], np.float32)
    cot = _rng(10, 50, 4)
    ref, (gp, gm) = jax.value_and_grad(lambda p, m: jnp.sum(jrp.points2bbox(
        p, method, m, 0.01) * cot), argnums=(0, 1))(pts, mt)
    p, m = _t(pts).requires_grad_(), _t(mt).requires_grad_()
    out = (rp.points2bbox(p, method, m, 0.01) * _t(cot)).sum()
    out.backward()
    assert abs(out.item() - float(ref)) <= 1e-5 * abs(float(ref))
    assert rel_l2(p.grad.numpy(), gp) < 1e-5
    if method == 'moment':
        assert rel_l2(m.grad.numpy(), gm) < 1e-5


def test_gen_grid_from_reg_matches_jax():
    from dynamask_tpu.models import reppoints as jrp
    from dynamask_torch.models import reppoints as rp
    reg = _rng(11, 2, 5, 6, 4, scale=0.3)
    prev = np.broadcast_to(np.array([-2., -2., 2., 2.], np.float32),
                           reg.shape).copy()
    rpts, rbox = jrp.gen_grid_from_reg(reg, prev, 3)
    gpts, gbox = rp.gen_grid_from_reg(_t(reg), _t(prev), 3)
    close_to_largest(gpts, rpts, 1e-6)
    close_to_largest(gbox, rbox, 1e-6)


def test_fovea_targets_match_jax():
    """Each level's labels, positives (the smaller of two equal-area GTs
    the first) and log-space targets."""
    from dynamask_tpu.models import fovea as jfv
    from dynamask_torch.models import fovea as fv
    gts = _boxes(12, 6, size=128.0) * 1.5
    gts[4] = gts[3]
    labels = np.array([1, 2, 3, 4, 5, 6], np.int64)
    gvalid = np.array([True] * 5 + [False])
    for size, s, base, rng in (((16, 16), 8, 16, (1, 64)),
                               ((8, 8), 16, 32, (32, 128))):
        ref = jfv.fovea_targets_level(*map(jnp.asarray, (gts, labels,
                                                         gvalid)),
                                      size, float(s), float(base), rng, 0.4,
                                      8)
        got = fv.fovea_targets_level(_t(gts), _t(labels), _t(gvalid), size,
                                     float(s), float(base), rng, 0.4, 8)
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        np.testing.assert_array_equal(got[2].numpy(), ref[2])
        close_to_largest(got[1], ref[1], 1e-6)
        assert np.asarray(ref[2]).sum() >= 3


def test_dense_top_k_takes_the_lower_index_of_equal_scores():
    """``dense_get_dets`` picks the ``nms_pre`` candidates a level in
    ``jax.lax.top_k``'s order: among equal max-class scores the lower
    index first."""
    from dynamask_torch.ops.point_sample import top_k
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    for k in (2, 3, 4):
        np.testing.assert_array_equal(top_k(_t(x), k)[1].numpy(),
                                      np.asarray(jax.lax.top_k(x, k)[1]))


# -- the heads and the NAS-FCOS neck -----------------------------------------

HEADS = ['gfl', 'fovea', 'fovea_align', 'reppoints', 'reppoints_grid',
         'nas_fcos']


def _heads(kind):
    from dynamask_tpu.models import (fovea as jfv, gfl as jgfl,
                                     nasfcos as jnas, reppoints as jrp)
    from dynamask_torch.models import fovea, gfl, nasfcos, reppoints
    c = dict(num_classes=5, in_channels=32, feat_channels=32)
    if kind == 'gfl':
        return (jgfl.GFLHead(**c, stacked_convs=2, num_levels=3,
                             gn_groups=8),
                gfl.GFLHead(**c, stacked_convs=2, num_levels=3, gn_groups=8))
    if kind.startswith('fovea'):
        align = kind == 'fovea_align'
        return (jfv.FoveaHead(**c, stacked_convs=2, with_deform=align,
                              deform_groups=4, norm='gn' if align else None,
                              gn_groups=8),
                fovea.FoveaHead(**c, stacked_convs=2, with_deform=align,
                                deform_groups=4,
                                gn_groups=8 if align else None))
    if kind.startswith('reppoints'):
        grid = kind == 'reppoints_grid'
        return (jrp.RepPointsHead(**c, point_feat_channels=32,
                                  stacked_convs=1, gn_groups=8,
                                  use_grid_points=grid),
                reppoints.RepPointsHead(**c, point_feat_channels=32,
                                        stacked_convs=1, gn_groups=8,
                                        use_grid_points=grid))
    return (jnas.NASFCOSHead(num_classes=5, feat_channels=32,
                             strides=(8, 16, 32), gn_groups=8),
            nasfcos.NASFCOSHead(**c, strides=(8, 16, 32), gn_groups=8))


@pytest.mark.parametrize('kind', HEADS)
def test_heads_match_jax(kind):
    """Every output of every level (scores, distributions, log distances,
    the init and refined points, NAS-FCOS' distances and centerness)
    within 1e-4 of the largest of JAX's, the learned scales set a level;
    the DCN offsets of the align head, RepPoints and NAS-FCOS roam as the
    randomised weights send them."""
    jhead, port = _heads(kind)
    # NAS-FCOS' head on one level: JAX compiles its DCNv2 towers a level
    feats = _level_feats()[:1 if kind == 'nas_fcos' else 3]
    jin = [jnp.asarray(f) for f in feats]
    variables = randomize_variables(fast_jit(jhead.init)(jax.random.PRNGKey(0),
                                                        jin))
    params = variables['params']
    if 'scales' in params:
        params['scales'] = np.array([0.8, 1.3, 1.1], np.float32)
    if kind == 'fovea_align':     # offsets of a few pixels
        params['feature_adaption_offset']['kernel'] = _rng(
            13, 1, 1, 4, 72, scale=0.5)
    moment = getattr(port, 'moment_transfer', None)
    holder_vars = dict(variables)
    if moment is not None:
        holder_vars['params'] = dict(params, moment_transfer=np.zeros(2))
        del port.moment_transfer       # a detector's leaf in JAX
    _load('bbox_head', port, holder_vars)
    if kind == 'nas_fcos':
        return check_nas_head_gradients(jhead, variables, port, feats)
    ref = fast_jit(jhead.apply)(variables, jin)
    got = port([_nchw(f) for f in feats])
    assert len(got) == len(ref)
    for gs, rs in zip(got, ref):
        assert len(gs) == len(rs) == 3
        for g, r in zip(gs, rs):
            close_to_largest(_nhwc(g), r)


def check_nas_head_gradients(jhead, variables, port, feats):
    """NAS-FCOS' head: its outputs as the other heads', and the gradients
    of a seeded weighting of them in every parameter (the windowed DCNv2s'
    offset convs among them) and in the levels within 1e-4 relative L2 of
    JAX's, from one compile, on one level (the other heads' and the
    detector twins' run on several). The detector twin
    (``test_torch_port_item6_detectors_nas.py``) holds its dets and
    losses; its gradients are held here, at the head, where JAX compiles
    the DCNv2 towers once."""
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    jin = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(jhead.apply, variables, jin)
    cots = jax.tree_util.tree_map(
        lambda x: _rng(50, *x.shape), shapes)

    def f(params, xs):
        out = jhead.apply({'params': params}, xs)
        return sum(jnp.sum(o * c) for o, c in zip(
            jax.tree_util.tree_leaves(out),
            jax.tree_util.tree_leaves(cots))), out

    (rl, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables['params'], jin)
    xs = [_nchw(x).requires_grad_() for x in feats]
    got = port(xs)
    for gs, rs in zip(got, ref):
        for g, r in zip(gs, rs):
            close_to_largest(_nhwc(g.detach()), r)
    loss = sum((o * _nchw(c)).sum() for o, c in zip(
        [t for level in got for t in level],
        jax.tree_util.tree_leaves(cots)))
    loss.backward()
    assert abs(loss.item() - float(rl)) <= LOSS_RTOL * abs(float(rl))
    for x, g in zip(xs, gx):
        assert rel_l2(_nhwc(x.grad), g) < GRAD_RL2
    gp = {'bbox_head': jax.device_get(gp)}
    n_offsets = 0
    for k, p in port.named_parameters():
        r = _torch_layout(gp, {}, *mmdet_key('bbox_head.' + k,
                                             head='NASFCOSHead'))
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        assert rel_l2(g, r) < GRAD_RL2, k
        n_offsets += 'conv_offset' in k and np.abs(r).max() > 0
    assert n_offsets == 8


def _nas_neck():
    from dynamask_tpu.models.nasfcos import NASFCOS_FPN as J
    from dynamask_torch.models.nasfcos import NASFCOS_FPN as T
    chans = (16, 24, 32, 40)
    return J(in_channels=chans, out_channels=16), T(chans, 16), chans


def test_nasfcos_neck_matches_jax():
    """The searched pyramid in eval and in training (its BatchNorms on
    batch statistics; the running statistics after one pass), and the
    gradients in its inputs and parameters: every level within 1e-4 of
    the largest, gradients within 1e-4 relative L2; the bilinear resizes
    go up (c5 to c3) and antialiased down (c3 to c4)."""
    jneck, port, chans = _nas_neck()
    sizes = ((32, 48), (16, 24), (8, 12), (4, 6))
    feats = [_rng(30 + i, 2, h, w, c) for i, ((h, w), c) in
             enumerate(zip(sizes, chans))]
    jin = [jnp.asarray(f) for f in feats]
    variables = randomize_variables(fast_jit(jneck.init)(jax.random.PRNGKey(0),
                                                        jin))
    _load('neck', port, variables)
    ref = fast_jit(jneck.apply)(variables, jin)
    got = port.eval()([_nchw(f) for f in feats])
    assert [g.shape[-2:] for g in got] == [(16, 24), (8, 12), (4, 6),
                                           (2, 3), (1, 2)]
    for g, r in zip(got, ref):
        close_to_largest(_nhwc(g), r)
    cots = [_rng(40 + i, *np.shape(r)) for i, r in enumerate(ref)]

    def jloss(params, xs):
        out, upd = jneck.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, xs,
            train=True, mutable=['batch_stats'])
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), upd

    (rl, upd), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables['params'], jin)
    xs = [_nchw(f).requires_grad_() for f in feats]
    port.train()
    out = port(xs)
    loss = sum((_nchw(c) * o).sum() for o, c in zip(out, cots))
    loss.backward()
    assert abs(loss.item() - float(rl)) <= LOSS_RTOL * abs(float(rl))
    for x, g in zip(xs[1:], gx[1:]):
        assert rel_l2(_nhwc(x.grad), g) < GRAD_RL2
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    for k, p in port.named_parameters():
        r = _torch_layout({'neck': jax.device_get(gp)}, {},
                          *mmdet_key('neck.' + k))
        assert rel_l2(p.grad.numpy(), r) < GRAD_RL2, k
    stats = {'neck': jax.device_get(upd['batch_stats'])}
    for k, v in port.state_dict().items():
        if k.endswith(('running_mean', 'running_var')):
            r = _torch_layout({}, stats, *mmdet_key('neck.' + k))
            close_to_largest(v.numpy(), r, 1e-5)


# -- the exact gather at RepPoints' offsets -----------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_exact_gather_at_roaming_offsets(dtype):
    """RepPoints' DCNs take offsets of many pixels, most samples off the
    plane, some on integer positions (JAX's tie rule, 3ak): forward and
    every gradient within 1e-5 relative L2 of JAX's in fp32; in float64
    within 1e-7 of JAX's under ``jax_enable_x64`` (which still sums the
    gather in fp32: 2.5e-8 apart on this input)."""
    from dynamask_torch.ops.deform_conv import deform_conv2d_exact
    rng = np.random.RandomState(14)
    n, h, w, c = 2, 6, 7, 8
    x = rng.randn(n, h, w, c)
    # eighths: the port's fp32 positions and corner weights are exact
    off = np.round(rng.uniform(-12, 12, (n, h, w, 18)) * 8) / 8
    off[..., ::3] = np.round(off[..., ::3])
    wt = rng.randn(3, 3, c, 5) / np.sqrt(9 * c)
    cot = rng.randn(n, h, w, 5)
    args = [a.astype(dtype) for a in (x, off, np.zeros((n, h, w, 9)), wt)]
    cot = cot.astype(dtype)
    tol = 1e-7 if dtype == 'float64' else 1e-5
    with jax.enable_x64(dtype == 'float64'):
        ref = _reference(_jax_exact(1, 1, False), args, cot, (0, 1, 3))
    got = _port(lambda x, o, m, w: deform_conv2d_exact(x, o, w, None, 3, 1,
                                                       1, 1, 1),
                args, cot, (0, 1, 3))
    assert got[0].dtype == np.dtype(dtype)
    assert rel_l2(got[0], ref[0]) < tol
    for a, b in zip(got[1], ref[1]):
        assert np.abs(b).max() > 0 and rel_l2(a, b) < tol
    off_plane = np.abs(off) > 7
    assert off_plane.mean() > 0.3


# -- the JAX faults -----------------------------------------------------------

def test_nas_head_window_clips_offsets_3bf():
    """3bf: NAS-FCOS' head DCNv2 is JAX's windowed form, its displacements
    clipped to +-3; mmcv's DCNv2 is unbounded. Within the window the two
    agree (1e-5 relative L2); with offsets past it they part, the port
    keeping JAX's."""
    from dynamask_tpu.ops.deform_conv import modulated_deform_conv2d as jmd
    from dynamask_torch.ops.deform_conv import (deform_conv2d_exact,
                                                modulated_deform_conv2d)
    rng = np.random.RandomState(15)
    x = rng.randn(1, 12, 12, 8).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(1, 12, 12, 18)))).astype(np.float32)
    wt = (rng.randn(3, 3, 8, 4) / 8).astype(np.float32)
    errs = {}
    for amp in (1.5, 6.0):
        off = rng.uniform(-amp, amp, (1, 12, 12, 36)).astype(np.float32)
        win = modulated_deform_conv2d(*map(_t, (x, off, mask, wt)), 3, 1, 1,
                                      2).numpy()
        close_to_largest(win, jmd(x, off, mask, wt, deform_groups=2))
        free = deform_conv2d_exact(_t(x), _t(off), _t(wt), _t(mask), 3, 1, 1,
                                   1, 2).numpy()
        errs[amp] = rel_l2(win, free)
    assert errs[1.5] < 1e-5 and errs[6.0] > 0.1, errs


def test_nasfcos_neck_drops_dcn_and_bn_3bg():
    """3bg: JAX's builder drops the NAS-FCOS neck's ``conv_cfg=DCNv2`` and
    ``norm_cfg=BN`` (its cells' input convs are bias-free 3x3 convs): the
    config's neck and one without the two keys have one parameter tree.
    The port builds that neck, refuses another value of either key, and
    refuses by name, on load, a tensor of mmcv's DCNv2 / BN input convs."""
    from dynamask_tpu.models.builder import build_neck as jneck
    from dynamask_torch.models.builder import build_neck
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_'
        '1x_coco.py')).to_dict()['model']['neck']
    assert cfg['conv_cfg'] == {'type': 'DCNv2'} and \
        cfg['norm_cfg'] == {'type': 'BN'}
    bare = {k: v for k, v in cfg.items() if k not in ('conv_cfg', 'norm_cfg')}
    feats = [jnp.zeros((1, 64 // s, 64 // s, c)) for s, c in
             zip((4, 8, 16, 32), cfg['in_channels'])]
    trees = [jax.eval_shape(jneck(copy.deepcopy(c)).init,
                            jax.random.PRNGKey(0), feats)
             for c in (cfg, bare)]
    assert jax.tree_util.tree_structure(trees[0]) == \
        jax.tree_util.tree_structure(trees[1])
    cell = trees[0]['params']['c22_1']
    assert set(cell) == {'input1_conv', 'input2_conv', 'out_bn', 'out_conv'}
    assert set(cell['input1_conv']) == {'kernel'}
    with torch.device('meta'):
        neck = build_neck(cfg)
        for key, val in (('conv_cfg', {'type': 'DCN'}),
                         ('norm_cfg', {'type': 'GN', 'num_groups': 32})):
            with pytest.raises(NotImplementedError, match=key):
                build_neck(dict(cfg, **{key: val}))
    sd = {k: torch.zeros(v.shape) for k, v in neck.state_dict().items()}
    sd['fpn.c22_1.input1_conv.conv.conv_offset.weight'] = torch.zeros(
        27, 256, 3, 3)
    with pytest.raises(ValueError, match='3bg'):
        neck.load_state_dict(sd)


def test_jax_importer_skips_the_item6_heads_3bh():
    """3bh: the JAX package's mmdet importer has no rule for the five
    heads, RepPoints' moment transfer or the NAS-FCOS neck: it skips each
    such tensor of a checkpoint (the port's map carries them)."""
    from dynamask_tpu.engine.pretrained import _mmdet_key as jax_key
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    skipped = 0
    for rel in ('gfl/gfl_r50_fpn_1x_coco.py', 'fsaf/fsaf_r50_fpn_1x_coco.py',
                'foveabox/fovea_align_r50_fpn_gn-head_4x4_2x_coco.py',
                'reppoints/reppoints_moment_r50_fpn_gn-neck+head_1x_coco.py',
                'nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_'
                'coco.py'):
        cfg = Config.fromfile(os.path.join(ROOT, 'configs', rel))
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                               device='meta')
        hints = key_hints(model)
        for k in model.state_dict():
            if k.endswith('num_batches_tracked'):
                continue
            if k.startswith('bbox_head.') or k.startswith('neck.fpn.') or \
                    k.startswith('neck.adapt_convs'):
                assert mmdet_key(k, **hints) is not None, k
                assert jax_key(k) is None, k
                skipped += 1
    assert skipped > 100


# -- the builder's refusals and the entry points' shapes ----------------------

CONFIGS = {
    'gfl': 'gfl/gfl_r50_fpn_1x_coco.py',
    'fsaf': 'fsaf/fsaf_r50_fpn_1x_coco.py',
    'fovea': 'foveabox/fovea_r50_fpn_4x4_1x_coco.py',
    'reppoints': 'reppoints/reppoints_moment_r50_fpn_gn-neck+head_1x_coco.py',
    'nas_fcos': 'nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_'
                'coco.py',
}
# (config, the head key to set, its value, what the refusal names): keys
# JAX reads not (3w), or reads from elsewhere
REFUSALS = [
    ('gfl', 'loss_cls', dict(type='QualityFocalLoss', use_sigmoid=True,
                             beta=1.0, loss_weight=1.0), 'loss_cls'),
    ('gfl', 'norm_cfg', dict(type='GN', num_groups=16), 'GN groups'),
    ('fsaf', 'loss_bbox', dict(type='GIoULoss', loss_weight=1.0),
     'loss_bbox'),
    ('fsaf', 'anchor_generator', dict(type='AnchorGenerator',
                                      octave_base_scale=2,
                                      scales_per_octave=1, ratios=[1.0],
                                      strides=[8, 16, 32, 64, 128]),
     'anchor_generator'),
    ('fovea', 'loss_cls', dict(type='FocalLoss', use_sigmoid=True, gamma=1.5,
                               alpha=0.4, loss_weight=2.0), 'loss_cls'),
    ('reppoints', 'loss_bbox_refine', dict(type='SmoothL1Loss', beta=0.5,
                                           loss_weight=1.0),
     'loss_bbox_refine'),
    ('reppoints', 'loss_cls', dict(type='FocalLoss', use_sigmoid=True,
                                   gamma=1.5, alpha=0.25, loss_weight=1.0),
     'loss_cls'),
    ('nas_fcos', 'dcn_on_last_conv', True, 'NASFCOSHead'),
]


@pytest.mark.parametrize('kind,key,value,what', REFUSALS)
def test_builder_refuses_what_jax_does_not_compute(kind, key, value, what):
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', CONFIGS[kind]))
    model = cfg.model.to_dict() if hasattr(cfg.model, 'to_dict') else \
        dict(cfg.model)
    model['bbox_head'] = dict(model['bbox_head'], **{key: value})
    with pytest.raises(NotImplementedError, match=what):
        build_detector(model, cfg.train_cfg, cfg.test_cfg, device='meta')


@pytest.mark.parametrize('kind', sorted(CONFIGS))
def test_entry_shapes_and_classes(kind):
    """``config_shapes``: the test canvas 800x1333 padded to 800x1344 and
    the train batch of 4 images (the 4x4 schedules of FoveaBox and
    NAS-FCOS, the 4-image batch of the others); the built detector's class
    the config's type."""
    from dynamask_torch.apis import config_shapes
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    path = os.path.join(ROOT, 'configs', CONFIGS[kind])
    test_hw, images, train_hw = config_shapes(path)
    assert images == 4
    assert tuple(test_hw) == (800, 1344) and max(train_hw) == 1344
    cfg = Config.fromfile(path)
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           device='meta')
    assert type(model).__name__ == cfg.model.type
