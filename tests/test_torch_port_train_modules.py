"""Training modules of the PyTorch port against the JAX package, on the CPU
in fp32: target assignment and sampling, anchor validity, the RPN, box and
DynaMask losses, mask and detail targets, Gumbel routing, the MSM in
training mode and the optimizer.

Random draws are injected into both sides. The port's sampler and Gumbel
take their uniforms as tensors; on the JAX side the test replaces, for the
call only, the module-level ``jax`` name of ``dynamask_tpu.core.samplers``
(whose ``jax.random.uniform`` gives the sampler its priorities) with a proxy
that returns the same draws. The JAX package itself is not changed.

Tolerances: losses and gradients are fp32 sums in other orders on the two
sides, ~1e-6 relative; 1e-5 relative plus 1e-6 absolute leaves margin.
Integer outputs (assignments, sample slots, binary targets) must be equal.
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

RTOL, ATOL = 1e-5, 1e-6


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, ref, msg='', rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


@contextlib.contextmanager
def jax_sampler_priorities(tables):
    """While active, the JAX ``RandomSampler`` draws its priorities from
    ``tables`` ({candidate count: (n,) array}) instead of its key. Under the
    JAX package's vmap over images every image gets the same table."""
    import dynamask_tpu.core.samplers as js

    class _Proxy(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jax, name)

    proxy = _Proxy('jax')
    proxy.random = types.SimpleNamespace(
        uniform=lambda key, shape, *a, **k: jnp.asarray(tables[shape[0]]))
    saved = js.jax
    js.jax = proxy
    try:
        yield
    finally:
        js.jax = saved


def random_boxes(rng, n, size=64.0, lo=6.0, hi=30.0):
    xy = rng.uniform(-4, size - 8, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _assign_inputs(seed=0, n=300, k=6):
    rng = np.random.RandomState(seed)
    gts = random_boxes(rng, k)
    boxes = np.concatenate([random_boxes(rng, n - 2 * k), gts,
                            gts + rng.uniform(-2, 2, gts.shape)], 0)
    box_valid = rng.uniform(size=n) > 0.1
    gt_valid = np.asarray([1, 1, 1, 1, 0, 1], bool)[:k]
    labels = rng.randint(0, 8, k)
    return boxes.astype(np.float32), box_valid, gts, gt_valid, labels


@pytest.mark.parametrize('thr', [(0.5, 0.5, 0.5), (0.7, 0.3, 0.3)],
                         ids=['rcnn', 'rpn'])
def test_max_iou_assigner(thr):
    from dynamask_tpu.core.assigners import MaxIoUAssigner as JA
    from dynamask_torch.core.assigners import MaxIoUAssigner
    boxes, bv, gts, gv, labels = _assign_inputs()
    ref = JA(*thr, match_low_quality=True)(
        jnp.asarray(boxes), jnp.asarray(bv), jnp.asarray(gts),
        jnp.asarray(gv), jnp.asarray(labels, jnp.int32))
    got = MaxIoUAssigner(*thr, match_low_quality=True)(
        _t(boxes), _t(bv), _t(gts), _t(gv), _t(labels))
    for name, a, b in zip(ref._fields, got, ref):
        if name == 'max_overlaps':
            _close(a, b, name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    gi = got.gt_inds.numpy()
    assert (gi > 0).sum() > 5 and (gi == 0).sum() > 50 and (gi < 0).any()


@pytest.mark.parametrize('num,frac', [(64, 0.25), (256, 0.5)])
def test_random_sampler_with_gt_as_proposals(num, frac):
    """Injected priorities: the same slots, packing (positives, negatives,
    padding) and targets on both sides; GTs put in front of the
    proposals."""
    from dynamask_tpu.core.assigners import MaxIoUAssigner as JA
    from dynamask_tpu.core.samplers import RandomSampler as JS
    from dynamask_tpu.core.samplers import add_gt_as_proposals as jadd
    from dynamask_torch.core.assigners import MaxIoUAssigner
    from dynamask_torch.core.samplers import (RandomSampler,
                                              add_gt_as_proposals)
    props, pv, gts, gv, labels = _assign_inputs(seed=1, n=200)
    jb, jv = jadd(jnp.asarray(props), jnp.asarray(pv), jnp.asarray(gts),
                  jnp.asarray(gv))
    tb, tv = add_gt_as_proposals(_t(props), _t(pv), _t(gts), _t(gv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    pri = np.random.RandomState(2).uniform(size=tb.shape[0]).astype(
        np.float32)
    ja = JA(0.5, 0.5, 0.5)(jb, jv, jnp.asarray(gts), jnp.asarray(gv),
                           jnp.asarray(labels, jnp.int32))
    with jax_sampler_priorities({tb.shape[0]: pri}):
        ref = JS(num, frac)(jax.random.PRNGKey(0), ja, jb, jnp.asarray(gts))
    ta = MaxIoUAssigner(0.5, 0.5, 0.5)(tb, tv, _t(gts), _t(gv), _t(labels))
    got = RandomSampler(num, frac)(ta, tb, _t(gts), priorities=_t(pri))
    for name, a, b in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    pos, valid = got.is_pos.numpy(), got.valid.numpy()
    k = int(pos.sum())
    assert 0 < k <= round(num * frac) and pos[:k].all()
    assert valid[:int(valid.sum())].all()


def test_anchor_valid_flags():
    from dynamask_tpu.core.anchors import AnchorGenerator as JAG
    from dynamask_torch.core.anchors import AnchorGenerator
    cfg = dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0],
               scales=[8])
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    shapes = np.asarray([[64., 96.], [41., 70.]], np.float32)
    got = AnchorGenerator(**cfg).valid_flags(sizes, _t(shapes))
    gen = JAG(**cfg)
    for i, s in enumerate(shapes):
        ref = gen.valid_flags(sizes, jnp.asarray(s))
        for lvl, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b),
                                          f'image {i} level {lvl}')
    assert not got[0][1].all() and got[0][0].all()


def test_rpn_loss():
    """Losses and their gradients w.r.t. the score and delta maps, with
    injected sampler priorities and a padded canvas (invalid anchors)."""
    from dynamask_tpu.core.anchors import AnchorGenerator as JAG
    from dynamask_tpu.core.assigners import MaxIoUAssigner as JA
    from dynamask_tpu.core.samplers import RandomSampler as JS
    from dynamask_tpu.models.rpn_head import rpn_loss as jloss
    from dynamask_torch.core.anchors import AnchorGenerator
    from dynamask_torch.core.assigners import MaxIoUAssigner
    from dynamask_torch.core.samplers import RandomSampler
    from dynamask_torch.models.rpn_head import rpn_loss
    rng = np.random.RandomState(3)
    b = 2
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    cfg = dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0],
               scales=[8])
    cls = [rng.randn(b, h, w, 3).astype(np.float32) for h, w in sizes]
    reg = [rng.randn(b, h, w, 12).astype(np.float32) * 0.3
           for h, w in sizes]
    gts = np.stack([random_boxes(rng, 4) for _ in range(b)])
    gv = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    shapes = np.asarray([[64., 64.], [48., 56.]], np.float32)
    jgen = JAG(**cfg)
    anchors = jnp.concatenate(jgen.grid_anchors(sizes), 0)
    av = jnp.stack([jnp.concatenate(jgen.valid_flags(sizes, s), 0)
                    for s in jnp.asarray(shapes)])
    n = anchors.shape[0]
    pri = rng.uniform(size=n).astype(np.float32)

    def jfn(c, r):
        return jloss(c, r, anchors, av, jnp.asarray(gts), jnp.asarray(gv),
                     jax.random.PRNGKey(0), JA(0.7, 0.3, 0.3), JS(64, 0.5),
                     loss_cls_weight=1.0, loss_bbox_weight=1.0)

    with jax_sampler_priorities({n: pri}):
        ref = jfn([jnp.asarray(c) for c in cls],
                  [jnp.asarray(r) for r in reg])
        gref = jax.grad(lambda c, r: sum(jfn(c, r).values()), (0, 1))(
            [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])

    tgen = AnchorGenerator(**cfg)
    ct = [_t(c.transpose(0, 3, 1, 2), True) for c in cls]
    rt = [_t(r.transpose(0, 3, 1, 2), True) for r in reg]
    got = rpn_loss(ct, rt, torch.cat(tgen.grid_anchors(sizes)),
                   torch.cat(tgen.valid_flags(sizes, _t(shapes)), 1),
                   _t(gts), _t(gv), MaxIoUAssigner(0.7, 0.3, 0.3),
                   RandomSampler(64, 0.5),
                   priorities=_t(np.stack([pri] * b)))
    for k in ref:
        _close(got[k], ref[k], k)
    grads = torch.autograd.grad(sum(got.values()), ct + rt)
    for a, b_ in zip(grads, list(gref[0]) + list(gref[1])):
        _close(a.permute(0, 2, 3, 1), b_, 'map grad')
    assert float(got['loss_rpn_bbox'].detach()) > 0


def _sample_np(rng, n=48, k=5, num_classes=8):
    from collections import namedtuple
    is_pos = rng.uniform(size=n) < 0.3
    valid = rng.uniform(size=n) < 0.9
    gt_boxes = random_boxes(rng, k)
    gt_inds = np.where(is_pos, rng.randint(0, k, n), 0)
    labels = np.where(is_pos, rng.randint(0, num_classes, n), -1)
    boxes = gt_boxes[gt_inds] + rng.uniform(-3, 3, (n, 4)).astype(np.float32)
    target = np.where(is_pos[:, None], gt_boxes[gt_inds], 0.0)
    fields = ('inds', 'is_pos', 'valid', 'boxes', 'gt_inds', 'labels',
              'target_boxes')
    return namedtuple('S', fields)(np.arange(n), is_pos, valid,
                                   boxes.astype(np.float32), gt_inds, labels,
                                   target.astype(np.float32))


def test_bbox_targets_and_loss():
    from dynamask_tpu.core.samplers import SamplingResult as JSR
    from dynamask_tpu.models.bbox_head import (bbox_head_loss as jloss,
                                               bbox_targets_from_sample as jt)
    from dynamask_torch.core.samplers import SamplingResult
    from dynamask_torch.models.bbox_head import (bbox_head_loss,
                                                 bbox_targets_from_sample)
    rng = np.random.RandomState(4)
    s = _sample_np(rng)
    means, stds = (0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2)
    cls = rng.randn(48, 9).astype(np.float32)
    reg = rng.randn(48, 32).astype(np.float32)
    jsr = JSR(*[jnp.asarray(f) for f in s])
    tref = jt(jsr, 8, means, stds)
    tsr = SamplingResult(*[_t(f) for f in s])
    tgot = bbox_targets_from_sample(tsr, 8, means, stds)
    for name, a, b in zip(tref._fields, tgot, tref):
        _close(a, b, name)

    def jfn(c, r):
        out = jloss(c, r, tref, 8, loss_cls_weight=2.0, loss_bbox_weight=2.0)
        return out['loss_cls'] + out['loss_bbox'], out

    (_, ref), gref = jax.value_and_grad(jfn, (0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    ct, rt = _t(cls, True), _t(reg, True)
    got = bbox_head_loss(ct, rt, tgot, 8, 2.0, 2.0)
    for k in ('loss_cls', 'loss_bbox', 'acc'):
        _close(got[k], ref[k], k)
    grads = torch.autograd.grad(got['loss_cls'] + got['loss_bbox'], (ct, rt))
    for a, b in zip(grads, gref):
        _close(a, b, 'grad')


@pytest.mark.parametrize('out_size', [14, 28, 56, 112])
def test_mask_targets_from_crops(out_size):
    from dynamask_tpu.core.mask_targets import mask_targets_from_crops as jm
    from dynamask_torch.core.mask_targets import mask_targets_from_crops
    rng = np.random.RandomState(out_size)
    b, g, s, r = 2, 3, 16, 10
    gts = np.stack([random_boxes(rng, g) for _ in range(b)])
    windows = gts + np.asarray([-2, -2, 2, 2], np.float32)
    yy, xx = np.meshgrid(np.linspace(-1, 1, s), np.linspace(-1, 1, s),
                         indexing='ij')
    radii = rng.uniform(0.4, 0.9, (b, g, 1, 1))
    crops = ((yy ** 2 + xx ** 2) < radii ** 2).astype(np.uint8)
    roi_b = rng.randint(0, b, r)
    roi_g = rng.randint(0, g, r)
    rois = gts[roi_b, roi_g] + rng.uniform(-4, 4, (r, 4)).astype(np.float32)
    img_hw = np.asarray([[64., 64.], [50., 60.]], np.float32)
    ref = jm(jnp.asarray(crops), jnp.asarray(windows), jnp.asarray(rois),
             jnp.asarray(roi_b, jnp.int32), jnp.asarray(roi_g, jnp.int32),
             jnp.asarray(img_hw), out_size)
    got = mask_targets_from_crops(_t(crops), _t(windows), _t(rois),
                                  _t(roi_b), _t(roi_g), _t(img_hw), out_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.mean() < 1


def test_detail_target():
    from dynamask_tpu.core.boundary import detail_target as jd
    from dynamask_torch.core.boundary import detail_target
    rng = np.random.RandomState(6)
    for s in (14, 28, 56, 112):
        m = (rng.uniform(size=(3, s, s)) > 0.6).astype(np.float32)
        fw = np.asarray([0.7, 0.3], np.float32)
        np.testing.assert_array_equal(
            detail_target(_t(m), _t(fw).reshape(1, 2, 1, 1)).numpy(),
            np.asarray(jd(jnp.asarray(m), jnp.asarray(fw))), f'size {s}')


def test_gumbel_softmax_injected_noise():
    """The hard one-hot and the straight-through gradient of the soft
    sample, the same uniforms on both sides."""
    from dynamask_tpu.models.dynamask_head import gumbel_softmax as jg
    from dynamask_torch.models.dynamask_head import gumbel_softmax
    rng = np.random.RandomState(7)
    logits = rng.randn(12, 4).astype(np.float32)
    u = rng.uniform(1e-4, 1 - 1e-4, (12, 4)).astype(np.float32)
    w = rng.randn(12, 4).astype(np.float32)
    ref = jg(None, jnp.asarray(logits), 0.5, True, u=jnp.asarray(u))
    gref = jax.grad(lambda l: jnp.sum(
        jg(None, l, 0.5, True, u=jnp.asarray(u)) * w))(jnp.asarray(logits))
    lt = _t(logits, True)
    got = gumbel_softmax(lt, 0.5, True, u=_t(u))
    _close(got, ref)
    assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}
    _close(torch.autograd.grad((got * _t(w)).sum(), lt)[0], gref)


def _dyna_inputs(seed=8, r=6):
    rng = np.random.RandomState(seed)
    sizes = (14, 28, 56, 112)
    preds = [rng.randn(r, s, s).astype(np.float32) for s in sizes]
    details = [rng.randn(r, s, s).astype(np.float32) for s in sizes]
    targets = [(rng.uniform(size=(r, s, s)) > 0.5).astype(np.float32)
               for s in sizes]
    logits = rng.randn(r, 4).astype(np.float32)
    u = rng.uniform(1e-4, 1 - 1e-4, (r, 4)).astype(np.float32)
    valid = np.asarray([1, 1, 1, 1, 1, 0], bool)[:r]
    return preds, details, targets, logits, u, valid


@pytest.mark.parametrize('all_stage', [False, True],
                         ids=['faithful', 'all_stage'])
def test_dyna_mask_loss_and_routing_gradient(all_stage):
    """``dyna_mask_loss`` and its gradient w.r.t. the stage logits and,
    through the straight-through routing one-hot, the MSM logits: the
    detail losses' normaliser is detached on both sides."""
    from dynamask_tpu.models.dynamask_head import gumbel_softmax as jg
    from dynamask_tpu.models.dynamask_roi_head import dyna_mask_loss as jl
    from dynamask_torch.models.dynamask_head import gumbel_softmax
    from dynamask_torch.models.dynamask_roi_head import dyna_mask_loss
    preds, details, targets, logits, u, valid = _dyna_inputs()
    fw = np.asarray([0.7, 0.3], np.float32)
    inst_w = (0.5, 0.75, 0.75, 1.0) if all_stage else None

    def jfn(p, d, l):
        ml = jg(None, l, 0.5, True, u=jnp.asarray(u))
        return jl([x[..., None] for x in p], [x[..., None] for x in d],
                  [jnp.asarray(t) for t in targets], ml, jnp.asarray(valid),
                  jnp.asarray(fw), stage_instance_loss_weight=inst_w)[
                      'loss_masks']

    jargs = ([jnp.asarray(p) for p in preds],
             [jnp.asarray(d) for d in details], jnp.asarray(logits))
    ref = jfn(*jargs)
    gref = jax.grad(jfn, (0, 1, 2))(*jargs)
    pt = [_t(p, True) for p in preds]
    dt = [_t(d, True) for d in details]
    lt = _t(logits, True)
    ml = gumbel_softmax(lt, 0.5, True, u=_t(u))
    got = dyna_mask_loss([p[:, None] for p in pt], [d[:, None] for d in dt],
                         [_t(t) for t in targets], ml, _t(valid),
                         _t(fw).reshape(1, 2, 1, 1),
                         stage_instance_loss_weight=inst_w)['loss_masks']
    _close(got, ref)
    # the faithful loss reads only the last stage's instance logits
    grads = torch.autograd.grad(got, pt + dt + [lt], allow_unused=True,
                                materialize_grads=True)
    for a, b in zip(grads, list(gref[0]) + list(gref[1]) + [gref[2]]):
        _close(a, b, 'grad')
    assert float(np.abs(np.asarray(gref[2])).max()) > 0


def test_flops_budget_loss():
    from dynamask_tpu.models.dynamask_roi_head import flops_budget_loss as jf
    from dynamask_torch.models.dynamask_roi_head import flops_budget_loss
    rng = np.random.RandomState(9)
    flops = (0.23, 0.62, 1.01, 1.4)
    valid = np.asarray([1, 1, 1, 1, 1, 1, 0, 1], bool)
    for choice in (rng.randint(0, 4, 8), np.full(8, 3), np.zeros(8, int)):
        ml = np.eye(4, dtype=np.float32)[choice]
        ref = jf(jnp.asarray(ml), jnp.asarray(valid), flops, 0.3)
        _close(flops_budget_loss(_t(ml), _t(valid), flops, 0.3), ref)
    assert float(ref) == 0.0


def test_mask_pre_training_mode():
    """The MSM with batch statistics: output, input gradient and the
    running-statistic update (biased variance, flax momentum 0.9)."""
    from test_torch_port_modules import toy_pair
    det, variables, port, _ = toy_pair()
    x = np.random.RandomState(10).randn(6, 56, 56, 32).astype(np.float32)

    def jfn(m, x):
        return m.roi_head.mask_predictor(x, True, 'full')

    def loss(x):
        out, mut = det.apply(variables, x, method=jfn,
                             mutable=['batch_stats'])
        return jnp.sum(out * jnp.arange(4.0)), (out, mut)

    (_, (ref, mut)), gref = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x))
    msm = port.roi_head.mask_predictor.train()
    xt = _t(x.transpose(0, 3, 1, 2), True)
    out = msm(xt, 'full')
    _close(out, ref, rtol=1e-4, atol=1e-5)
    g = torch.autograd.grad((out * torch.arange(4.0)).sum(), xt)[0]
    _close(g.permute(0, 2, 3, 1), gref, rtol=1e-4, atol=1e-6)
    stats = mut['batch_stats']['roi_head']['mask_predictor']
    for bn in ('bn1', 'bn2'):
        mod = getattr(msm, bn)
        _close(mod.running_mean, stats[bn]['mean'], bn, rtol=1e-5, atol=1e-6)
        _close(mod.running_var, stats[bn]['var'], bn, rtol=1e-5, atol=1e-6)
    msm.eval()


def test_optimizer_three_steps_against_optax():
    """Clip at 35 over the trainable leaves, MSM x0.05, weight decay 1e-4,
    momentum 0.9 and the warmup schedule; frozen stem and stage 1 never
    move. Step 0's gradients exceed the clip, the others do not."""
    from dynamask_tpu.engine.optimizer import build_optimizer as jbuild
    from dynamask_tpu.engine.optimizer import step_lr_schedule as jsched
    from dynamask_torch.engine.optimizer import DetectorSGD, step_lr_schedule
    rng = np.random.RandomState(11)
    shapes = {('backbone', 'conv1'): (4, 3), ('backbone', 'layer1_block0'):
              (5,), ('backbone', 'layer2_block0'): (6, 2),
              ('roi_head', 'mask_predictor'): (3, 3),
              ('roi_head', 'bbox_head'): (7,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (30.0 if step == 0 else 1.0)).astype(
        np.float32) for k, s in shapes.items()} for step in range(3)]

    def tree(flat):
        out = {}
        for (a, b), v in flat.items():
            out.setdefault(a, {})[b] = {'w': jnp.asarray(v)}
        return out

    sched_args = (0.02, 10, (8, 11), 0.1, 2, 0.001)
    params = tree(init)
    tx = jbuild(params, 0.02, 0.9, 1e-4, 35.0, jsched(*sched_args),
                frozen_backbone_prefixes=('conv1', 'layer1_'),
                msm_grad_scale=0.05)
    state = tx.init(params)
    model = torch.nn.Module()
    for top in ('backbone', 'roi_head'):
        setattr(model, top, torch.nn.Module())
    for (a, b), v in init.items():
        sub = torch.nn.Module()
        sub.w = torch.nn.Parameter(_t(v.copy()),
                                   requires_grad=b not in ('conv1',
                                                           'layer1_block0'))
        setattr(getattr(model, a), b, sub)
    opt = DetectorSGD(model, 0.02, 0.9, 1e-4, 35.0,
                      step_lr_schedule(*sched_args), msm_grad_scale=0.05)
    for step in range(3):
        upd, state = tx.update(tree(grads[step]), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        opt.zero_grad()
        for (a, b), g in grads[step].items():
            p = getattr(getattr(model, a), b).w
            if p.requires_grad:
                p.grad = _t(g.copy())
        norm = opt.step()
        if step == 0:
            assert float(norm) > 35.0
        for (a, b) in shapes:
            _close(getattr(getattr(model, a), b).w, params[a][b]['w'],
                   f'step {step} {a}.{b}')
    np.testing.assert_array_equal(model.backbone.conv1.w.detach().numpy(),
                                  init[('backbone', 'conv1')])


def test_trainer_modes_and_device_guard(monkeypatch):
    """``init_trainer`` builds the model in training mode with the JAX
    package's rules: the stem and stage 1 frozen (no gradient, left out of
    the optimizer), every backbone BatchNorm on running statistics
    (``norm_eval``), the MSM's BatchNorms on batch statistics, the DCN
    offset convs at zero. Without a GPU it raises unless asked for the
    CPU."""
    from dynamask_torch.apis import init_trainer
    from dynamask_torch.utils import Config
    cfg = Config.fromfile(os.path.join(os.path.dirname(__file__), '..',
                                       'configs/dynamask/coco/'
                                       'r50_dynamask_1x.py'))
    cfg.model.backbone.depth = 18
    cfg.model.neck.in_channels = [64, 128, 256, 512]
    model, opt = init_trainer(cfg, steps_per_epoch=100, device='cpu', seed=0)
    assert model.training
    bb = model.backbone
    frozen = {id(p) for m in (bb.conv1, bb.bn1, bb.layer1)
              for p in m.parameters()}
    assert frozen and all(not p.requires_grad for m in (bb.conv1, bb.layer1)
                          for p in m.parameters())
    assert not frozen & {id(p) for p in opt.params}
    assert len(opt.params) == sum(p.requires_grad
                                  for p in model.parameters())
    bns = [m for m in bb.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and not any(m.training for m in bns)
    msm = model.roi_head.mask_predictor
    assert msm.bn1.training and msm.bn2.training
    offs = [p for k, p in model.named_parameters() if 'conv_offset' in k]
    assert len(offs) == 6 and not any(p.any() for p in offs)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        init_trainer(cfg, steps_per_epoch=100)


def test_train_detector_steps():
    """``train_steps`` takes one optimizer step per host batch on a toy
    trainer: finite losses, no frozen parameter moves, every non-zero
    trainable one does (weight decay alone moves it), the zero DCN offset
    convs stay at zero (their gradient is exactly 0), and the lr steps
    down after the epochs of ``lr_config.step`` counted in
    ``steps_per_epoch`` steps, which has no default."""
    from dynamask_torch.apis import (init_trainer, synthetic_batch,
                                     train_steps)
    from dynamask_torch.utils import Config
    from test_dynamask import dynamask_toy_cfg
    model_cfg, train_cfg, test_cfg = dynamask_toy_cfg()
    lr = 0.02
    cfg = Config(dict(model=model_cfg, train_cfg=train_cfg,
                      test_cfg=test_cfg,
                      optimizer=dict(type='SGD', lr=lr, momentum=0.9,
                                     weight_decay=1e-4),
                      optimizer_config=dict(grad_clip=dict(max_norm=35)),
                      lr_config=dict(warmup_iters=0, step=[1])))
    with pytest.raises(TypeError, match='steps_per_epoch'):
        init_trainer(cfg, device='cpu')
    model, opt = init_trainer(cfg, steps_per_epoch=2, device='cpu', seed=0)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    batches = [synthetic_batch(s, b=1, h=64, w=64, num_gts=2, max_gts=3,
                               crop_size=16, num_classes=8) for s in range(3)]
    logs = train_steps(model, opt, batches,
                          generator=torch.Generator().manual_seed(0))
    assert len(logs) == 3 and opt.steps == 3
    assert all(torch.isfinite(v).all() for log in logs for v in log.values())
    # epoch 0 (steps 0, 1) at the base lr, epoch 1 (step 2) a tenth of it
    assert opt.sgd.param_groups[0]['lr'] == pytest.approx(lr * 0.1)
    for k, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[k])
        if not p.requires_grad or 'conv_offset' in k:
            assert not moved, k
        elif before[k].any():
            assert moved, k
