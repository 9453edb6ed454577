"""The two-stage family's ops and losses on the CPU: the PyTorch port's
against the JAX package's (``dynamask_tpu/ops/roi_align.py``
``generic_roi_align``, ``ops/nms.py`` ``soft_nms`` / ``multiclass_nms``,
``ops/carafe.py`` ``carafe``, ``models/losses.py`` ``iou_loss`` /
``bounded_iou_loss``, ``models/bbox_head.py`` ``bbox_head_loss`` with
``reg_decoded_bbox``, JAX's ``OHEMSampler`` against the port's draw), on
the same seeded numpy inputs; where JAX reaches RoIAlign it runs its XLA
form.
Then the K2 / K4 calls on each path of ``chip_smoke.py`` phase 13, on the
toys of ``tests/test_torch_port_two_stage_twins.py`` and on the GRoIE,
GIoU, Soft-NMS and OHEM Faster R-CNNs.

Tolerances: crops and CARAFE (fp32 sums of a few terms in other orders)
``rtol=1e-5, atol=1e-5``, their gradients 1e-5 relative L2; Soft-NMS
slot for slot, scores ``rtol=1e-6``, indices and validity exact; the
losses 1e-6 relative and their gradients ``atol=1e-7``; OHEM's draw
exact.
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

from test_torch_port_train_modules import (_assign_inputs,  # noqa: E402
                                           jax_sampler_priorities)
from test_torch_port_cascade import _demo, counted_crops  # noqa: E402
from test_torch_port_train_slice import rel_l2  # noqa: E402
from test_torch_port_two_stage_twins import toy_cfg  # noqa: E402

STRIDES = (4, 8, 16, 32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pyramid(seed=0, b=2, c=6):
    """NHWC levels of a 64x80 image at strides 4-32."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, 64 // s, 80 // s, c).astype(np.float32)
            for s in STRIDES]


def _rois(seed=1, n=13, b=2):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-6, 60, (n, 2))
    wh = rng.uniform(3, 70, (n, 2))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return rois, rng.randint(0, b, n).astype(np.int32)


# -- GRoIE's all-level RoIAlign -----------------------------------------------

@pytest.mark.parametrize('aggregation', ['sum', 'concat'])
def test_generic_roi_align_and_gradient(aggregation):
    """Every RoI from every level, summed or concatenated, and the
    gradient of the features through K4's plain version, against JAX's
    ``generic_roi_align`` and ``jax.grad``; the crops are one flat crop of
    L*N rows."""
    from dynamask_tpu.ops.roi_align import generic_roi_align as jgen
    import dynamask_torch.ops.roi_align as ra
    feats = _pyramid()
    rois, rb = _rois()
    p = 7
    w = np.random.RandomState(3).randn(
        13, p, p, 6 * (4 if aggregation == 'concat' else 1)).astype(
            np.float32)

    def jloss(fs):
        out = jgen(fs, jnp.asarray(rois), jnp.asarray(rb), p, STRIDES,
                   sampling_ratio=2, aggregation=aggregation)
        return jnp.sum(out * w), out
    (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(f) for f in feats])
    tf = [_t(f).requires_grad_(True) for f in feats]
    calls = []
    fwd = ra.roi_align_fwd
    ra.roi_align_fwd = lambda *a, **k: calls.append(a[1].shape[0]) or fwd(
        *a, **k)
    try:
        got = ra.generic_roi_align(tf, _t(rois), _t(rb).long(), p, STRIDES,
                                   sampling_ratio=2, aggregation=aggregation)
    finally:
        ra.roi_align_fwd = fwd
    assert calls == [4 * 13]
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(ref)).max() > 0.1
    for lvl, (a, b) in enumerate(zip(tf, ref_g)):
        assert rel_l2(a.grad.numpy(), np.asarray(b)) < 1e-5, lvl
    if aggregation == 'sum':       # no level routing: each level adds
        one = ra.multilevel_roi_align([_t(f) for f in feats], _t(rois),
                                      _t(rb).long(), p, STRIDES)
        assert rel_l2(got.detach().numpy(), one.numpy()) > 0.1


def test_generic_roi_align_refuses_other_aggregations():
    from dynamask_torch.ops.roi_align import generic_roi_align
    rois, rb = _rois()
    with pytest.raises(NotImplementedError, match='aggregation'):
        generic_roi_align([_t(f) for f in _pyramid()], _t(rois),
                          _t(rb).long(), 7, STRIDES, aggregation='max')


# -- Soft-NMS -----------------------------------------------------------------

def _dets(seed=4, n=300):
    """Clustered boxes with distinct scores."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(20, 200, (12, 2))
    c = centres[rng.randint(0, 12, n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.permutation(n).astype(np.float32) / n * 0.9 + 0.05
    valid = rng.uniform(size=n) > 0.05
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize('method', ['linear', 'gaussian'])
def test_soft_nms_matches_jax(method):
    """``max_out`` selections slot for slot: boxes, decayed scores,
    indices into the input and validity, with a candidate cut
    (``pre_top_k`` < n) and pool exhaustion in the gaussian case's low
    ``min_score``."""
    from dynamask_tpu.ops.nms import soft_nms as jsoft
    from dynamask_torch.ops.nms import soft_nms
    boxes, scores, valid = _dets()
    kw = dict(iou_threshold=0.3, sigma=0.5, min_score=1e-3, method=method,
              max_out=60, pre_top_k=256)
    ref = jax.device_get(jsoft(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(valid), **kw))
    got = soft_nms(_t(boxes), _t(scores), _t(valid), **kw)
    np.testing.assert_array_equal(got[3].numpy(), ref[3])
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-6)
    assert ref[3].sum() >= 40
    # decayed, not removed: some kept score is below its input score
    kept = ref[2][ref[3]]
    assert (ref[1][ref[3]] < scores[kept] - 1e-4).any()


def test_multiclass_soft_nms_matches_jax():
    """``multiclass_nms(nms_type='soft_nms')``: per-class (N, C*4) boxes,
    the score threshold, the class-offset trick; dets, labels and validity
    slot for slot; greedy NMS gives other dets."""
    from dynamask_tpu.ops.nms import multiclass_nms as jmc
    from dynamask_torch.ops.nms import multiclass_nms
    rng = np.random.RandomState(5)
    n, c = 200, 3
    base, _, _ = _dets(6, n)
    boxes = (base[:, None, :] + rng.normal(0, 3, (n, c, 4))).reshape(n, -1)
    scores = rng.dirichlet(np.ones(c + 1), n)[:, :c] * 1.5
    scores = (scores + rng.uniform(0, 1e-3, scores.shape)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    kw = dict(score_thr=0.05, iou_threshold=0.3, max_per_img=50,
              nms_type='soft_nms', sigma=0.5, min_score=1e-3)
    ref = jax.device_get(jmc(jnp.asarray(boxes.astype(np.float32)),
                             jnp.asarray(scores), valid=jnp.asarray(valid),
                             **kw))
    got = multiclass_nms(_t(boxes.astype(np.float32)), _t(scores),
                         valid=_t(valid), **{k: v for k, v in kw.items()
                                             if k != 'score_thr'},
                         score_thr=0.05)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-6, atol=1e-5)
    assert ref[2].sum() == 50
    greedy = multiclass_nms(_t(boxes.astype(np.float32)), _t(scores), 0.05,
                            0.3, 50, valid=_t(valid))
    assert not torch.equal(greedy[0], got[0])
    with pytest.raises(NotImplementedError, match='nms_type'):
        multiclass_nms(_t(boxes.astype(np.float32)), _t(scores), 0.05, 0.5,
                       50, nms_type='matrix_nms')


# -- CARAFE -------------------------------------------------------------------

def test_carafe_and_gradient():
    """The reassembly at 2x of a 5x7 map with 5x5 kernels, and the
    gradients of the features and the kernels, against JAX's ``carafe``
    (NHWC) and ``jax.grad``."""
    from dynamask_tpu.ops.carafe import carafe as jcarafe
    from dynamask_torch.ops.carafe import carafe
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    logits = rng.randn(2, 10, 14, 25).astype(np.float32)
    masks = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    w = rng.randn(2, 10, 14, 6).astype(np.float32)

    def jloss(xx, mm):
        out = jcarafe(xx, mm, scale=2, up_kernel=5)
        return jnp.sum(out * w), out
    (_, ref), (gx, gm) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(masks.astype(np.float32)))
    tx = _t(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    tm = _t(masks.transpose(0, 3, 1, 2).astype(np.float32).copy()
            ).requires_grad_(True)
    got = carafe(tx, tm, 2, 5)
    (got * _t(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert rel_l2(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx)) < 1e-5
    assert rel_l2(tm.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gm)) < 1e-5


# -- the decoded box losses ---------------------------------------------------

def _boxes(rng, n, lo=8.0, hi=40.0):
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize('kind', ['iou', 'log_iou', 'giou', 'bounded_iou'])
def test_iou_losses_and_gradient(kind):
    """Each IoU-family loss with its weights and ``avg_factor``, and its
    gradient in the predictions, against JAX's (1e-6; the gradient
    ``atol=1e-7``); the bounded loss takes the target as a constant."""
    from dynamask_tpu.models import losses as jl
    from dynamask_torch.models import losses as tl
    rng = np.random.RandomState(8)
    target = _boxes(rng, 40)
    pred = (target + rng.normal(0, 4, target.shape)).astype(np.float32)
    pred[:3] = target[:3] + 50.0            # no overlap: GIoU's enclosure
    w = (rng.uniform(size=40) > 0.3).astype(np.float32)
    if kind == 'bounded_iou':
        jf = lambda p: jl.bounded_iou_loss(p, jnp.asarray(target),  # noqa
                                           weight=jnp.asarray(w)[:, None],
                                           avg_factor=37.0)
        tf = lambda p: tl.bounded_iou_loss(p, _t(target),  # noqa: E731
                                           weight=_t(w)[:, None],
                                           avg_factor=37.0)
    else:
        jf = lambda p: jl.iou_loss(p, jnp.asarray(target), mode=kind,  # noqa
                                   weight=jnp.asarray(w), avg_factor=37.0)
        tf = lambda p: tl.iou_loss(p, _t(target), mode=kind,  # noqa: E731
                                   weight=_t(w), avg_factor=37.0)
    ref, ref_g = jax.jit(jax.value_and_grad(jf))(jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    got = tf(tp)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-7)
    assert float(ref) > 0.05


@pytest.mark.parametrize('loss', ['iou', 'giou', 'bounded_iou', 'l1'])
def test_bbox_head_loss_on_decoded_boxes(loss):
    """``bbox_head_loss`` with ``reg_decoded_bbox``: each positive RoI's
    class deltas decoded on its RoI, then the named loss against the GT
    box (L1 on the decoded boxes too), its value and its gradient in the
    deltas against JAX's; the targets from ``bbox_targets_from_sample``
    are the GT boxes themselves."""
    from dynamask_tpu.models.bbox_head import BBoxTargets as JT
    from dynamask_tpu.models.bbox_head import bbox_head_loss as jloss
    from dynamask_torch.core.samplers import SamplingResult
    from dynamask_torch.models.bbox_head import (BBoxTargets,
                                                 bbox_head_loss,
                                                 bbox_targets_from_sample)
    rng = np.random.RandomState(9)
    n, c = 48, 5
    rois = _boxes(rng, n)
    labels = rng.randint(0, c + 1, n).astype(np.int64)
    pos = labels < c
    gts = (rois + rng.normal(0, 5, rois.shape)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    sample = SamplingResult(torch.arange(n), _t(pos), _t(valid), _t(rois),
                            torch.zeros(n, dtype=torch.long),
                            _t(np.where(pos, labels, -1)), _t(gts * pos[:, None]))
    targets = bbox_targets_from_sample(sample, c, (0.,) * 4,
                                       (0.1, 0.1, 0.2, 0.2), True)
    np.testing.assert_array_equal(
        targets.bbox_targets.numpy(), gts * (pos & valid)[:, None])
    logits = rng.randn(n, c + 1).astype(np.float32)
    deltas = (rng.randn(n, 4 * c) * 0.5).astype(np.float32)
    jt = JT(*(jnp.asarray(t.numpy()) for t in targets))
    stds = (0.1, 0.1, 0.2, 0.2)
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda d: jloss(jnp.asarray(logits), d, jt, c, reg_loss_type=loss,
                        reg_decoded_bbox=True, rois=jnp.asarray(rois),
                        target_stds=stds, loss_bbox_weight=10.0)[
                            'loss_bbox']))(jnp.asarray(deltas))
    td = _t(deltas).requires_grad_(True)
    got = bbox_head_loss(_t(logits), td, BBoxTargets(*targets), c,
                         loss_bbox_weight=10.0,
                         reg_loss_type=None if loss == 'l1' else loss,
                         reg_decoded_bbox=True, rois=_t(rois),
                         target_stds=stds)
    got['loss_bbox'].backward()
    np.testing.assert_allclose(float(got['loss_bbox'].detach()), float(ref),
                               rtol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-7)
    assert float(ref) > 0


# -- OHEM ---------------------------------------------------------------------

def test_ohem_draws_as_random_given_the_same_priorities():
    """3s: the JAX ``OHEMSampler`` called as its RoI head calls it (no
    ``cand_losses``) draws exactly what ``RandomSampler`` draws from the
    same priorities, and so does the port's ``RandomSampler``, which the
    builder gives the OHEM config: slot for slot."""
    from dynamask_tpu.core.assigners import MaxIoUAssigner as JA
    from dynamask_tpu.core.samplers import OHEMSampler as JO
    from dynamask_tpu.core.samplers import RandomSampler as JS
    from dynamask_torch.core.assigners import MaxIoUAssigner
    from dynamask_torch.core.samplers import RandomSampler
    boxes, bv, gts, gv, labels = _assign_inputs(seed=3, n=200)
    ja = jax.jit(JA(0.5, 0.5, 0.5).__call__)(
        jnp.asarray(boxes), jnp.asarray(bv), jnp.asarray(gts),
        jnp.asarray(gv), jnp.asarray(labels, jnp.int32))
    pri = np.random.RandomState(4).uniform(size=200).astype(np.float32)
    with jax_sampler_priorities({200: pri}):
        ref, rand = jax.jit(lambda b, g: (
            JO(num=64, pos_fraction=0.25)(jax.random.PRNGKey(0), ja, b, g),
            JS(64, 0.25)(jax.random.PRNGKey(0), ja, b, g)))(
                jnp.asarray(boxes), jnp.asarray(gts))
    ta = MaxIoUAssigner(0.5, 0.5, 0.5)(_t(boxes), _t(bv), _t(gts), _t(gv),
                                       _t(labels))
    got = RandomSampler(64, 0.25)(ta, _t(boxes), _t(gts), priorities=_t(pri))
    for name, a, b, r in zip(ref._fields, got, ref, rand):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        np.testing.assert_array_equal(np.asarray(r), np.asarray(b), name)
    assert 0 < int(got.is_pos.sum()) <= 16


# -- K2 / K4 calls on each path -----------------------------------------------

# K2 calls of an image and K2 / K4 calls of a step (chip_smoke.py phase 13)
CALLS = {'gn': (2, 2, 2), 'groie': (2, 2, 2), 'dh': (1, 1, 1),
         'groie_faster': (1, 1, 1), 'giou': (1, 1, 1), 'soft_nms': (1, 1, 1),
         'ohem': (1, 1, 1)}


@pytest.mark.parametrize('kind', sorted(CALLS))
def test_crop_calls_per_path(kind):
    """K2 per image, K2 / K4 per step: box + mask extract on the Mask
    R-CNNs (GRoIE's all-level extracts one call each, 4 levels x N rows),
    one box extract on the Faster R-CNNs (Double-Head's takes its two
    crops in one call of 2N rows)."""
    from dynamask_torch.models import build_detector
    port = build_detector(*toy_cfg(kind), device='cpu')
    infer, k2, k4 = CALLS[kind]
    batch = _demo(2)
    with counted_crops() as counts, torch.no_grad():
        port.simple_test({k: torch.from_numpy(batch[k][:1]) for k in
                          ('image', 'img_shape', 'scale_factor')})
    assert counts == {'fwd': infer, 'bwd': 0}
    net = copy.deepcopy(port).train()
    with counted_crops() as counts:
        losses = net.forward_train(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            generator=torch.Generator().manual_seed(0))
        sum(v for k, v in losses.items() if 'loss' in k).backward()
    assert counts == {'fwd': k2, 'bwd': k4}
