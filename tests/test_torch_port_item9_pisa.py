"""PISA on the CPU: the PyTorch port (``dynamask_torch/models/pisa.py``,
``ops/nms.py:nms_match``) against the JAX package on the same seeded
inputs and draws, the JAX weights carried across by
``dynamask_torch.engine.convert``; where JAX reaches RoIAlign it runs its
XLA form.

- ``nms_match``: each box's group leader and in-group rank exactly, with
  tied scores and IoUs exactly at the threshold.
- ``isr_p_label_weights`` and ``carl_loss`` (its value and its gradient to
  the scores and deltas) within 1e-6 relative; ``ScoreHLRSampler``: the
  slots exactly, the negatives' weights within 1e-6 relative, the draw
  injected on both sides (JAX's ``jax.random.uniform`` in its module
  patched to the table).
- ``isr_p_dense``: 3bk, the ISR-P cap of 512 positives over the whole
  batch-flat anchor set, shown on both sides by a set of more.
- The PISA config files on the ``meta`` device. The toy detectors are in
  ``tests/test_torch_port_item9_pisa_detectors.py``, PISA-SSD in
  ``tests/test_torch_port_item6_ssd.py``.
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

from test_torch_port_train_modules import random_boxes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_RTOL = 1e-6


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@contextlib.contextmanager
def jax_uniform(module, tables):
    """While active, ``jax.random.uniform`` in the JAX package's ``module``
    returns ``tables[shape[0]]``."""
    saved = module.jax

    class _Proxy(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jax, name)

    proxy = _Proxy('jax')
    proxy.random = types.SimpleNamespace(
        uniform=lambda k, shape, *a, **kw: jnp.asarray(tables[shape[0]]),
        split=jax.random.split, fold_in=jax.random.fold_in,
        PRNGKey=jax.random.PRNGKey)
    module.jax = proxy
    try:
        yield
    finally:
        module.jax = saved


# -- nms_match ----------------------------------------------------------------

def _match_inputs():
    """Boxes in clusters, with tied scores, pairs at IoU exactly 0.5 (not
    over the threshold) and just over, and invalid slots."""
    rng = np.random.RandomState(3)
    boxes = random_boxes(rng, 60, size=96.0)
    boxes = np.concatenate([boxes, boxes[:20] + rng.uniform(-2, 2, (20, 4))
                            .astype(np.float32),
                            np.array([[0, 0, 10, 10], [0, 0, 10, 5],
                                      [0, 0, 10, 5.1], [50, 50, 60, 60],
                                      [50, 50, 60, 60]], np.float32)])
    scores = np.round(rng.uniform(0.05, 1, len(boxes)), 1).astype(np.float32)
    scores[-5:] = [0.9, 0.8, 0.7, 0.6, 0.6]
    valid = rng.uniform(size=len(boxes)) > 0.1
    valid[-5:] = True
    return boxes, scores, valid


def test_nms_match_exact():
    """Leaders and ranks slot for slot against JAX's; a box at IoU 0.5 with
    a kept one stays out of its group, one just over joins it; tied
    scores keep their input order; invalid boxes have no leader."""
    from dynamask_tpu.ops.nms import nms_match as jmatch
    from dynamask_torch.ops.nms import nms_match
    boxes, scores, valid = _match_inputs()
    assert len(np.unique(scores)) < len(scores)
    rl, rr = (np.asarray(a) for a in jmatch(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5))
    gl, gr = nms_match(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(gl.numpy(), rl)
    np.testing.assert_array_equal(gr.numpy(), rr)
    n = len(boxes)
    assert list(rl[n - 5:]) == [n - 5, n - 4, n - 5, n - 2, n - 2]
    assert list(rr[n - 5:]) == [0, 0, 1, 0, 1]
    assert (rl[~valid] == -1).all() and (rr > 0).sum() > 5


# -- ISR-P, CARL, ISR-N -------------------------------------------------------

def _isr_inputs(n=96, c=5, seed=4):
    """Sampled slots: labels (some background), label weights (some 0),
    deltas, RoIs and group ids with ties in the IoUs."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, c + 1, n).astype(np.int32)
    lw = (rng.uniform(size=n) > 0.1).astype(np.float32)
    rois = random_boxes(rng, n, size=96.0)
    tgt = rng.normal(0, 0.5, (n, 4)).astype(np.float32)
    preds = rng.normal(0, 0.5, (n, 4 * c)).astype(np.float32)
    preds[:8] = np.tile(tgt[:8], c)        # IoU 1: tied within their groups
    cls = rng.normal(0, 1, (n, c + 1)).astype(np.float32)
    groups = rng.randint(0, 6, n).astype(np.int32)
    return cls, preds, labels, lw, tgt, rois, groups


@pytest.mark.parametrize('k,bias', [(2.0, 0.0), (1.0, 0.3)])
def test_isr_p_label_weights(k, bias):
    from dynamask_tpu.models.bbox_head import BBoxTargets as JT
    from dynamask_tpu.models.pisa import isr_p_label_weights as jisr
    from dynamask_torch.models.bbox_head import BBoxTargets
    from dynamask_torch.models.pisa import isr_p_label_weights
    cls, preds, labels, lw, tgt, rois, groups = _isr_inputs()
    c = cls.shape[1] - 1
    means, stds = (0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2)
    ref = np.asarray(jax.jit(lambda *a: jisr(
        a[0], a[1], JT(a[2], a[3], a[4], a[3]), a[5], a[6], c, means, stds,
        k=k, bias=bias))(*(jnp.asarray(x) for x in (
            cls, preds, labels, lw, tgt, rois, groups))))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = isr_p_label_weights(t(cls), t(preds), BBoxTargets(
        t(labels).long(), t(lw), t(tgt), t(lw)), t(rois), t(groups).long(),
        c, means, stds, k=k, bias=bias).numpy()
    pos = (labels < c) & (lw > 0)
    assert np.abs(ref[pos] - lw[pos]).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=W_RTOL, atol=1e-7)


@pytest.mark.parametrize('sigmoid', [False, True])
def test_carl_loss_and_gradient(sigmoid):
    from dynamask_tpu.models.pisa import carl_loss as jcarl
    from dynamask_torch.models.pisa import carl_loss
    cls, preds, labels, lw, tgt, _, _ = _isr_inputs(seed=5)
    c = cls.shape[1] - 1
    if sigmoid:
        cls = cls[:, :c].copy()
    pos = lw > 0
    args = dict(k=1.0, bias=0.2, beta=0.11 if sigmoid else 1.0,
                avg_factor=37.0, sigmoid=sigmoid)
    f = lambda a, b: jcarl(a, jnp.asarray(labels), b, jnp.asarray(tgt),  # noqa
                           jnp.asarray(pos), c, **args)
    ref, (g_cls, g_pred) = jax.value_and_grad(f, (0, 1))(jnp.asarray(cls),
                                                         jnp.asarray(preds))
    tc = torch.from_numpy(cls).requires_grad_()
    tp = torch.from_numpy(preds).requires_grad_()
    got = carl_loss(tc, torch.from_numpy(labels).long(), tp,
                    torch.from_numpy(tgt), torch.from_numpy(pos), c, **args)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=W_RTOL)
    assert rel_l2(tc.grad.numpy(), g_cls) < 1e-5
    assert rel_l2(tp.grad.numpy(), g_pred) < 1e-5
    assert np.abs(np.asarray(g_cls)).max() > 0


def _hlr_inputs(seed=6, n=160, c=5):
    """An assignment of ``n`` candidates (GTs in front) and the detector's
    scores and deltas over them, a third of the negatives confident."""
    from dynamask_tpu.core.assigners import MaxIoUAssigner
    rng = np.random.RandomState(seed)
    gts = random_boxes(rng, 4, size=96.0)
    boxes = np.concatenate([gts, random_boxes(rng, n - 4, size=96.0)])
    valid = np.ones(n, bool)
    labels = rng.randint(0, c, 4)
    a = MaxIoUAssigner(0.5, 0.5, 0.5)(jnp.asarray(boxes), jnp.asarray(valid),
                                      jnp.asarray(gts), jnp.ones(4, bool),
                                      jnp.asarray(labels))
    cls = rng.normal(0, 1, (n, c + 1)).astype(np.float32)
    cls[:, c] += rng.uniform(0, 6, n).astype(np.float32)   # the background
    preds = rng.normal(0, 0.3, (n, 4 * c)).astype(np.float32)
    r = rng.uniform(size=n).astype(np.float32)
    return a, boxes, gts, cls, preds, r


@pytest.mark.parametrize('neg_pos_ub', [-1, 3])
def test_score_hlr_sampler(neg_pos_ub):
    """The packed slots exactly (positives by the draw, confident negatives
    by Score-HLR, then low-score ones by the draw) and the negatives'
    weights within 1e-6 relative of JAX's."""
    import dynamask_tpu.models.pisa as jpisa
    from dynamask_torch.core.assigners import AssignResult
    from dynamask_torch.models.pisa import ScoreHLRSampler
    a, boxes, gts, cls, preds, r = _hlr_inputs()
    c = cls.shape[1] - 1
    kw = dict(num=64, pos_fraction=0.25, neg_pos_ub=neg_pos_ub, k=0.5,
              bias=0.0)
    js = jpisa.ScoreHLRSampler(**kw)
    with jax_uniform(jpisa, {len(boxes): r}):
        ref, ref_w = jax.device_get(jax.jit(lambda *x: js(
            jax.random.PRNGKey(0), x[0], x[1], x[2], cls_scores=x[3],
            bbox_preds=x[4], num_classes=c))(
                a, jnp.asarray(boxes), jnp.asarray(gts), jnp.asarray(cls),
                jnp.asarray(preds)))
    pa = AssignResult(*(torch.tensor(np.asarray(x)).long() if i != 1
                        else torch.tensor(np.asarray(x))
                        for i, x in enumerate(a)))
    got, w = ScoreHLRSampler(**kw)(
        pa, torch.from_numpy(boxes), torch.from_numpy(gts),
        torch.from_numpy(r), None, torch.from_numpy(cls),
        torch.from_numpy(preds), c, js.target_means, js.target_stds)
    for f, x, y in zip(got._fields, got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
    np.testing.assert_allclose(w.numpy(), ref_w, rtol=W_RTOL)
    neg = np.asarray(ref.valid) & ~np.asarray(ref.is_pos)
    assert neg.sum() > 8 and np.ptp(ref_w[neg]) > 0.05


def test_isr_p_dense_cap_batch_wide_3bk():
    """3bk: ISR-P over a dense anchor set reweights only the first 512
    positives of the batch-flat order; on 4 images of 200 positives each
    (800, as 20 GTs an image give on an SSD step) the positives past the
    cap keep weight 1 in both packages, where mmdet reweights every one."""
    from dynamask_tpu.models.pisa import isr_p_dense as jdense
    from dynamask_torch.models.pisa import isr_p_dense
    rng = np.random.RandomState(7)
    b, a, c = 4, 400, 5
    m = b * a
    labels = np.where(np.arange(m) % a < 200, rng.randint(0, c, m), c)
    lw = np.ones(m, np.float32)
    cls = rng.normal(0, 1, (m, c + 1)).astype(np.float32)
    reg = rng.normal(0, 0.5, (m, 4)).astype(np.float32)
    tgt = rng.normal(0, 0.5, (m, 4)).astype(np.float32)
    rois = np.tile(random_boxes(rng, a, size=300.0), (b, 1))
    groups = (np.repeat(np.arange(b), a) * 20 +
              rng.randint(0, 20, m)).astype(np.int32)
    args = (c, (0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2))
    ref = np.asarray(jax.jit(lambda *x: jdense(*x, *args))(
        *(jnp.asarray(x) for x in (cls, reg, labels.astype(np.int32), lw, tgt,
                                   rois, groups))))
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    got = isr_p_dense(t(cls), t(reg), t(labels).long(), t(lw), t(tgt),
                      t(rois), t(groups).long(), *args).numpy()
    np.testing.assert_allclose(got, ref, rtol=W_RTOL)
    pos = np.flatnonzero(labels < c)
    assert len(pos) == 800
    assert (ref[pos[512:]] == 1.0).all()
    assert np.abs(ref[pos[:512]] - 1.0).max() > 0.1


PISA_FILES = {'pisa_faster_rcnn_r50_fpn_1x_coco.py': ('FasterRCNN', 2000),
              'pisa_faster_rcnn_x101_32x4d_fpn_1x_coco.py': ('FasterRCNN',
                                                             2000),
              'pisa_mask_rcnn_r50_fpn_1x_coco.py': ('MaskRCNN', 1000),
              'pisa_mask_rcnn_x101_32x4d_fpn_1x_coco.py': ('MaskRCNN', 1000),
              'pisa_retinanet_r50_fpn_1x_coco.py': ('PISARetinaNet', None),
              'pisa_retinanet_x101_32x4d_fpn_1x_coco.py': ('PISARetinaNet',
                                                           None)}


@pytest.mark.parametrize('rel', sorted(PISA_FILES))
def test_pisa_files_build(rel):
    """The PISA files at full width: the RoI head's Score-HLR sampler (k
    0.5, bias 0), ISR (k 2) and CARL (k 1, bias 0.2), SmoothL1 at beta 1;
    2000 proposals an image on PISA Faster R-CNN (its ``rpn_proposal``,
    which the test path takes too, as JAX's), 1000 on PISA Mask R-CNN;
    PISA RetinaNet's CARL at beta 0.11."""
    from dynamask_torch.models import build_detector
    from dynamask_torch.models.pisa import ScoreHLRSampler
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs/pisa', rel))
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           device='meta')
    kind, proposals = PISA_FILES[rel]
    assert type(model).__name__ == kind
    if proposals is None:
        assert model.carl == dict(k=1.0, bias=0.2, beta=0.11)
        assert model.isr == dict(k=2.0, bias=0.0)
        return
    rh = model.roi_head
    assert type(rh).__name__ == 'PISARoIHead'
    assert isinstance(rh.sampler, ScoreHLRSampler)
    assert (rh.sampler.k, rh.sampler.bias, rh.sampler.num) == (0.5, 0., 512)
    assert (rh.isr_k, rh.isr_bias, rh.carl_k, rh.carl_bias) == (2, 0, 1, 0.2)
    assert rh.smooth_l1_beta == 1.0
    assert model.rpn_max_num == proposals
    assert (rh.mask_head is None) == (kind == 'FasterRCNN')
