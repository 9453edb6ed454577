"""Cascade R-CNN and Hybrid Task Cascade on the CPU: the PyTorch port's
modules and detectors against the JAX package's
(``dynamask_tpu/models/cascade_roi_head.py``, ``htc.py``), on the same
seeded inputs, with the JAX weights carried across by
``dynamask_torch.engine.convert``; where JAX reaches RoIAlign it runs its
XLA form.

- Components: ``FusedSemanticHead`` (logits and embedding),
  ``HTCMaskHead`` with and without ``res_feat`` and each return form,
  ``semantic_seg_loss`` with ignored pixels (value and gradient), the
  class-agnostic ``bbox_head_loss``.
- The toy detectors of ``tests/test_cascade.py`` and ``tests/test_htc.py``
  (ResNet-18, 32-channel FPN, 8 classes, 64x64): Cascade Mask R-CNN,
  Cascade R-CNN (box only), HTC with and without its semantic branch,
  and a Faster R-CNN with class-agnostic regression. ``simple_test`` +
  paste slot for slot; one training step's losses and per-parameter
  gradients with every sampler draw injected on both sides (JAX's sampler
  takes one table per candidate count, so each draw of the port gets the
  table of its count: stage 0 G + P, HTC's stage-0 mask resample G + N,
  the later stages N).
- K2 / K4 calls on each toy path, at inference and in training (the
  launch counts ``chip_smoke.py`` phase 12 holds on the card).
- The JAX faults the port reproduces (ROADMAP.md queue 3, 3l-3r), each
  shown.
- The phase-12 config files build from their unchanged files; the entry
  points (test loop, ``train_detector``, ``inference_detector``,
  ``synthetic_batch`` with ``gt_semantic_seg``) on a seeded COCO set.

Tolerances as the other twins: dets ``rtol=1e-5, atol=1e-4``, labels and
validity exact; mask probabilities ``atol=2e-4``; losses 1e-4 relative;
gradients 1e-3 relative L2; modules (fp32 sums in other orders through a
few convs) ``rtol=1e-4, atol=1e-4``; the box loss 1e-6.
"""

import contextlib
import copy
import functools
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

from test_torch_port_modules import fast_jit, randomize_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
MASK_ATOL = 2e-4
PHASE12 = {
    'cascade_mask_rcnn': 'configs/cascade_rcnn/'
                         'cascade_mask_rcnn_r50_fpn_1x_coco.py',
    'cascade_rcnn': 'configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py',
    'htc': 'configs/htc/htc_r50_fpn_1x_coco.py',
    'htc_without_semantic': 'configs/htc/'
                            'htc_without_semantic_r50_fpn_1x_coco.py',
    'htc_x101': 'configs/htc/htc_x101_64x4d_fpn_16x1_20e_coco.py',
}
# the port keys of the cascade leaves the JAX importer (``_mmdet_key``,
# dynamask_tpu/engine/pretrained.py:120-215) has no rule for (3o)
JAX_SKIPPED = re.compile(
    r'^roi_head\.(bbox_head\.\d+|mask_head\.\d+|semantic_head)\.')
# K2 calls of one image and K2 / K4 calls of one step on each toy path
# (``chip_smoke.py`` phase 12's counts)
CALLS = {'cascade_box': (3, 3, 3), 'cascade': (4, 4, 4),
         'htc': (8, 12, 12), 'htc_nosem': (4, 6, 6)}
N_ANCHORS = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
G, P, N = 3, 32, 32          # GTs, RPN proposals, sampled slots (the toy)


def _close(got, ref, atol=ATOL, msg=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4,
                               atol=atol, err_msg=msg)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _load(port, path, params):
    """Load JAX ``params`` of a module at the dotted JAX ``path``."""
    from dynamask_torch.engine import load_jax_variables
    tree = params
    for p in reversed(path):
        tree = {p: tree}
    load_jax_variables(port, {'params': tree})
    return port


def _wrap(**modules):
    from test_torch_port_configs import _wrap as wrap
    return wrap(**modules)


# -- components ---------------------------------------------------------------

def _pyramid(seed=0, c=16, b=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, 32 // 2 ** i, 48 // 2 ** i, c).astype(np.float32)
            for i in range(5)]


@functools.lru_cache(maxsize=None)
def semantic_pair():
    """The JAX ``FusedSemanticHead`` (16 channels, 3 convs, 7 classes,
    fusion level 1), its randomised variables and the port's."""
    from dynamask_tpu.models.htc import FusedSemanticHead as J
    from dynamask_torch.models.htc import FusedSemanticHead
    feats = _pyramid()
    jm = J(num_ins=5, fusion_level=1, num_convs=3, in_channels=16,
           conv_out_channels=16, num_classes=7)
    v = randomize_variables(jm.init(jax.random.PRNGKey(0),
                                    [jnp.asarray(f) for f in feats]))
    port = FusedSemanticHead(5, 1, 3, 16, 16, 7)
    _load(_wrap(**{'roi_head.semantic_head': port}),
          ['roi_head', 'semantic_head'], v['params'])
    return jm, v, port, feats


def test_fused_semantic_head():
    """Logits and embedding at the fusion level's size, every level's
    lateral among them."""
    jm, v, port, feats = semantic_pair()
    ref_logits, ref_emb = jm.apply(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        logits, emb = port([_nchw(f) for f in feats])
    assert logits.shape == (2, 7, 16, 24) and emb.shape == (2, 16, 16, 24)
    _close(logits.permute(0, 2, 3, 1), ref_logits)
    _close(emb.permute(0, 2, 3, 1), ref_emb)
    assert (emb >= 0).all() and emb.std() > 1e-2


@pytest.mark.parametrize('res', [False, True], ids=['stage0', 'flow'])
def test_htc_mask_head(res):
    """Logits and features; with ``res_feat`` through ``conv_res``; each
    return form of the information flow."""
    from dynamask_tpu.models.htc import HTCMaskHead as J
    from dynamask_torch.models.htc import HTCMaskHead
    rng = np.random.RandomState(1)
    x = rng.randn(5, 14, 14, 16).astype(np.float32)
    last = rng.randn(5, 14, 14, 16).astype(np.float32) if res else None
    jm = J(num_convs=2, conv_out_channels=16, num_classes=6,
           with_conv_res=res)
    v = randomize_variables(jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x),
        None if last is None else jnp.asarray(last)))
    port = HTCMaskHead(with_conv_res=res, num_convs=2, in_channels=16,
                       conv_out_channels=16, num_classes=6)
    _load(_wrap(**{'roi_head.mask_head.1': port}), ['roi_head',
                                                    'mask_heads_1'],
          v['params'])
    ja = (jnp.asarray(x), None if last is None else jnp.asarray(last))
    ta = (_nchw(x), None if last is None else _nchw(last))
    ref_logits, ref_feat = jm.apply(v, *ja)
    with torch.no_grad():
        logits, feat = port(*ta)
        only_feat = port(*ta, return_logits=False)
        only_logits = port(*ta, return_feat=False)
    assert logits.shape == (5, 6, 28, 28)
    _close(logits.permute(0, 2, 3, 1), ref_logits)
    _close(feat.permute(0, 2, 3, 1), ref_feat)
    assert torch.equal(only_feat, feat) and torch.equal(only_logits, logits)
    if not res:
        assert not hasattr(port, 'conv_res')
        with pytest.raises(ValueError):
            port(ta[0], ta[0])


def test_semantic_seg_loss_with_ignored_pixels():
    """The pixel CE over the labelled pixels (255 and out-of-range labels
    ignored) times the weight, and its gradient, against JAX's."""
    from dynamask_tpu.models.htc import semantic_seg_loss as jloss
    from dynamask_torch.models.htc import semantic_seg_loss
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 9, 10, 12) * 2).astype(np.float32)
    labels = rng.randint(0, 9, (2, 10, 12))
    labels[rng.uniform(size=labels.shape) < 0.3] = 255
    labels[0, 0, :3] = 11
    nhwc = jnp.asarray(logits.transpose(0, 2, 3, 1))
    ref, ref_g = jax.value_and_grad(
        lambda x: jloss(x, jnp.asarray(labels), 0.2))(nhwc)
    t = torch.from_numpy(logits).requires_grad_(True)
    got = semantic_seg_loss(t, torch.from_numpy(labels), 0.2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    _close(t.grad.permute(0, 2, 3, 1), ref_g, atol=1e-7)
    kept = (labels < 9)
    assert 0 < kept.sum() < labels.size
    assert not t.grad.permute(0, 2, 3, 1).numpy()[~kept].any()


def test_class_agnostic_bbox_head_loss():
    """4 deltas a RoI: CE, L1 and SmoothL1 on the positives' deltas, and
    the accuracy, against JAX's ``reg_class_agnostic=True`` (1e-6)."""
    from dynamask_tpu.models.bbox_head import BBoxTargets as JT
    from dynamask_tpu.models.bbox_head import bbox_head_loss as jloss
    from dynamask_torch.models.bbox_head import BBoxTargets, bbox_head_loss
    rng = np.random.RandomState(0)
    n, c = 64, 8
    logits = rng.randn(n, c + 1).astype(np.float32)
    deltas = (rng.randn(n, 4) * 1.5).astype(np.float32)
    labels = rng.randint(0, c + 1, n).astype(np.int64)
    pos = (labels < c).astype(np.float32)
    tgt = (rng.randn(n, 4) * pos[:, None]).astype(np.float32)
    lw = (rng.uniform(size=n) > 0.1).astype(np.float32)
    jt = JT(jnp.asarray(labels), jnp.asarray(lw), jnp.asarray(tgt),
            jnp.asarray(pos))
    args = (torch.from_numpy(logits), torch.from_numpy(deltas),
            BBoxTargets(*(torch.from_numpy(a) for a in (labels, lw, tgt,
                                                          pos))), c)
    for beta in (None, 1.0):
        ref = jloss(jnp.asarray(logits), jnp.asarray(deltas), jt, c,
                    reg_class_agnostic=True,
                    reg_loss_type='l1' if beta is None else 'smooth_l1',
                    smoothl1_beta=beta or 1.0)
        got = bbox_head_loss(*args, smooth_l1_beta=beta,
                             reg_class_agnostic=True)
        for k in ('loss_cls', 'loss_bbox', 'acc'):
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-6, err_msg=f'{beta} {k}')
    assert float(got['loss_bbox']) > 0


# -- the toy detectors --------------------------------------------------------

def _smooth_l1_stages(model):
    """The stage heads' box loss as the configs name it (SmoothL1, beta 1)."""
    for h in model['roi_head']['bbox_head']:
        h['loss_bbox'] = dict(type='SmoothL1Loss', beta=1.0, loss_weight=1.0)


def toy_cfg(kind):
    """(model, train_cfg, test_cfg) of the toy ``kind``."""
    from test_cascade import cascade_toy_cfg
    from test_htc import htc_toy_cfg
    if kind == 'faster_agnostic':
        from test_torch_port_box_only import box_cfg
        model, train_cfg, test_cfg = box_cfg('faster')
        model['roi_head']['bbox_head']['reg_class_agnostic'] = True
        return model, train_cfg, test_cfg
    if kind.startswith('htc'):
        model, train_cfg, test_cfg = copy.deepcopy(
            htc_toy_cfg(with_semantic=kind == 'htc'))
    else:
        model, train_cfg, test_cfg = copy.deepcopy(cascade_toy_cfg())
    _smooth_l1_stages(model)
    if kind == 'cascade_box':
        rh = model['roi_head']
        rh['mask_head'] = rh['mask_roi_extractor'] = None
    return model, train_cfg, test_cfg


def _demo(b=1, semantic=False):
    from test_models import demo_batch
    batch = {k: np.array(v) for k, v in
             demo_batch(0, b=b, h=64, w=64, g=G, s=16).items()}
    if semantic:      # 11 classes at the fusion level (stride 8), 20% 255
        rng = np.random.RandomState(3)
        seg = rng.randint(0, 11, (b, 8, 8))
        seg[rng.uniform(size=seg.shape) < 0.2] = 255
        batch['gt_semantic_seg'] = seg.astype(np.int64)
    return batch


@functools.lru_cache(maxsize=None)
def cascade_pair(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    det = jax_build(*cfg)
    batch = {k: jnp.asarray(v) for k, v in _demo().items()}
    variables = randomize_variables(
        fast_jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


KINDS = ['cascade', 'cascade_box', 'htc', 'htc_nosem', 'faster_agnostic']
MASKED = {'cascade', 'htc', 'htc_nosem'}


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test_and_paste(kind):
    """Dets, labels, validity, 28x28 mask probabilities and the pasted
    masks slot for slot, two images with a non-unit scale factor, through
    ``inference_detector`` on a batch (``make_test_fn`` + paste; boxes
    only without a mask head)."""
    from dynamask_tpu.apis.test import _paste_epilogue
    from dynamask_torch.apis import inference_detector
    from dynamask_torch.ops.paste import paste_masks
    det, variables, port = cascade_pair(kind)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch_np = {k: _demo(2)[k] for k in keys}
    batch_np['scale_factor'][1:] = 0.8
    ref, ref_epi = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: (lambda o: (o, _paste_epilogue(o, 64, 64, 0.5)
                                 if 'mask_probs' in o else o))(
            det.apply(v, b, method='simple_test')))(
        variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    batch_t = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    got = inference_detector(port, batch_t)
    with torch.no_grad():
        out = port.simple_test(batch_t)
    for i in range(2):
        assert ref['det_valid'][i].sum() >= 4
        scores = ref['dets'][i, ref['det_valid'][i].astype(bool), 4]
        assert np.min(np.abs(np.diff(np.sort(scores)))) > 1e-6, 'ties'
    np.testing.assert_array_equal(got['valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    assert ('masks' in got) == ('mask_probs' in ref) == (kind in MASKED)
    if kind not in MASKED:
        return
    probs = out['mask_probs'].numpy()
    assert probs.shape == (2, 8, 28, 28)
    assert probs.std() > 1e-2          # not saturated: the compare has teeth
    np.testing.assert_allclose(probs, ref['mask_probs'], atol=MASK_ATOL)
    pasted = paste_masks(out['mask_probs'].reshape(16, 28, 28),
                         out['dets'][..., :4].reshape(16, 4), 64,
                         64).numpy().reshape(2, 8, 64, 64)
    clear = np.abs(pasted - 0.5) > 1e-3
    np.testing.assert_array_equal(got['masks'].numpy()[clear],
                                  ref_epi['masks'][clear])


def _tables():
    """One priority table per candidate count: the RPN's anchors, stage
    0's G + P (and HTC's stage-0 mask resample, G + N, the same count
    here), the later stages' N."""
    rng = np.random.RandomState(14)
    return {n: rng.uniform(size=n).astype(np.float32)
            for n in (N_ANCHORS, G + P, N)}


def port_noise(tables):
    """The port's draws: each one the table of its candidate count."""
    noise = {'rpn': tables[N_ANCHORS], 'rcnn': tables[G + P],
             'rcnn_mask_0': tables[G + N]}
    for s in (1, 2):
        noise[f'rcnn_{s}'] = noise[f'rcnn_mask_{s}'] = tables[N]
    return {k: torch.from_numpy(v[None]) for k, v in noise.items()}


@contextlib.contextmanager
def jax_agnostic_loss(kind):
    """JAX's ``StandardRoIHead`` calls ``bbox_head_loss`` without the head's
    ``reg_class_agnostic`` and cannot train such a head (3q): for the
    ``faster_agnostic`` twin's reference, the call gets the flag."""
    import dynamask_tpu.models.roi_head as jrh
    saved = jrh.bbox_head_loss
    if kind == 'faster_agnostic':
        jrh.bbox_head_loss = functools.partial(saved,
                                               reg_class_agnostic=True)
    try:
        yield
    finally:
        jrh.bbox_head_loss = saved


def _port_grads(port):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().numpy().copy() for k, p in port.named_parameters()}


@functools.lru_cache(maxsize=None)
def cascade_step(kind):
    """One training step's logs and gradients on both sides, from the same
    variables and draws; the JAX gradients in the port's layout through
    the port's key map."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = cascade_pair(kind)
    port = copy.deepcopy(port).train()
    batch = _demo(semantic=kind == 'htc')
    tables = _tables()

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax_sampler_priorities(tables), jax_agnostic_loss(kind):
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables['batch_stats'],
            {k: jnp.asarray(x) for k, x in batch.items()})
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()},
        port_noise(tables)))
    total.backward()
    got = _port_grads(port)
    jax_grads = jax.device_get(jax_grads)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k)) for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax.device_get(jax_log).items()},
            got, ref)


def _want_keys(kind):
    keys = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss'}
    if kind == 'faster_agnostic':
        return keys | {'loss_cls', 'loss_bbox', 'acc'}
    for s in range(3):
        keys |= {f's{s}.loss_cls', f's{s}.loss_bbox', f's{s}.acc'}
        if kind.startswith('htc'):
            keys.add(f's{s}.loss_mask')
    if kind == 'cascade':
        keys.add('loss_mask')
    if kind == 'htc':
        keys.add('loss_semantic_seg')
    return keys


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    """Every loss key of the step (each stage's, the mask losses, the
    semantic loss) within 1e-4 of JAX's, the sampler draws injected."""
    port_log, jax_log, _, _ = cascade_step(kind)
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    assert keys == _want_keys(kind)
    assert keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    for k in keys:
        if 'loss_mask' in k or 'loss_bbox' in k:
            assert jax_log[k] > 0, k          # positives in every sample


@pytest.mark.parametrize('kind', KINDS)
def test_per_leaf_gradients(kind):
    """Every parameter within 1e-3 relative L2 of JAX's gradient; a leaf
    JAX leaves without one has none in the port; every stage's box head,
    every mask head, ``conv_res`` and the semantic head get some."""
    _, _, got, ref = cascade_step(kind)
    compared = 0
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        d = rel_l2(got[k], ref[k])
        compared += 1
        assert d < GRAD_RL2, f'{k}: rel-L2 {d:.2e}'
    heads = [k for k in ref if re.match(
        r'^roi_head\.(bbox_head|mask_head|semantic_head)\.', k)]
    assert all(ref[k].any() for k in heads), [k for k in heads
                                              if not ref[k].any()]
    if kind.startswith('htc'):
        assert sum('conv_res' in k for k in heads) == 4
    if kind == 'htc':
        assert sum(k.startswith('roi_head.semantic_head.') for k in heads) \
            == 2 * (5 + 2 + 2)
    assert compared >= (70 if kind == 'faster_agnostic' else 80), compared


# -- K2 / K4 calls on each path -----------------------------------------------

@contextlib.contextmanager
def counted_crops():
    """Counts the crop forwards (K2's entry) and backwards (K4's) that the
    port's RoIAlign runs; on the card each is one kernel launch."""
    import dynamask_torch.ops.roi_align as ra
    counts = {'fwd': 0, 'bwd': 0}
    fwd, bwd = ra.roi_align_fwd, ra.roi_align_bwd

    def cfwd(*a, **k):
        counts['fwd'] += 1
        return fwd(*a, **k)

    def cbwd(*a, **k):
        counts['bwd'] += 1
        return bwd(*a, **k)

    ra.roi_align_fwd, ra.roi_align_bwd = cfwd, cbwd
    try:
        yield counts
    finally:
        ra.roi_align_fwd, ra.roi_align_bwd = fwd, bwd


@pytest.mark.parametrize('kind', sorted(CALLS))
def test_crop_calls_per_path(kind):
    """K2 per image, and K2 / K4 per step: 3 box stages; + 1 mask extract
    (Cascade Mask R-CNN); HTC 3 x (box + semantic) + mask + semantic an
    image and 3 x (box + semantic + mask + semantic) a step; without its
    semantic branch 3 + 1 and 3 x (box + mask)."""
    _, _, port = cascade_pair(kind)
    infer, k2, k4 = CALLS[kind]
    batch = _demo(2, semantic=kind == 'htc')
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


# -- the JAX faults the port reproduces (ROADMAP.md queue 3) ------------------

def test_htc_box_loss_is_l1_3l():
    """3l: the HTC toy names SmoothL1 (beta 1) on its stage heads, as
    ``configs/htc/`` do; JAX's head holds ``reg_loss_type='smooth_l1'``
    but trains L1 (``htc.py:235-237`` passes no loss type). The port's
    step equals JAX's; the same step with SmoothL1 is another number."""
    from dynamask_tpu.models import build_detector as jax_build
    det = jax_build(*toy_cfg('htc'))
    assert det.roi_head.reg_loss_type == 'smooth_l1'
    port_log, jax_log, _, _ = cascade_step('htc')
    _, _, port = cascade_pair('htc')
    assert port.roi_head.smooth_l1_beta is None
    net = copy.deepcopy(port).train()
    net.roi_head.smooth_l1_beta = 1.0
    batch = _demo(semantic=True)
    smooth = net.forward_train({k: torch.from_numpy(v) for k, v in
                                batch.items()}, port_noise(_tables()))
    for s in range(3):
        k = f's{s}.loss_bbox'
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL)
        assert abs(float(smooth[k].detach()) - jax_log[k]) > \
            1e-3 * jax_log[k], k


def test_cascade_one_mask_head_3m():
    """3m: JAX's Cascade Mask R-CNN builds one ``FCNMaskHead`` from the
    config's ``mask_head`` dict and trains it at weight 1 on the last
    stage's sample (one ``loss_mask``); mmdet would repeat it per stage
    (``roi_head.mask_head.{i}``). The port builds the same one head."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_tpu.models.fcn_mask_head import FCNMaskHead as JF
    from dynamask_torch.apis import init_detector
    from dynamask_torch.models.fcn_mask_head import FCNMaskHead
    from dynamask_torch.utils.config import Config
    path = os.path.join(ROOT, PHASE12['cascade_mask_rcnn'])
    d = Config.fromfile(path).to_dict()
    jdet = jax_build(d['model'], d['train_cfg'], d['test_cfg'])
    assert isinstance(jdet.roi_head.mask_head, JF)
    port = init_detector(path, device='meta')
    assert isinstance(port.roi_head.mask_head, FCNMaskHead)
    assert not any(re.match(r'^roi_head\.mask_head\.\d', k)
                   for k in port.state_dict())
    port_log, jax_log, _, _ = cascade_step('cascade')
    assert [k for k in jax_log if 'mask' in k] == ['loss_mask']
    np.testing.assert_allclose(port_log['loss_mask'], jax_log['loss_mask'],
                               rtol=LOSS_RTOL)


def _record_draws(step):
    """The candidate count of each sampler draw of ``step()`` in order, on
    the JAX side (its sampler's ``jax.random.uniform``) and on the port's
    (``RandomSampler``)."""
    import dynamask_torch.core.samplers as ts
    counts = []
    saved = ts.RandomSampler.__call__

    def call(self, assign, boxes, *a, **k):
        counts.append(int(boxes.shape[0]))
        return saved(self, assign, boxes, *a, **k)

    ts.RandomSampler.__call__ = call
    try:
        step()
    finally:
        ts.RandomSampler.__call__ = saved
    return counts


@pytest.mark.parametrize('kind', ['cascade', 'htc'])
def test_only_stage_0_adds_gts_3n(kind):
    """3n: every stage's sampler in the configs says
    ``add_gt_as_proposals=True``, JAX adds the GTs at stage 0 only: the
    draws' candidate counts, in order, are the RPN's anchors, stage 0's
    G + P, then N for each later stage (HTC: each stage's mask resample
    beside it, G + N at stage 0), on both sides."""
    det, variables, port = cascade_pair(kind)
    batch = _demo(semantic=kind == 'htc')
    jax_counts = []

    class Proxy:
        def __getattr__(self, name):
            return getattr(jax, name)

    import dynamask_tpu.core.samplers as js
    proxy = Proxy()
    tables = _tables()

    def uniform(key, shape, *a, **k):
        jax_counts.append(shape[0])
        return jnp.asarray(tables[shape[0]])

    import types
    proxy.random = types.SimpleNamespace(uniform=uniform)
    saved = js.jax
    js.jax = proxy
    try:
        jax.eval_shape(lambda v, b: det.apply(
            v, b, method='forward_train',
            rngs={'sampling': jax.random.PRNGKey(0)},
            mutable=['batch_stats']), variables,
            {k: jnp.asarray(x) for k, x in batch.items()})
    finally:
        js.jax = saved
    port_counts = _record_draws(lambda: copy.deepcopy(port).train()
                                .forward_train(
                                    {k: torch.from_numpy(x)
                                     for k, x in batch.items()},
                                    port_noise(tables)))
    want = ([G + P, G + N, N, N, N, N] if kind == 'htc'
            else [G + P, N, N])
    assert jax_counts == port_counts == [N_ANCHORS] + want
    cfg = toy_cfg(kind)[1]['rcnn']
    assert all(s['sampler']['add_gt_as_proposals'] for s in cfg)


def test_jax_importer_skips_the_stage_heads_3o():
    """3o: given an HTC state dict in mmdet's names (here the port's), the
    JAX importer has no rule for ``roi_head.bbox_head.{i}.*``,
    ``roi_head.mask_head.{i}.*`` (``conv_res`` among them) or
    ``roi_head.semantic_head.*``, reports them skipped and leaves those
    leaves at their init; the port's loader takes every key."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    from dynamask_torch.engine.convert import mmdet_key
    det, variables, port = cascade_pair('htc')
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    init = jax.tree_util.tree_map(np.zeros_like, variables['params'])
    params, _, report = convert_torch_weights(
        sd, init, jax.tree_util.tree_map(np.zeros_like,
                                         variables['batch_stats']),
        scope='mmdet')
    skipped = sorted(k for k in report['skipped']
                     if not k.endswith('num_batches_tracked'))
    assert skipped == sorted(k for k in sd if JAX_SKIPPED.match(k))
    assert sum('conv_res' in k for k in skipped) == 4
    assert len(skipped) == 3 * 8 + 3 * 8 + 2 * 2 + 2 * (5 + 2 + 2)
    for k in skipped:
        path, leaf, _ = mmdet_key(k)
        node = params
        for p in path:
            node = node[p]
        assert not np.any(node['kernel' if leaf == 'weight' else 'bias']), k
        assert np.any(sd[k]), k


def test_no_loader_gives_gt_semantic_seg_3p(tmp_path):
    """3p: JAX's ``LoadAnnotations`` has no ``with_seg`` and the HTC
    configs' train pipeline loads no stuff map, so a loader batch has no
    ``gt_semantic_seg`` on either side and HTC trains without
    ``loss_semantic_seg``; given one (``synthetic_batch``), the port's
    step computes it."""
    import inspect
    from test_torch_port_eval_slice import make_set
    from dynamask_tpu.data.transforms import LoadAnnotations
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.apis import synthetic_batch
    from dynamask_torch.data import build_dataset
    from dynamask_torch.utils.config import Config
    assert 'with_seg' not in inspect.signature(LoadAnnotations).parameters
    cfg = Config.fromfile(os.path.join(ROOT, PHASE12['htc']))
    ann, img_dir = make_set(tmp_path)[:2]
    train = dict(cfg.data.train, ann_file=ann, img_prefix=img_dir,
                 data_root=None)
    for load in train['pipeline']:
        assert not load.get('with_seg'), load
    args = dict(max_gts=8, mask_crop_size=32)
    port_sample = build_dataset(dict(train), default_args=args)[0]
    jax_sample = jax_build(dict(train), args)[0]
    assert 'gt_boxes' in port_sample and 'gt_boxes' in jax_sample
    assert 'gt_semantic_seg' not in port_sample
    assert 'gt_semantic_seg' not in jax_sample
    _, _, port = cascade_pair('htc')
    batch = {k: torch.from_numpy(v) for k, v in _demo().items()}
    net = copy.deepcopy(port).train()
    gen = torch.Generator().manual_seed(0)
    assert 'loss_semantic_seg' not in net.forward_train(batch, generator=gen)
    sem = synthetic_batch(0, b=1, h=64, w=64, num_gts=3, num_classes=8,
                          semantic_seg=(8, 11))['gt_semantic_seg']
    batch['gt_semantic_seg'] = sem
    assert 'loss_semantic_seg' in net.forward_train(batch, generator=gen)


def test_jax_standard_head_cannot_train_agnostic_3q():
    """3q: JAX's ``StandardRoIHead.forward_train`` calls ``bbox_head_loss``
    without the head's ``reg_class_agnostic``, so a Faster R-CNN with
    class-agnostic regression fails to trace (its (N, 4) deltas reshaped
    to (N, classes, 4)); the port trains it as mmdet does, and its losses
    equal JAX's with the flag passed (``test_train_losses``)."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    det, variables, _ = cascade_pair('faster_agnostic')
    batch = {k: jnp.asarray(x) for k, x in _demo().items()}
    with pytest.raises(TypeError, match='reshape'):
        jax.eval_shape(lambda v, b: jparse(det.apply(
            v, b, method='forward_train',
            rngs={'sampling': jax.random.PRNGKey(0)},
            mutable=['batch_stats'])[0]), variables, batch)
    port_log, jax_log, _, _ = cascade_step('faster_agnostic')
    assert port_log['loss_bbox'] > 0
    np.testing.assert_allclose(port_log['loss_bbox'], jax_log['loss_bbox'],
                               rtol=LOSS_RTOL)


def test_semantic_laterals_and_box_crop_3r():
    """3r: JAX's ``FusedSemanticHead`` resizes each lateral after its conv
    and ReLU where mmdet resizes the level first (ReLU does not commute
    with the resize), and its box branch crops the embedding at 7²
    directly where mmdet crops at 14² and average-pools. The port computes
    JAX's form; mmdet's is another function of the same weights."""
    import torch.nn.functional as F
    from dynamask_torch.core.boundary import interpolate_bilinear
    from dynamask_torch.ops.roi_align import simple_roi_align
    jm, v, port, feats = semantic_pair()
    ref_logits, _ = jm.apply(v, [jnp.asarray(f) for f in feats])
    x = [_nchw(f) for f in feats]
    with torch.no_grad():
        got, emb = port(x)
        fh, fw = x[1].shape[-2:]
        mm = F.relu(port.lateral_convs[1](x[1]))
        for i in (0, 2, 3, 4):
            mm = mm + F.relu(port.lateral_convs[i](interpolate_bilinear(
                x[i], fh, fw, align_corners=True)))
        for conv in port.convs:
            mm = F.relu(conv(mm))
        mm = port.conv_logits(mm)
    _close(got.permute(0, 2, 3, 1), ref_logits)
    assert rel_l2(mm.numpy(), got.numpy()) > 1e-2
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 100, (12, 2))
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(40, 90, (12, 2))], 1).astype(np.float32))
    rb = torch.from_numpy(rng.randint(0, 2, 12))
    nhwc = emb.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        direct = simple_roi_align(nhwc, rois, rb, 7, 1 / 8)
        pooled = F.adaptive_avg_pool2d(simple_roi_align(
            nhwc, rois, rb, 14, 1 / 8).permute(0, 3, 1, 2), 7)
    assert rel_l2(pooled.permute(0, 2, 3, 1).numpy(), direct.numpy()) > 1e-3


# -- the config files and the entry points ------------------------------------

@pytest.mark.parametrize('name', sorted(PHASE12))
def test_phase12_config_builds(name):
    """The config file, unchanged, builds (``meta``): the two-stage
    detector over the cascade head the JAX builder reads from it (stage
    IoU thresholds, stds, loss weights, class-agnostic stages, HTC's mask
    heads, semantic branch and L1 box loss); every state-dict key maps
    through the port's key map, and the JAX importer skips exactly the
    stage heads' and the semantic head's (3o)."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.apis import init_detector
    from dynamask_torch.engine.convert import mmdet_key
    from dynamask_torch.models.cascade_roi_head import CascadeRoIHead
    from dynamask_torch.models.htc import (HTCMaskHead,
                                           HybridTaskCascadeRoIHead)
    model = init_detector(os.path.join(ROOT, PHASE12[name]), device='meta')
    rh = model.roi_head
    htc = name.startswith('htc')
    assert type(model).__name__ == ('FasterRCNN' if name == 'cascade_rcnn'
                                    else 'MaskRCNN')
    assert isinstance(rh, HybridTaskCascadeRoIHead if htc
                      else CascadeRoIHead)
    assert rh.num_stages == 3 and rh.stage_loss_weights == (1, 0.5, 0.25)
    assert [a.pos_iou_thr for a in rh.stage_assigners] == [0.5, 0.6, 0.7]
    assert all(a.neg_iou_thr == a.min_pos_iou == a.pos_iou_thr and
               not a.match_low_quality for a in rh.stage_assigners)
    assert rh.stage_target_stds[2] == (0.033, 0.033, 0.067, 0.067)
    assert all(h.reg_class_agnostic for h in rh.bbox_head)
    assert rh.smooth_l1_beta == (None if htc else 1.0)
    assert rh.sampler.num == 512 and rh.max_pos == 128
    assert rh.num_classes == len(model.CLASSES) == 80
    if htc:
        assert all(isinstance(m, HTCMaskHead) for m in rh.mask_head)
        assert [m.with_conv_res for m in rh.mask_head] == [False, True, True]
        assert rh.mask_size == 28
        assert (rh.semantic_head is None) == (name == 'htc_without_semantic')
        if rh.semantic_head is not None:
            assert rh.semantic_out_stride == 8
            assert rh.semantic_head.num_classes == 183
            assert rh.semantic_loss_weight == 0.2
    else:
        assert (rh.mask_head is None) == (name == 'cascade_rcnn')
    if name == 'htc_x101':
        assert model.backbone.layer3[22].conv2.groups == 64
    keys = [k for k in model.state_dict()
            if not k.endswith('num_batches_tracked')]
    for k in keys:
        assert mmdet_key(k) is not None, k
        ref = _mmdet_key(k)
        assert (ref is None) == bool(JAX_SKIPPED.match(k)), k
        if ref is not None:
            assert (ref[0], ref[1]) == mmdet_key(k)[:2], k


@pytest.mark.parametrize('rel,what', [
    ('legacy_1.x/cascade_mask_rcnn_r50_fpn_1x_coco_v1.py', '3c'),
    ('dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py', None)])
def test_cascade_configs_refused(rel, what):
    """The legacy v1 cascade is refused (3c); the DeformRoIPool file, once
    refused naming item 9, builds its deform pool extractor."""
    from dynamask_torch.apis import init_detector
    path = os.path.join(ROOT, 'configs', rel)
    if what is None:
        ext = init_detector(path, device='meta').roi_head.bbox_roi_extractor
        assert type(ext).__name__ == 'DeformRoIPoolPack'
        return
    with pytest.raises(NotImplementedError, match=what):
        init_detector(path, device='meta')


@pytest.mark.parametrize('change,what', [
    (dict(mask_info_flow=False), 'mask_info_flow'),
    (dict(interleaved=False), 'interleaved'),
    (dict(semantic_fusion=('bbox',)), 'semantic_fusion'),
    (dict(semantic_head=dict(fusion_level=2)), 'fusion level'),
    (dict(mask_head=dict(type='FCNMaskHead')), 'mask head FCNMaskHead'),
    (dict(semantic_head=dict(ignore_label=254)), 'ignore_label')])
def test_htc_keys_refused_not_dropped(change, what):
    """A key that changes the model and that the port lacks is refused."""
    from dynamask_torch.apis import init_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, PHASE12['htc']))
    rh = cfg.model['roi_head']
    for k, v in change.items():
        if k == 'mask_head':
            rh[k] = [dict(m, **v) for m in rh[k]]
        elif isinstance(v, dict):
            rh[k] = dict(rh[k], **v)
        else:
            rh[k] = v
    with pytest.raises(NotImplementedError, match=what):
        init_detector(cfg, device='meta')


def test_synthetic_batch_semantic_seg():
    """``gt_semantic_seg`` at 1/stride of the canvas, labels in
    [0, classes) and ``ignore`` (255), seeded; nothing else changes."""
    from dynamask_torch.apis import synthetic_batch
    a = synthetic_batch(3, b=2, h=64, w=96, num_gts=4,
                        semantic_seg=(8, 183))
    b = synthetic_batch(3, b=2, h=64, w=96, num_gts=4)
    seg = a.pop('gt_semantic_seg')
    assert seg.shape == (2, 8, 12) and seg.dtype == torch.int64
    vals = set(seg.unique().tolist())
    assert 255 in vals and len(vals) > 20 and max(vals - {255}) < 183
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(seg, synthetic_batch(3, b=2, h=64, w=96, num_gts=4,
                                            semantic_seg=(8, 183))
                       ['gt_semantic_seg'])


@pytest.fixture(scope='module')
def coco_set(tmp_path_factory):
    from test_torch_port_eval_slice import make_set
    return make_set(tmp_path_factory.mktemp('coco_cascade'))


@pytest.mark.parametrize('kind', ['htc', 'cascade'])
def test_single_device_test_equal(coco_set, kind):
    """The mask toys through both test loops (the JAX loop pastes
    always, so it takes no box-only model), image by image: dets, labels,
    validity and the masks outside the threshold band; the metrics."""
    from test_torch_port_eval_slice import TEST_PIPELINE, data_cfg
    from dynamask_tpu.apis.test import single_device_test as jax_test
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.apis import dataset_mask_canvas, single_device_test
    from dynamask_torch.data import build_dataset
    from dynamask_torch.ops.paste import paste_masks
    det, variables, port = cascade_pair(kind)
    cfg = data_cfg(*coco_set, TEST_PIPELINE)
    jds = jax_build(cfg, dict(test_mode=True))
    pds = build_dataset(cfg, dict(test_mode=True))
    ref = jax_test(det, variables, jds, progress=False)
    got = single_device_test(port, pds, workers_per_gpu=0, progress=False)
    ch, cw = dataset_mask_canvas(pds)
    assert [r['img_id'] for r in got] == [r['img_id'] for r in ref]
    ids = [pds.sample_id(k) for k in range(len(pds))]
    for r, g in zip(ref, got):
        assert r['valid'].sum() >= 4
        np.testing.assert_array_equal(g['valid'], r['valid'])
        np.testing.assert_array_equal(g['labels'], r['labels'])
        np.testing.assert_allclose(g['dets'], r['dets'], rtol=1e-5,
                                   atol=1e-4)
        s = pds[ids.index(g['img_id'])]
        with torch.no_grad():
            out = port.simple_test({k: torch.from_numpy(s[k])[None] for k in
                                    ('image', 'img_shape', 'ori_shape',
                                     'scale_factor')})
        oh, ow = s['ori_shape'].astype(int)
        probs = paste_masks(out['mask_probs'][0], out['dets'][0, :, :4], ch,
                            cw)[:, :oh, :ow].numpy()
        for d in range(len(r['masks'])):
            clear = np.abs(probs[d] - 0.5) > 1e-3
            np.testing.assert_array_equal(g['masks'][d][clear],
                                          r['masks'][d][clear])
    metric = ['bbox', 'segm']
    want = jds.evaluate(ref, metric=metric)
    have = pds.evaluate(got, metric=metric)
    for k in have:
        assert have[k] == pytest.approx(want[k], abs=1e-6, rel=0), k


def _toy_run_cfg(coco_set, kind):
    from test_torch_port_eval_slice import (TEST_PIPELINE, TRAIN_PIPELINE,
                                            data_cfg)
    from dynamask_torch.utils import Config
    model, train_cfg, test_cfg = toy_cfg(kind)
    metric = ['bbox', 'segm'] if kind in MASKED else ['bbox']
    return Config(dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        optimizer=dict(type='SGD', lr=0.002, momentum=0.9,
                       weight_decay=1e-4),
        optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=5,
                       warmup_ratio=0.001, step=[8, 11]),
        total_epochs=1, log_config=dict(interval=1),
        evaluation=dict(interval=1, metric=metric),
        data=dict(samples_per_gpu=2, workers_per_gpu=0, max_gts=8,
                  mask_crop_size=32,
                  train=data_cfg(*coco_set, TRAIN_PIPELINE),
                  val=data_cfg(*coco_set, TEST_PIPELINE),
                  test=data_cfg(*coco_set, TEST_PIPELINE))))


@pytest.mark.parametrize('kind', ['htc', 'cascade_box'])
def test_train_and_eval_entry_points(coco_set, kind, tmp_path):
    """``train_detector`` for one step with validation, the checkpoint
    through ``init_detector`` (every key), ``inference_detector`` on an
    image file (boxes alone for Cascade R-CNN) and ``run_eval``, on the
    CPU."""
    from dynamask_torch.apis import inference_detector, init_detector, \
        run_eval, train_detector
    from test_torch_port_train_loop import rows
    cfg = _toy_run_cfg(coco_set, kind)
    work = str(tmp_path / 'work')
    train_detector(cfg, work_dir=work, max_steps_per_epoch=1, device='cpu')
    train = [r for r in rows(work) if r['mode'] == 'train']
    val = [r for r in rows(work) if r['mode'] == 'val']
    assert len(train) == 1 and len(val) == 1
    assert {'s0.loss_cls', 's2.loss_bbox'} <= set(train[0])
    assert ('s2.loss_mask' in train[0]) == (kind == 'htc')
    assert 'loss_semantic_seg' not in train[0]           # 3p
    assert np.isfinite(val[0]['bbox_mAP'])
    model = init_detector(cfg, checkpoint=work, device='cpu')
    saved = torch.load(os.path.join(work, 'epoch_1.pth'),
                       weights_only=True)['state_dict']
    assert saved.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    img = os.path.join(coco_set[1], '0000.jpg')
    result = inference_detector(model, img)
    bbox = result[0] if kind == 'htc' else result
    assert len(bbox) == 8 and sum(len(b) for b in bbox) > 0
    if kind == 'htc':
        assert sum(len(s) for s in result[1]) == sum(len(b) for b in bbox)
    metrics = run_eval(cfg, work, metrics=tuple(cfg.evaluation['metric']),
                       device='cpu')
    assert np.isfinite(metrics['bbox_mAP'])
