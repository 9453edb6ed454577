"""bf16 mixed precision on the CPU, the port against the JAX package in bf16:
the policy (``dynamask_torch.core.fp16`` against ``dynamask_tpu.core.fp16``),
the bf16 plain versions of K1-K4 (the windowed DCN forward and its VJP,
single-level and multilevel RoIAlign and its autodiff), the inference slice
through ``apis.make_test_fn(..., bf16=True)`` against JAX's
``make_test_fn(bf16=True)`` in both modes, and the training step with
``compute_dtype=torch.bfloat16`` against JAX's ``make_train_step(
compute_dtype=jnp.bfloat16)``, at the toy DynaMask of
``test_torch_port_slice.py`` (ResNet-18, 32-channel FPN, 8 classes, 64x64).

The two sides round to bf16 in other places: JAX rounds the DCN's tent
weights and running window sums, RoIAlign's bilinear weights and sums, and
XLA's transpose of RoIAlign sums its scatter in bf16; the port computes each
kernel's result in fp32 from the bf16 inputs and rounds it once. Every bf16
comparison is therefore relative to the largest reference value, with the
tolerance stated beside it, several bf16 ulps (2^-8 = 3.9e-3 relative)
where one rounded sum meets another.

Through a network the two roundings part the features by ~1e-2 relative
(each side is as far from its own fp32 run), and that flips near-tie
discrete decisions: the RPN's top-k and NMS, the box head's NMS, the MSM's
argmax. The slice twins therefore hold the continuous stages against each
other (FPN levels, RPN maps, the box head on JAX's proposals) and inject
JAX's discrete decisions into the port where a comparison has to be slot
for slot: the dets (the test swaps ``roi_head.bbox_head_get_dets`` for the
call), the MSM routing (the routing head ``MaskPre.forward(mode='head')``
swapped for one whose argmax is JAX's decision), and in training the
proposals (``detectors.rpn_get_proposals``), the sampler
priorities and the Gumbel uniforms. The port's own routing decisions are
held apart from JAX's. The port code is not changed for any of it.
"""

import contextlib
import copy
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import _toy_variables, toy_pair  # noqa: E402

G, WINDOW = 2, 3
BF16_ULP = 2.0 ** -8
# K1 + GEMM against JAX's windowed form, relative to max|ref|: JAX sums the
# 2 x 9 window taps of each sample in bf16 and the port rounds the sample
# once; the 9 * C products then sum in fp32 on both sides
DCN_RTOL = 4 * BF16_ULP
# the VJP: JAX keeps d_col in fp32 where the port rounds it to bf16 before
# K3 (its matmul output); d_offset sums C such products, and the offsets'
# gates are the same on both sides
DCN_GRAD_RTOL = 4 * BF16_ULP
# RoIAlign: JAX rounds the weights and sums four bf16 products per sample
# and the bin mean in bf16; the port rounds the bin once
ROI_RTOL = 4 * BF16_ULP
# its gradient: XLA's transpose scatters in bf16 (each feature gradient a
# bf16 sum over every sample of every bin that touches it), 9 ulps off the
# fp32 gradient of the same bf16 inputs at the multilevel case here, where
# the port, which sums in fp32 and rounds once, is within one
ROI_GRAD_RTOL = 16 * BF16_ULP


def _bf16(a):
    """An fp32 numpy array rounded to bf16, as (jax, torch) arrays with the
    same bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel_err(got, ref):
    got, ref = _f32(got), _f32(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


# -- the policy ---------------------------------------------------------------

def test_cast_floating_matches_jax():
    """``cast_floating`` / ``to_bf16`` / ``to_f32`` on one tree of fp32, int
    and bool leaves: floating leaves cast (bf16 values bit for bit as JAX
    rounds them), the others left alone; back to fp32 the same."""
    from dynamask_tpu.core import fp16 as jfp
    from dynamask_torch.core import fp16 as tfp
    rng = np.random.RandomState(0)
    tree = {'w': rng.randn(3, 4).astype(np.float32) * 300,
            'i': np.arange(5, dtype=np.int32),
            'b': np.asarray([True, False]),
            'nested': [rng.randn(7).astype(np.float32), 2.5]}
    jt = jfp.to_bf16(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, tree))
    tt = tfp.to_bf16(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
        tree))
    for key in ('w', 'i', 'b'):
        assert str(tt[key].dtype).split('.')[-1] == str(jt[key].dtype), key
    assert tt['w'].dtype == torch.bfloat16
    assert tt['i'].dtype == torch.int32 and tt['b'].dtype == torch.bool
    np.testing.assert_array_equal(_f32(tt['w']), _f32(jt['w']))
    np.testing.assert_array_equal(_f32(tt['nested'][0]),
                                  _f32(jt['nested'][0]))
    assert tt['nested'][1] == 2.5 and jt['nested'][1] == 2.5
    back = tfp.to_f32(tt)
    assert back['w'].dtype == torch.float32
    np.testing.assert_array_equal(back['w'].numpy(),
                                  np.asarray(jfp.to_f32(jt)['w']))


def test_to_bf16_model_leaf_by_leaf():
    """``to_bf16`` of the port model against ``to_bf16`` of the JAX
    variables, leaf by leaf through the weight importer: parameters and
    BatchNorm statistics bf16 with JAX's bits; the BatchNorms' int
    counters left alone; the model given still fp32."""
    from dynamask_tpu.core.fp16 import to_bf16 as jto
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    from dynamask_torch.core.fp16 import to_bf16
    _, variables, port, _ = toy_pair()
    p16 = to_bf16(port)
    assert all(t.dtype == torch.float32 for t in port.state_dict().values()
               if t.is_floating_point())
    sd = p16.state_dict()
    assert {t.dtype for t in sd.values()} == {torch.bfloat16, torch.int64}
    assert all(t.dtype == torch.int64 for k, t in sd.items()
               if k.endswith('num_batches_tracked'))
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats, report = convert_torch_weights(
        {k: _f32(t) if t.is_floating_point() else t.numpy()
         for k, t in sd.items()}, zeros['params'], zeros['batch_stats'],
        scope='mmdet')
    assert not report['mismatched'], report['mismatched']
    ref = jto(variables)
    got = {'params': params, 'batch_stats': stats}
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) > 100
    for path, leaf in leaves:
        assert leaf.dtype == jnp.bfloat16, path
        np.testing.assert_array_equal(_f32(leaf), np.asarray(_get(got, path)),
                                      err_msg=jax.tree_util.keystr(path))


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize('train', [False, True])
def test_batchnorm_mixed_types_match_flax(train):
    """The BatchNorms under the training step's types, against flax's
    ``nn.BatchNorm`` with the same: a bf16 input, scale and bias cast to
    bf16, running statistics fp32. Frozen (``norm_eval``, running
    statistics: ``layers.BatchNorm2d`` widens scale and bias, which
    torch's ``batch_norm`` otherwise refuses) and in training mode (the
    MSM's ``BatchNorm2dBiasedVar``: batch statistics in fp32, the biased
    variance into the running one): the output bf16 within one bf16 ulp
    of flax's (both normalise in fp32 and round once), the updated
    statistics fp32 within fp32 rounding."""
    import flax.linen as fnn
    from dynamask_torch.models.dynamask_head import BatchNorm2dBiasedVar
    from dynamask_torch.models.layers import BatchNorm2d
    rng = np.random.RandomState(3)
    c = 16
    x = rng.randn(4, 6, 6, c).astype(np.float32) * 2 + 0.5
    scale, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(
        np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = rng.uniform(0.5, 2, c).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = (_bf16(a) for a in (x, scale, bias))
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5)
    ref, state = bn.apply(
        {'params': {'scale': js, 'bias': jb},
         'batch_stats': {'mean': jnp.asarray(mean),
                         'var': jnp.asarray(var)}},
        jx, mutable=['batch_stats'])
    m = (BatchNorm2dBiasedVar if train else BatchNorm2d)(c, eps=1e-5)
    with torch.no_grad():
        m.running_mean.copy_(torch.from_numpy(mean))
        m.running_var.copy_(torch.from_numpy(var))
    m.train(train)
    from torch.func import functional_call
    got = functional_call(m, {'weight': ts, 'bias': tb},
                          (tx.permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _rel_err(got, ref) <= BF16_ULP
    for name, buf in (('mean', m.running_mean), ('var', m.running_var)):
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.numpy(), np.asarray(
            state['batch_stats'][name]), rtol=1e-6, atol=1e-6)


# -- K1-K4 in bf16 ------------------------------------------------------------

def _offsets(case, rng, n, s):
    """(n, s, s, 2*G*9) offsets as ``test_torch_port_train_ops._offsets``:
    ``random`` up to ±5 px, ``zero`` (every DCN's init), ``edge``
    displacements on and around ±window and on integers."""
    shape = (n, s, s, G, 9, 2)
    if case == 'random':
        return rng.uniform(-5, 5, shape).astype(np.float32).reshape(
            n, s, s, -1)
    if case == 'zero':
        return np.zeros((n, s, s, 2 * G * 9), np.float32)
    base = np.stack(np.meshgrid(np.arange(3) - 1.0, np.arange(3) - 1.0,
                                indexing='ij'), -1).reshape(9, 2)
    rel = rng.choice(np.asarray([-3.0, 3.0, -2.75, 2.75, -3.25, 3.25, 0.0,
                                 1.0, -2.0, 0.5], np.float32), shape)
    return (rel - base[None, None, None, None]).astype(np.float32).reshape(
        n, s, s, -1)


@pytest.mark.parametrize('case', ['random', 'zero', 'edge'])
def test_dcn_bf16_matches_jax(case):
    """The windowed DCN in bf16 (K1's plain version + the bf16 GEMM; the
    VJP through K3's plain version) against ``deform_conv2d_windowed`` on
    bf16 inputs and its analytic VJP: output, d_x, d_offset and d_w in
    bf16, each within its tolerance of max|ref|; d_offset exactly 0 where
    JAX's is (zero offsets: the reference's zero-offset fault, kept in
    bf16)."""
    from dynamask_tpu.ops.deform_conv import deform_conv2d_windowed
    from dynamask_torch.ops.deform_conv import deform_conv2d
    rng = np.random.RandomState(7)
    n, s, c, c_out = 2, 14, 32, 24
    (jx, tx), (jo, to), (jw, tw), (jc, tc) = (
        _bf16(a) for a in (rng.randn(n, s, s, c).astype(np.float32),
                           _offsets(case, rng, n, s),
                           (rng.randn(3, 3, c, c_out) * 0.1).astype(
                               np.float32),
                           rng.randn(n, s, s, c_out).astype(np.float32)))
    ref, vjp = jax.vjp(lambda x, o, w: deform_conv2d_windowed(
        x, o, w, 3, 1, 1, 1, G, WINDOW), jx, jo, jw)
    ref_grads = vjp(jc)
    args = [t.clone().requires_grad_() for t in (tx, to, tw)]
    out = deform_conv2d(*args, 3, 1, 1, 1, G, WINDOW)
    grads = torch.autograd.grad(out, args, tc)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert _rel_err(out, ref) <= DCN_RTOL
    for what, g, r in zip(('d_x', 'd_offset', 'd_w'), grads, ref_grads):
        assert r.dtype == jnp.bfloat16
        if case == 'zero' and what == 'd_offset':
            assert not _f32(r).any() and not _f32(g).any()
            continue
        assert _rel_err(g, r) <= DCN_GRAD_RTOL, what
    if case == 'edge':
        np.testing.assert_array_equal(_f32(grads[1]) == 0,
                                      _f32(ref_grads[1]) == 0)


ROIS = np.asarray([[16.3, 16.1, 80.2, 90.7], [8.4, 8.2, 140.6, 150.3],
                   [4.1, 4.3, 250.2, 255.9], [0.2, 0.6, 380.5, 250.1],
                   [-20.3, -10.7, 30.2, 44.1], [40.5, 40.5, 40.5, 40.5],
                   [0.3, 10.2, 380.4, 30.6], [350.1, 230.4, 420.8, 270.2]],
                  np.float32)
BATCH = np.asarray([0, 1, 0, 1, 0, 1, 0, 1], np.int64)
STRIDES = (4, 8, 16, 32)


@pytest.mark.parametrize('form,ratio', [('single', 1), ('multilevel', 2)])
def test_roi_align_bf16_matches_jax(form, ratio):
    """RoIAlign on bf16 features (K2's plain version; the feature gradient
    through K4's) against JAX's ``roi_align`` / ``multilevel_roi_align``
    on the same bf16 features and ``jax.vjp`` of them: crops and feature
    gradients bf16, each within its tolerance of max|ref|."""
    jra = importlib.import_module('dynamask_tpu.ops.roi_align')
    ra = importlib.import_module('dynamask_torch.ops.roi_align')
    rng = np.random.RandomState(ratio)
    c = 16
    levels = [_bf16(rng.randn(2, 64 >> i, 96 >> i, c).astype(np.float32))
              for i in range(4 if form == 'multilevel' else 1)]
    jf, tf = [j for j, _ in levels], [t.requires_grad_() for _, t in levels]
    p = 7 if form == 'multilevel' else 14
    jc, tc = _bf16(rng.randn(len(ROIS), p, p, c).astype(np.float32))
    rb = jnp.asarray(BATCH.astype(np.int32))
    rois_t, rb_t = torch.from_numpy(ROIS), torch.from_numpy(BATCH)
    if form == 'single':
        def fn(f):
            return jra.roi_align(f[0], jnp.asarray(ROIS), rb, p, 0.25,
                                 sampling_ratio=ratio)
        out = ra.roi_align(tf[0], rois_t, rb_t, p, 0.25,
                           sampling_ratio=ratio)
    else:
        def fn(f):
            return jra.multilevel_roi_align(f, jnp.asarray(ROIS), rb, p,
                                            STRIDES, sampling_ratio=ratio)
        out = ra.multilevel_roi_align(tf, rois_t, rb_t, p, STRIDES,
                                      sampling_ratio=ratio)
    ref, vjp = jax.vjp(fn, jf)
    ref_grads, = vjp(jc)
    # the fp32 gradient of the same bf16 inputs: the port rounds it once
    _, vjp32 = jax.vjp(fn, [f.astype(jnp.float32) for f in jf])
    exact, = vjp32(jc.astype(jnp.float32))
    grads = torch.autograd.grad(out, tf, tc)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _rel_err(out, ref) <= ROI_RTOL
    for i, (g, r, e) in enumerate(zip(grads, ref_grads, exact)):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        assert _rel_err(g, r) <= ROI_GRAD_RTOL, f'level {i}'
        assert _rel_err(g, e) <= BF16_ULP, f'level {i}'


# -- the inference slice ------------------------------------------------------

CANVAS = (64, 64)
# continuous stages, port bf16 against JAX bf16, relative L2: each side's
# bf16 features lie ~1e-2 from its own fp32 run (8e-3 the port's, 1.2e-2
# JAX's at P2), and the two roundings are independent
STAGE_RL2 = 4e-2
# the mask probabilities on JAX's dets and routing: logits through the
# 14 -> 112 cascade in bf16 on each side, a sigmoid slope <= 1/4, so most
# pixels agree to ~1e-2 (PROB_ATOL); the boundary-aware fusion thresholds
# the coarser stage's sigmoid at 0.5 and, where that flips within bf16
# noise, takes another stage's logit, so a few pixels part by up to the
# whole range: the mean difference at most PROB_MEAN_ATOL, at most
# FLIP_SHARE of the pixels off by more than PROB_ATOL (~1.3% here)
PROB_ATOL = 5e-2
PROB_MEAN_ATOL = 2e-2
FLIP_SHARE = 5e-2
# the pasted masks agree on this share of the pixels where JAX's pasted
# probability is MASK_MARGIN clear of 0.5 (the rest: the fusion's flips)
MASK_MARGIN = 0.1
MASK_AGREE = 0.99


def _rel_l2(got, ref):
    got, ref = _f32(got).astype(np.float64), _f32(ref).astype(np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-12))


def _batch(b=1):
    from test_models import demo_batch
    demo = demo_batch(0, b=b, h=64, w=64, g=3, s=16)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    return {k: np.array(demo[k]) for k in keys}


@contextlib.contextmanager
def injected_dets(ref):
    """While active, the port's box head hands over JAX's dets, labels and
    valid flags (``ref``, (B, D, ...) numpy), image after image."""
    import dynamask_torch.models.roi_head as trh
    saved, b = trh.bbox_head_get_dets, ref['dets'].shape[0]
    calls = iter(range(10 ** 6))

    def take(*args, **kwargs):
        i = next(calls) % b
        return tuple(torch.from_numpy(np.array(ref[k][i]))
                     for k in ('dets', 'labels', 'valid'))
    trh.bbox_head_get_dets = take
    try:
        yield
    finally:
        trh.bbox_head_get_dets = saved


@contextlib.contextmanager
def injected_routing(need):
    """While active, the MSM's routing head (every ``MaskPre``, the bf16
    copies ``make_test_fn`` makes included) scores JAX's decision ``need``
    (B * D,) 1 and every other choice 0, so the port's argmax takes JAX's
    routing slot for slot."""
    from dynamask_torch.models.dynamask_head import MaskPre
    saved = MaskPre.forward

    def forward(self, x, mode='full'):
        out = saved(self, x, mode)
        if mode != 'head':
            return out
        return torch.nn.functional.one_hot(
            torch.from_numpy(need.astype(np.int64)).to(out.device),
            out.shape[-1]).to(out.dtype)
    MaskPre.forward = forward
    try:
        yield
    finally:
        MaskPre.forward = saved


def _jax_stages(det, variables, image):
    """JAX in bf16 up to the box head: FPN levels, RPN maps, the test
    proposals and the box head's logits and deltas on them."""
    from dynamask_tpu.core.fp16 import to_bf16
    from dynamask_tpu.models.rpn_head import rpn_get_proposals

    def stages(m, batch):
        feats = m.extract_feat(batch['image'], train=False)
        cls, reg = m.rpn_head(feats, train=False)
        anchors = m._anchor_generator().grid_anchors(
            [tuple(f.shape[1:3]) for f in feats])
        props = rpn_get_proposals(
            cls, reg, anchors, batch['img_shape'],
            nms_pre=m.rpn_nms_pre_test, max_num=m.rpn_max_num,
            nms_thr=m.rpn_nms_thr, target_means=m.rpn_target_means,
            target_stds=m.rpn_target_stds)
        rh = m.roi_head
        b, p = props.boxes.shape[:2]
        rois = props.boxes.reshape(b * p, 4)
        rb = jnp.repeat(jnp.arange(b, dtype=jnp.int32), p)
        logits, deltas = rh.bbox_head(rh._extract(feats, rois, rb,
                                                  rh.bbox_roi_out),
                                      train=False)
        return feats, cls, reg, rois, rb, logits, deltas

    batch = {'image': jnp.asarray(image).astype(jnp.bfloat16),
             'img_shape': jnp.asarray([[64., 64.]] * image.shape[0])}
    return jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method=stages))(to_bf16(variables), batch))


def test_bf16_stages_match_jax():
    """The continuous stages in bf16 on one image: the five FPN levels, the
    RPN's objectness and delta maps, and the box head's class logits and
    deltas on JAX's own proposals, each within STAGE_RL2 of JAX's."""
    from dynamask_torch.core.fp16 import to_bf16
    det, variables, port, _ = toy_pair()
    image = _batch()['image']
    feats, cls, reg, rois, rb, logits, deltas = _jax_stages(det, variables,
                                                            image)
    p16 = to_bf16(port)
    with torch.no_grad():
        tfeats = p16.extract_feat(p16.images(
            {'image': torch.from_numpy(image).bfloat16()}))
        tcls, treg = p16.rpn_head(tfeats)
        tlog, tdel = p16.roi_head._bbox_forward(
            tfeats, torch.from_numpy(np.array(rois)),
            torch.from_numpy(np.array(rb)).long())
    nhwc = (lambda t: t.permute(0, 2, 3, 1))
    pairs = ([(nhwc(a), b) for a, b in zip(tfeats, feats)] +
             [(nhwc(a), b) for a, b in zip(tcls, cls)] +
             [(nhwc(a), b) for a, b in zip(treg, reg)] +
             [(tlog, logits), (tdel, deltas)])
    for i, (got, ref) in enumerate(pairs):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, i
        assert _rel_l2(got, ref) <= STAGE_RL2, i


@pytest.mark.parametrize('dynamic', [False, True])
def test_make_test_fn_bf16_matches_jax(dynamic):
    """The slice through ``make_test_fn(..., bf16=True)`` on both sides, in
    each mode at the flagship's shipped capacities (1.0, 1.0, 0.01): with
    JAX's dets injected (and in the dynamic mode JAX's routing), the port's
    mask probabilities within PROB_ATOL of JAX's ``simple_test`` in bf16
    and its pasted masks equal to JAX's ``make_test_fn`` masks wherever
    JAX's pasted probability is MASK_MARGIN clear of 0.5; the dets are fp32
    (decoded in fp32 on both sides). The port's own routing is held apart:
    with JAX's dets, its argmax agrees with JAX's on most slots. The fp32
    model given to ``make_test_fn`` is left as it was."""
    from dynamask_tpu.apis.test import make_test_fn as jmake
    from dynamask_tpu.core.fp16 import to_bf16 as jto
    from dynamask_tpu.ops.paste import paste_masks as jpaste
    from dynamask_torch.apis import make_test_fn
    from dynamask_torch.core.fp16 import to_bf16
    det, variables, port, _ = toy_pair(dynamic=dynamic,
                                       capacity=(1.0, 1.0, 0.01))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax.device_get(jmake(det, variables, CANVAS, 0.5, bf16=True)(jb))
    assert ref['dets'].dtype == np.float32 and ref['valid'].sum() >= 4
    out, state = jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test', mutable=['intermediates']))(
            jto(variables), dict(jb, image=jb['image'].astype(jnp.bfloat16)))
    out, state = jax.device_get((out, state))
    np.testing.assert_array_equal(out['dets'], ref['dets'])
    d = ref['dets'].shape[1]
    ref_pasted = np.asarray(jpaste(out['mask_probs'].reshape(-1, 112, 112),
                                   out['dets'][..., :4].reshape(-1, 4),
                                   *CANVAS).astype(jnp.float32))

    need = None
    if dynamic:
        need = np.asarray(
            state['intermediates']['roi_head']['msm_routing'][0]['need'])
    routed = (injected_routing(need) if dynamic
              else contextlib.nullcontext())
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    fn = make_test_fn(port, CANVAS, 0.5, bf16=True)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with injected_dets(ref):
        own = fn(bt).get('msm_routing', {})
        with routed:
            got = fn(bt)
            probs = to_bf16(port).simple_test(
                dict(bt, image=bt['image'].bfloat16()))['mask_probs']
    assert got['dets'].dtype == torch.float32
    np.testing.assert_array_equal(got['dets'].numpy(), ref['dets'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    assert probs.dtype == torch.bfloat16
    diff = np.abs(_f32(probs) - _f32(out['mask_probs']))
    assert diff.mean() <= PROB_MEAN_ATOL
    assert (diff > PROB_ATOL).mean() <= FLIP_SHARE
    clear = np.abs(ref_pasted - 0.5) > MASK_MARGIN
    masks = got['masks'].numpy().reshape(ref_pasted.shape)
    jax_masks = ref['masks'].reshape(ref_pasted.shape)
    assert clear.mean() > 0.5
    assert (masks[clear] == jax_masks[clear]).mean() >= MASK_AGREE
    assert bool(own) == dynamic      # the routing statistics, if routed
    if dynamic:
        agree = (own['need'].numpy() == need).mean()
        assert agree >= 0.75, (own['need'], need)
        np.testing.assert_array_equal(got['msm_routing']['need'].numpy(),
                                      need)      # the injection held
        assert got['masks'].shape == (1, d) + CANVAS


# -- the training step --------------------------------------------------------

LR = 0.01
# the port's bf16 step against its fp32 step, on the small Mask R-CNN of
# tests/test_sharded.py with the JAX package's own bf16 rule there
# (tests/test_bf16_train.py): the loss within 5%, the update in the same
# region (the bf16 step's distance from the fp32 step's at most half the
# fp32 step's length: 0.25 in squares). The DynaMask toy is not held to it:
# its mask loss weighs each stage's detail loss by the MSM's Gumbel argmax
# and divides by the routed count, and a routing flip moves it by more
# (JAX's own bf16 step there is 18% off its fp32 step on the same draws)
LOSS_RTOL_FP32 = 0.05
UPDATE_RATIO = 0.25
# the port's bf16 step against JAX's on the DynaMask toy, on JAX's
# proposals and the same draws, each loss: the box and mask logits differ
# by ~1e-2 between the two roundings (STAGE_RL2); the mask loss, through
# the routing-weighted detail losses, by the most (1.7% here)
LOSS_RTOL_JAX = 0.05


def _captured_tiny_cfg():
    """The (model, train_cfg, test_cfg) of ``test_sharded._tiny_detector``,
    captured from its call to ``build_detector``."""
    import dynamask_tpu.models as jm
    from test_sharded import _tiny_detector
    saved = jm.build_detector
    jm.build_detector = lambda *cfg: cfg
    try:
        return _tiny_detector()
    finally:
        jm.build_detector = saved


def test_bf16_step_against_fp32():
    """The port's bf16 step against its fp32 step, as the JAX package holds
    its own (``tests/test_bf16_train.py``, the same detector, batch and
    init): fp32 masters, gradients and BatchNorm statistics after it, a
    finite loss within LOSS_RTOL_FP32 of the fp32 step's, the update in the
    same region."""
    from test_sharded import _batch
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import (DetectorSGD, load_jax_variables,
                                       make_train_step)
    from dynamask_torch.engine import step_lr_schedule as tsched
    from dynamask_torch.models import build_detector
    cfg = _captured_tiny_cfg()
    batch = _batch(2)
    variables = jax.jit(jax_build(*cfg).init)(
        {'params': jax.random.PRNGKey(0)}, batch)
    base = build_detector(*cfg, device='cpu')
    load_jax_variables(base, variables)
    base.train()
    bt = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    nets, logs = {}, {}
    for name, dtype in (('fp32', None), ('bf16', torch.bfloat16)):
        net = copy.deepcopy(base)
        opt = DetectorSGD(net, LR, 0.9, 1e-4, 35.0,
                          tsched(LR, 10, warmup_iters=0))
        logs[name] = make_train_step(net, opt, dtype)(
            bt, generator=torch.Generator().manual_seed(3))
        nets[name] = net
    p16 = nets['bf16']
    assert all(p.dtype == torch.float32 for p in p16.parameters())
    assert all(p.grad.dtype == torch.float32 for p in p16.parameters()
               if p.grad is not None)
    assert all(t.dtype == torch.float32 for t in p16.state_dict().values()
               if t.is_floating_point())
    l16, l32 = float(logs['bf16']['loss']), float(logs['fp32']['loss'])
    assert np.isfinite(l16) and abs(l16 - l32) <= LOSS_RTOL_FP32 * abs(l32)
    new16, new32, old = ({k: p.detach() for k, p in m.named_parameters()}
                         for m in (p16, nets['fp32'], base))
    num = sum(float(((new16[k] - new32[k]) ** 2).sum()) for k in old)
    den = sum(float(((new32[k] - old[k]) ** 2).sum()) for k in old)
    assert den > 0 and num <= UPDATE_RATIO * den, (num, den)


@contextlib.contextmanager
def injected_proposals(props):
    """While active, the port's ``rpn_get_proposals`` hands over JAX's
    proposals (``props``: boxes, scores, valid, numpy)."""
    import dynamask_torch.models.detectors as tdet
    from dynamask_torch.models.rpn_head import Proposals
    saved = tdet.rpn_get_proposals
    tdet.rpn_get_proposals = lambda *a, **k: Proposals(
        *(torch.from_numpy(np.array(x)) for x in props))
    try:
        yield
    finally:
        tdet.rpn_get_proposals = saved


def _jax_train_proposals(det, variables, batch):
    """The proposals of JAX's bf16 training step: parameters cast to bf16,
    BatchNorm statistics fp32 (``engine/train_state.py:59-65``)."""
    from dynamask_tpu.core.fp16 import to_bf16
    from dynamask_tpu.models.rpn_head import rpn_get_proposals

    def props(m, b):
        feats = m.extract_feat(b['image'], train=True)
        cls, reg = m.rpn_head(feats, train=True)
        anchors = m._anchor_generator().grid_anchors(
            [tuple(f.shape[1:3]) for f in feats])
        p = rpn_get_proposals(
            cls, reg, anchors, b['img_shape'], nms_pre=m.rpn_nms_pre_train,
            max_num=m.rpn_max_num, nms_thr=m.rpn_nms_thr,
            target_means=m.rpn_target_means, target_stds=m.rpn_target_stds)
        return p.boxes, p.scores, p.valid

    v = {'params': to_bf16(variables['params']),
         'batch_stats': variables['batch_stats']}
    b = dict(batch, image=batch['image'].astype(jnp.bfloat16))
    return jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method=props, mutable=['batch_stats'])[0])(v, b))


def test_bf16_step_losses_match_jax():
    """The port's bf16 step on the DynaMask toy against JAX's bf16
    ``make_train_step``, from the same variables and batch, on JAX's
    proposals with the same sampler priorities and Gumbel uniforms: every
    loss within LOSS_RTOL_JAX, the accuracy equal (the same sampled RoIs);
    fp32 masters and gradients after it."""
    from test_dynamask import dynamask_toy_cfg
    from test_models import demo_batch
    from test_torch_port_train_slice import jax_draws
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     make_train_step as jstep)
    from dynamask_tpu.engine.optimizer import step_lr_schedule
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import (DetectorSGD, load_jax_variables,
                                       make_train_step)
    from dynamask_torch.engine import step_lr_schedule as tsched
    from dynamask_torch.models import build_detector

    cfg = dynamask_toy_cfg()
    det = jax_build(*cfg)
    variables = _toy_variables()
    batch = {k: np.array(v) for k, v in demo_batch(0, b=1, h=64, w=64, g=3,
                                                   s=16).items()}
    rng = np.random.RandomState(12)
    n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = {'rpn': rng.uniform(size=(1, n_anchors)).astype(np.float32),
             'rcnn': rng.uniform(size=(1, 3 + 32)).astype(np.float32),
             'gumbel': rng.uniform(1e-4, 1 - 1e-4, (8, 4)).astype(
                 np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = build_optimizer(
        variables['params'], LR, 0.9, 1e-4, 35.0,
        step_lr_schedule(LR, 10, warmup_iters=0),
        frozen_backbone_prefixes=det.backbone.frozen_param_paths())
    with jax_draws(noise):
        _, ref = jax.jit(jstep(det, tx, compute_dtype=jnp.bfloat16))(
            create_train_state(variables, tx), jb, jax.random.PRNGKey(0))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}

    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    port.train()
    opt = DetectorSGD(port, LR, 0.9, 1e-4, 35.0,
                      tsched(LR, 10, warmup_iters=0))
    with injected_proposals(_jax_train_proposals(det, variables, jb)):
        got = make_train_step(port, opt, torch.bfloat16)(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in noise.items()})
    got = {k: float(v) for k, v in got.items()}
    keys = {k for k in ref if 'loss' in k}
    assert keys >= {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox',
                    'loss_masks', 'loss_flops', 'loss'}
    for k in sorted(keys):
        assert abs(got[k] - ref[k]) <= LOSS_RTOL_JAX * abs(ref[k]) + 1e-6, (
            k, got[k], ref[k])
    assert got['acc'] == pytest.approx(ref['acc'])
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(p.grad.dtype == torch.float32 for p in port.parameters()
               if p.grad is not None)
