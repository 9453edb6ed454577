"""Item 9's two-stage heads in the port against the JAX package, module by
module, on the CPU (``dynamask_torch/ops/point_sample.py``,
``models/point_rend.py``, ``point_refine_head.py``, ``mask_scoring.py``,
``grid_rcnn.py`` and ``dynamic_rcnn.py`` against their
``dynamask_tpu`` namesakes), the JAX weights carried across by the port's
key map (``dynamask_torch.engine.convert``).

- ``point_sample`` (zero outside the map) and ``grid_point_sample``
  (clamped), ``PointSFMStage``, ``CoarseMaskHead``, ``MaskPointHead``
  (class-specific and class-agnostic), ``MaskIoUHead`` and ``GridHead``
  (both orders of fusion, the grouped deconvs, with and without the
  unfused maps): the outputs in fp32 within 1e-5 relative L2, and in
  float64 the gradients of a seeded cotangent in every parameter and input
  within 1e-9 relative L2.
- ``grid_targets`` and ``grid_refine_boxes`` against JAX's.
- The top-k's tie order: JAX's ``lax.top_k`` gives the lower index first
  among equal values, and so does ``ops.point_sample.top_k``; a
  ``PointSFMStage`` on a RoI whose crop is constant (every detail logit
  tied) picks JAX's points.
- Dynamic R-CNN's adaptive state over ``update_iter_interval=2``: three
  steps of a toy detector, the losses and every buffer against JAX's
  ``batch_stats`` after each.
"""

import copy
import functools
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
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402

RL2 = 1e-5          # fp32 outputs
RL2_64 = 1e-9       # float64 outputs and gradients
# what passes a x2 bilinear resize in float64: both packages resize in fp32
# (JAX's ``interpolate_bilinear`` casts to it, the port's as JAX's), the
# two fp32 matmuls summing in other orders
RL2_RESIZE = 1e-6


def _holder(path, module):
    """``module`` at the dotted ``path`` of an empty module (so its keys
    read as the detector's)."""
    root = torch.nn.Module()
    node = root
    parts = path.split('.')
    for p in parts[:-1]:
        child = torch.nn.Module()
        node.add_module(p, child)
        node = child
    node.add_module(parts[-1], module)
    return root


def _nest(path, tree):
    """The JAX ``tree`` under the flax path that ``path`` maps to."""
    for p in reversed(path):
        tree = {p: tree}
    return tree


def load(port, dotted, jax_path, variables):
    """Load the JAX module's ``variables`` into ``port`` through the port's
    key map, the module standing at ``dotted`` (a detector's key prefix)
    and JAX's at ``jax_path``; returns the holder."""
    from dynamask_torch.engine import load_jax_variables
    holder = _holder(dotted, port)
    load_jax_variables(holder, {
        'params': _nest(jax_path, variables['params']),
        'batch_stats': _nest(jax_path, variables.get('batch_stats', {}))})
    return holder


def _rois(rng, n, w=64.0, h=48.0):
    xy = rng.uniform(-4, [w - 8, h - 8], (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_grads(fn, params, inputs, cots):
    """float64 outputs of ``fn(params, *inputs)`` and the gradients of
    sum(outputs * cots) in the parameters and the inputs."""
    with jax.enable_x64(True):
        def loss(p, *xs):
            outs = fn(p, *xs)
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs
        (_, outs), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True))(
            _f64(params), *[jnp.asarray(x, jnp.float64) for x in inputs])
        return jax.device_get((outs, grads))


def double(holder, dotted):
    """A float64 copy of ``holder`` and of its module at ``dotted``."""
    holder = copy.deepcopy(holder).double()
    return holder, holder.get_submodule(dotted)


def _port_param_grads(holder, jax_grads, dotted, jax_path, tol=RL2_64):
    """Each port parameter's gradient against JAX's through the key map."""
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    tree = _nest(jax_path, jax_grads)
    n = 0
    for k, p in holder.named_parameters():
        want = _torch_layout(tree, {}, *mmdet_key(k))
        assert p.grad is not None, k
        assert rel_l2(p.grad.numpy(), want) < tol, (k, rel_l2(
            p.grad.numpy(), want))
        n += 1
    return n


# -- point sampling -----------------------------------------------------------


def _points(rng, n, p, h, w):
    """Points over a h x w map and a band around it (zero or clamped
    there), some on pixel centres and edges."""
    pts = rng.uniform(-1.5, 1, (n, p, 2)) * [w + 3, h + 3]
    pts[:, :4] = [[0.5, 0.5], [w, h], [w - 0.5, 0.], [-0.25, h + 0.25]]
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _point_sample_case():
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 10, 12, 5).astype(np.float32)
    pts = np.abs(_points(rng, 6, 40, 10, 12))
    pts[:, 4:8] = rng.uniform(-3, 15, (6, 4, 2))
    return feats, pts, np.array([0, 1, 1, 0, 1, 0]), rng.randn(
        6, 40, 5).astype(np.float32)


def test_point_sample_forward():
    from dynamask_tpu.ops.point_sample import point_sample as jps
    from dynamask_torch.ops.point_sample import point_sample
    feats, pts, b, _ = _point_sample_case()
    ref = np.asarray(jps(jnp.asarray(feats), jnp.asarray(pts),
                         jnp.asarray(b)))
    got = point_sample(torch.from_numpy(feats), torch.from_numpy(pts),
                       torch.from_numpy(b)).numpy()
    assert rel_l2(got, ref) < RL2 and (ref == 0).any()


def test_point_sample_gradients():
    """float64: the map's gradient (autograd's scatter-add into the
    corners) and the points'."""
    from dynamask_tpu.ops.point_sample import point_sample as jps
    from dynamask_torch.ops.point_sample import point_sample
    feats, pts, b, cot = _point_sample_case()
    outs, (_, gf, gp) = _jax_grads(
        lambda _, f, p: [jps(f, p, jnp.asarray(b))], {}, (feats, pts), [cot])
    f = torch.from_numpy(feats).double().requires_grad_()
    p = torch.from_numpy(pts).double().requires_grad_()
    out = point_sample(f, p, torch.from_numpy(b))
    (out * torch.from_numpy(cot).double()).sum().backward()
    assert rel_l2(out.detach().numpy(), outs[0]) < RL2_64
    assert rel_l2(f.grad.numpy(), gf) < RL2_64
    assert rel_l2(p.grad.numpy(), gp) < RL2_64


def test_grid_point_sample_forward_and_gradients():
    """Unit-square points over 7x7 maps, among them the border band where
    the indices and weights clamp; fp32, then float64 gradients."""
    from dynamask_tpu.models.point_rend import grid_point_sample as jgps
    from dynamask_torch.models.point_rend import grid_point_sample
    rng = np.random.RandomState(1)
    maps = rng.randn(5, 7, 7, 3).astype(np.float32)
    pts = rng.uniform(0, 1, (5, 30, 2)).astype(np.float32)
    pts[:, :4] = [[0., 0.], [1., 1.], [0.02, 0.98], [0.5 / 7, 6.5 / 7]]
    ref = np.asarray(jgps(jnp.asarray(maps), jnp.asarray(pts)))
    got = grid_point_sample(torch.from_numpy(maps),
                            torch.from_numpy(pts)).numpy()
    assert rel_l2(got, ref) < RL2
    cot = rng.randn(*ref.shape)
    pts64 = np.asarray(pts, np.float64)
    outs, (_, gm) = _jax_grads(lambda _, m: [jgps(m, jnp.asarray(pts64))],
                               {}, (maps,), [cot])
    m = torch.from_numpy(maps).double().requires_grad_()
    out = grid_point_sample(m, torch.from_numpy(pts).double())
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel_l2(out.detach().numpy(), outs[0]) < RL2_64
    assert rel_l2(m.grad.numpy(), gm) < RL2_64


def test_top_k_breaks_ties_as_jax():
    """Rows of many equal values: ``top_k`` gives JAX's values and indices
    (the lower index first among equals)."""
    from dynamask_torch.ops.point_sample import top_k
    rng = np.random.RandomState(2)
    x = rng.randint(0, 4, (6, 50)).astype(np.float32)
    x[0] = 1.0                                   # all tied
    for k in (1, 7, 50):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        v, i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(top_k(torch.from_numpy(x), 7)[1][0],
                                  np.arange(7))


# -- PointSFMStage ------------------------------------------------------------

SFM = dict(semantic_out_channel=16, fc_channels=16, fc_out_channels=8,
           num_fcs=2, num_classes=5, num_points=20, semantic_out_stride=4,
           mask_use_sigmoid=True, coarse_pred_each_layer=True)


@functools.lru_cache(maxsize=None)
def _sfm_case(tied=False):
    """The JAX stage and its randomised variables, the port's loaded, the
    inputs: 6 RoIs' 8x8x16 features (``tied``: RoI 2's constant, so every
    detail logit of it ties), a 2x16x20x12 semantic map (stride 4 on a
    64x80 canvas), RoIs, their images and labels."""
    from dynamask_tpu.models.point_refine_head import PointSFMStage as J
    from dynamask_torch.models.point_refine_head import PointSFMStage
    rng = np.random.RandomState(3)
    x = rng.randn(6, 8, 8, 16).astype(np.float32)
    if tied:
        x[2] = 0.7
    sem = rng.randn(2, 16, 20, 12).astype(np.float32)
    rois = _rois(rng, 6, 80.0, 64.0)
    batch = np.array([0, 1, 0, 1, 1, 0], np.int32)
    labels = np.array([1, 4, 0, 3, 2, 9], np.int32)     # 9: clamped
    inputs = (x, sem, rois, batch, labels)
    m = J(**SFM)
    v = randomize_variables(m.init(jax.random.PRNGKey(0),
                                   *map(jnp.asarray, inputs)))
    port = PointSFMStage(12, 16, 8, 2, 5, 20, 4, True, True)
    holder = load(torch.nn.ModuleList([port]), 'roi_head.mask_head.stages',
                  ['roi_head', 'mask_head', 'stage_0'], v)
    return m, v, port, holder, inputs


def _sfm_port(port, inputs, dtype=torch.float32):
    x, sem, rois, batch, labels = inputs
    nchw = (lambda a: torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2))
    return port(nchw(x), nchw(sem), torch.from_numpy(rois).to(dtype),
                torch.from_numpy(batch).long(),
                torch.from_numpy(labels).long())


@pytest.mark.parametrize('tied', [False, True], ids=['random', 'tied'])
def test_point_sfm_stage_forward(tied):
    """The class-selected instance and detail logits and the refined
    features; with ``tied`` RoI 2's 64 detail logits are one value, and
    the 20 points refined are JAX's (the first 20 positions)."""
    m, v, port, _, inputs = _sfm_case(tied)
    ref = m.apply(v, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = _sfm_port(port, inputs)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert rel_l2(a.permute(0, 2, 3, 1).numpy(), b) < RL2
    if tied:
        det = np.asarray(ref[1])[2]
        assert np.all(det == det.flat[0])
        from dynamask_torch.ops.point_sample import top_k
        _, idx = top_k(torch.sigmoid(got[1][2, 0]).reshape(1, -1), 20)
        np.testing.assert_array_equal(idx[0].numpy(), np.arange(20))


def test_point_sfm_stage_gradients():
    """float64: the logits within 1e-9, and the refined features and the
    gradients of every parameter and of the instance and semantic features
    (the scatter's and the gathers'), which pass the x2 resize, within
    ``RL2_RESIZE``."""
    m, v, port, holder, inputs = _sfm_case()
    x, sem, rois, batch, labels = inputs
    shapes = [o.shape for o in jax.eval_shape(m.apply, v,
                                              *map(jnp.asarray, inputs))]
    rng = np.random.RandomState(4)
    cots = [rng.randn(*s) for s in shapes]
    outs, (gp, gx, gs) = _jax_grads(
        lambda p, a, s: m.apply({'params': p}, a, s, jnp.asarray(rois,
                                                                 jnp.float64),
                                jnp.asarray(batch), jnp.asarray(labels)),
        v['params'], (x, sem), cots)
    holder, port = double(holder, 'roi_head.mask_head.stages.0')
    xt = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    st = torch.from_numpy(sem).double().permute(0, 3, 1, 2).requires_grad_()
    got = port(xt, st, torch.from_numpy(rois).double(),
               torch.from_numpy(batch).long(), torch.from_numpy(labels).long())
    sum((g.permute(0, 2, 3, 1) * torch.from_numpy(c)).sum()
        for g, c in zip(got, cots)).backward()
    for a, b, tol in zip(got, outs, (RL2_64, RL2_64, RL2_RESIZE)):
        assert rel_l2(a.detach().permute(0, 2, 3, 1).numpy(), b) < tol
    assert rel_l2(xt.grad.permute(0, 2, 3, 1).numpy(), gx) < RL2_RESIZE
    assert rel_l2(st.grad.permute(0, 2, 3, 1).numpy(), gs) < RL2_RESIZE
    n = _port_param_grads(holder, gp, None, ['roi_head', 'mask_head',
                                             'stage_0'], RL2_RESIZE)
    assert n == 2 * (4 + 2 + 1)


# -- PointRend's heads --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _coarse_case():
    from dynamask_tpu.models.point_rend import CoarseMaskHead as J
    from dynamask_torch.models.point_rend import CoarseMaskHead
    rng = np.random.RandomState(5)
    x = rng.randn(4, 14, 14, 12).astype(np.float32)
    m = J(num_convs=1, num_fcs=2, in_channels=12, conv_out_channels=10,
          fc_out_channels=24, downsample_factor=2, roi_feat_size=14,
          num_classes=5)
    v = randomize_variables(fast_jit(m.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    port = CoarseMaskHead(1, 2, 12, 10, 24, 2, 14, 5)
    holder = load(port, 'roi_head.mask_head', ['roi_head', 'mask_head'], v)
    return m, v, port, holder, x


def test_coarse_mask_head():
    """The (N, 7, 7, classes) JAX logits are the port's (N, classes, 7, 7)
    (its ``fc_logits`` rows reordered); float64 gradients."""
    m, v, port, holder, x = _coarse_case()
    ref = np.asarray(fast_jit(m.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (4, 5, 7, 7)
    assert rel_l2(got.permute(0, 2, 3, 1).numpy(), ref) < RL2
    cot = np.random.RandomState(6).randn(*ref.shape)
    outs, (gp, gx) = _jax_grads(lambda p, a: [m.apply({'params': p}, a)],
                                v['params'], (x,), [cot])
    holder, port = double(holder, 'roi_head.mask_head')
    xt = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    out = port(xt)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    assert rel_l2(out.detach().permute(0, 2, 3, 1).numpy(), outs[0]) < \
        RL2_64
    assert rel_l2(xt.grad.permute(0, 2, 3, 1).numpy(), gx) < RL2_64
    assert _port_param_grads(holder, gp, None, ['roi_head', 'mask_head']) \
        == 10


@pytest.mark.parametrize('agnostic', [False, True],
                         ids=['per_class', 'agnostic'])
def test_mask_point_head(agnostic):
    """fcs with the coarse logits re-appended, then the logits; fp32 and
    float64 gradients of every parameter and both inputs."""
    from dynamask_tpu.models.point_rend import MaskPointHead as J
    from dynamask_torch.models.point_rend import MaskPointHead
    rng = np.random.RandomState(7)
    fine = rng.randn(3, 25, 12).astype(np.float32)
    coarse = rng.randn(3, 25, 5).astype(np.float32)
    m = J(num_classes=5, num_fcs=3, in_channels=12, fc_channels=16,
          class_agnostic=agnostic)
    v = randomize_variables(m.init(jax.random.PRNGKey(0), jnp.asarray(fine),
                                   jnp.asarray(coarse)))
    port = MaskPointHead(5, 3, 12, 16, agnostic)
    holder = load(port, 'roi_head.point_head', ['roi_head', 'point_head'], v)
    ref = np.asarray(m.apply(v, jnp.asarray(fine), jnp.asarray(coarse)))
    with torch.no_grad():
        got = port(torch.from_numpy(fine), torch.from_numpy(coarse)).numpy()
    assert got.shape == ref.shape == (3, 25, 1 if agnostic else 5)
    assert rel_l2(got, ref) < RL2
    cot = rng.randn(*ref.shape)
    outs, (gp, gf, gc) = _jax_grads(
        lambda p, a, b: [m.apply({'params': p}, a, b)], v['params'],
        (fine, coarse), [cot])
    holder, port = double(holder, 'roi_head.point_head')
    f = torch.from_numpy(fine).double().requires_grad_()
    c = torch.from_numpy(coarse).double().requires_grad_()
    out = port(f, c)
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel_l2(out.detach().numpy(), outs[0]) < RL2_64
    assert rel_l2(f.grad.numpy(), gf) < RL2_64
    assert rel_l2(c.grad.numpy(), gc) < RL2_64
    assert _port_param_grads(holder, gp, None, ['roi_head', 'point_head']) \
        == 8


# -- Mask Scoring R-CNN's MaskIoU head ----------------------------------------


def test_mask_iou_head():
    """The 14x14 features beside the max-pooled 28x28 probabilities through
    four convs (the last at stride 2) and the fcs; fp32, float64
    gradients (the probabilities' through the max pool too)."""
    from dynamask_tpu.models.mask_scoring import MaskIoUHead as J
    from dynamask_torch.models.mask_scoring import MaskIoUHead
    rng = np.random.RandomState(8)
    feats = rng.randn(3, 14, 14, 12).astype(np.float32)
    probs = rng.uniform(0, 1, (3, 28, 28)).astype(np.float32)
    m = J(num_convs=4, num_fcs=2, conv_out_channels=8, fc_out_channels=16,
          num_classes=5)
    v = randomize_variables(fast_jit(m.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(feats),
                                            jnp.asarray(probs)))
    port = MaskIoUHead(4, 2, 12, 8, 16, 14, 5)
    holder = load(port, 'roi_head.mask_iou_head',
                  ['roi_head', 'mask_iou_head'], v)
    ref = np.asarray(fast_jit(m.apply)(v, jnp.asarray(feats),
                                      jnp.asarray(probs)))
    with torch.no_grad():
        got = port(torch.from_numpy(feats).permute(0, 3, 1, 2),
                   torch.from_numpy(probs)).numpy()
    assert rel_l2(got, ref) < RL2
    cot = rng.randn(*ref.shape)
    outs, (gp, gf, gq) = _jax_grads(
        lambda p, a, b: [m.apply({'params': p}, a, b)], v['params'],
        (feats, probs), [cot])
    holder, port = double(holder, 'roi_head.mask_iou_head')
    f = torch.from_numpy(feats).double().permute(0, 3, 1, 2).requires_grad_()
    q = torch.from_numpy(probs).double().requires_grad_()
    out = port(f, q)
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel_l2(out.detach().numpy(), outs[0]) < RL2_64
    assert rel_l2(f.grad.permute(0, 2, 3, 1).numpy(), gf) < RL2_64
    assert rel_l2(q.grad.numpy(), gq) < RL2_64
    assert _port_param_grads(holder, gp, None, ['roi_head',
                                                'mask_iou_head']) == 14


def test_mask_iou_target():
    from dynamask_tpu.models.mask_scoring import mask_iou_target as jt
    from dynamask_torch.models.mask_scoring import mask_iou_target
    rng = np.random.RandomState(9)
    pred = (rng.uniform(size=(6, 28, 28)) > 0.5).astype(np.float32)
    tgt = (rng.uniform(size=(6, 28, 28)) > 0.4).astype(np.float32)
    ratio = rng.uniform(0, 1, 6).astype(np.float32)
    ratio[0] = 0.0
    ref = np.asarray(jt(*map(jnp.asarray, (pred, tgt, ratio))))
    got = mask_iou_target(*map(torch.from_numpy, (pred, tgt, ratio)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


# -- Grid R-CNN ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _grid_case():
    """The JAX ``GridHead`` (9 points, 2 convs, 4 channels a point, 6 GN
    groups) on 3 RoIs' 14x14x12 crops, its deconv kernels widened from
    their N(0, 0.001) init; the port's loaded."""
    from dynamask_tpu.models.grid_rcnn import GridHead as J
    from dynamask_torch.models.grid_rcnn import GridHead
    rng = np.random.RandomState(10)
    x = rng.randn(3, 14, 14, 12).astype(np.float32)
    m = J(grid_points=9, num_convs=2, roi_feat_size=14, in_channels=12,
          point_feat_channels=4, gn_groups=6)
    v = randomize_variables(fast_jit(functools.partial(m.init, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    p = v['params']
    for k in ('deconv1_kernel', 'deconv2_kernel'):
        p[k] = rng.normal(0, 0.2, np.shape(p[k])).astype(np.float32)
    port = GridHead(9, 2, 14, 12, 4, 6)
    holder = load(port, 'roi_head.grid_head', ['roi_head',
                                               'grid_head_module'], v)
    return m, v, port, holder, x


@pytest.mark.parametrize('train', [False, True], ids=['test', 'train'])
def test_grid_head_forward(train):
    """The fused heatmaps (and with ``train`` the unfused ones), (N, 9,
    28, 28) against JAX's NHWC maps."""
    m, v, port, _, x = _grid_case()
    ref = fast_jit(functools.partial(m.apply, train=train))(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), train)
    for k in ('fused', 'unfused'):
        assert got[k].shape == (3, 9, 28, 28)
        assert rel_l2(got[k].permute(0, 2, 3, 1).numpy(),
                      np.asarray(ref[k])) < RL2
    assert torch.equal(got['fused'], got['unfused']) != train


def test_grid_head_gradients():
    """float64, train mode: every parameter's gradient (the first- and
    second-order transitions', the grouped deconvs' through the key map's
    reordering) and the input's."""
    m, v, port, holder, x = _grid_case()
    rng = np.random.RandomState(11)
    cots = [rng.randn(3, 28, 28, 9) for _ in range(2)]
    outs, (gp, gx) = _jax_grads(
        lambda p, a: [m.apply({'params': p}, a, train=True)[k]
                      for k in ('fused', 'unfused')],
        v['params'], (x,), cots)
    holder, port = double(holder, 'roi_head.grid_head')
    xt = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    got = port(xt, True)
    sum((got[k].permute(0, 2, 3, 1) * torch.from_numpy(c)).sum()
        for k, c in zip(('fused', 'unfused'), cots)).backward()
    for k, o in zip(('fused', 'unfused'), outs):
        assert rel_l2(got[k].detach().permute(0, 2, 3, 1).numpy(), o) < \
            RL2_64
    assert rel_l2(xt.grad.permute(0, 2, 3, 1).numpy(), gx) < RL2_64
    n = _port_param_grads(holder, gp, None, ['roi_head', 'grid_head_module'])
    # 2 convs and GNs, 24 transitions of each order (2 convs each), the
    # deconvs and the GN between them
    assert n == 2 * 4 + 2 * 24 * 4 + 2 + 2 + 2


def test_grid_targets():
    """The dense circle targets of jittered positives over their GTs,
    exactly; an expanded RoI of 3 pixels or less a side has none."""
    from dynamask_tpu.models.grid_rcnn import grid_targets as jt
    from dynamask_torch.models.grid_rcnn import grid_targets
    rng = np.random.RandomState(12)
    gts = _rois(rng, 20, 200.0, 160.0)
    boxes = gts + rng.uniform(-8, 8, gts.shape).astype(np.float32)
    boxes[0, 2:] = boxes[0, :2] + 1.0                 # degenerate
    ref = np.asarray(jt(jnp.asarray(boxes), jnp.asarray(gts), 9, 56, 1))
    got = grid_targets(torch.from_numpy(boxes), torch.from_numpy(gts), 9, 56,
                       1).numpy()
    assert got.shape == (20, 9, 28, 28) and got.sum() > 100
    assert not ref[0].any()
    np.testing.assert_array_equal(got, ref)


def test_grid_refine_boxes():
    """The score-weighted votes of the heatmaps' maxima, clipped to the
    image; dets of zero size (padded slots) among them."""
    from dynamask_tpu.models.grid_rcnn import grid_refine_boxes as jr
    from dynamask_torch.models.grid_rcnn import grid_refine_boxes
    rng = np.random.RandomState(13)
    dets = np.concatenate([_rois(rng, 8), rng.uniform(0, 1, (8, 1))],
                          1).astype(np.float32)
    dets[7] = 0.0
    maps = rng.randn(8, 28, 28, 9).astype(np.float32) * 3
    shape = np.array([48., 64.], np.float32)
    ref = np.asarray(jr(jnp.asarray(dets), jnp.asarray(maps), 9, 56,
                        jnp.asarray(shape)))
    got = grid_refine_boxes(torch.from_numpy(dets),
                            torch.from_numpy(maps).permute(0, 3, 1, 2), 9, 56,
                            torch.from_numpy(shape)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    assert (got[:, 2] <= 64).all() and (got >= 0).all()


# -- Dynamic R-CNN's state ----------------------------------------------------


def dynamic_toy_cfg(interval=2):
    """The mini Faster R-CNN with a ``DynamicRoIHead`` (SmoothL1 of beta
    1, the state updated every ``interval`` steps)."""
    import copy
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    model['type'] = 'FasterRCNN'
    rh = model['roi_head']
    rh.update(type='DynamicRoIHead', mask_head=None, mask_roi_extractor=None)
    rh['bbox_head']['loss_bbox'] = dict(type='SmoothL1Loss', beta=1.0,
                                        loss_weight=1.0)
    train_cfg['rcnn']['dynamic_rcnn'] = dict(
        iou_topk=8, beta_topk=2, update_iter_interval=interval,
        initial_iou=0.4, initial_beta=1.0)
    return model, train_cfg, test_cfg


STATE = ('dyn_iou_thr', 'dyn_beta', 'dyn_iou_hist', 'dyn_beta_hist',
         'dyn_step')


def test_dynamic_rcnn_state_update():
    """Three steps of the toy at ``update_iter_interval=2`` from the same
    weights (no update between them), the draws given: each step's losses
    within 1e-5 relative of JAX's, and after each every buffer equal to
    JAX's ``batch_stats`` (within 1e-6); the threshold and beta move at
    step 2 and step 3 assigns at the new threshold. No step reads the
    state back to the host: the port's loop is the same whatever it
    holds."""
    from test_torch_port_cascade import _demo
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = dynamic_toy_cfg()
    det = jax_build(*cfg)
    batch = _demo(2)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    v = randomize_variables(fast_jit(det.init)({'params': jax.random.PRNGKey(
        0)}, {k: jb[k][:1] for k in jb}))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, v)
    port.train()
    for k in STATE:
        np.testing.assert_allclose(getattr(port.roi_head, k).numpy(),
                                   np.asarray(v['batch_stats']['roi_head'][k]))
    n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    rng = np.random.RandomState(14)
    stats = v['batch_stats']

    @jax.jit
    def jstep(stats, b):
        return det.apply({'params': v['params'], 'batch_stats': stats}, b,
                         method='forward_train',
                         rngs={'sampling': jax.random.PRNGKey(0)},
                         mutable=['batch_stats'])

    # one table a candidate count: the jitted step holds the draws it
    # traced with
    tables = {n: rng.uniform(size=n).astype(np.float32)
              for n in (n_anchors, 3 + 32)}
    thr = []
    for step in range(3):
        with jax_sampler_priorities(tables):
            losses, new = jstep(stats, jb)
        stats = new['batch_stats']
        noise = {'rpn': torch.from_numpy(np.tile(tables[n_anchors], (2, 1))),
                 'rcnn': torch.from_numpy(np.tile(tables[35], (2, 1)))}
        got = port.forward_train({k: torch.from_numpy(x)
                                  for k, x in batch.items()}, noise)
        for k in ('loss_cls', 'loss_bbox', 'acc'):
            np.testing.assert_allclose(float(got[k].detach()),
                                       float(losses[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for k in STATE:
            np.testing.assert_allclose(
                getattr(port.roi_head, k).numpy(),
                np.asarray(stats['roi_head'][k]), rtol=1e-6, atol=1e-7,
                err_msg=f'step {step}: {k}')
        thr.append(float(port.roi_head.dyn_iou_thr))
    assert int(port.roi_head.dyn_step) == 3
    assert thr[0] == 0.5 and thr[1] != 0.5 and thr[1] == thr[2]
    assert float(port.roi_head.dyn_beta) <= 1.0
