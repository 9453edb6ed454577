"""Guided anchoring in the port against the JAX package, on the CPU
(``dynamask_torch/models/guided_anchor.py`` against
``dynamask_tpu/models/guided_anchor.py``; the toys of
``tests/test_guided_anchor.py`` as they are, the JAX weights carried
across by ``dynamask_torch.engine.convert``).

- ``FeatureAdaption`` on a non-square 9x13 plane in 4 deform groups, its
  offsets past the ±3 window: the output within 1e-5 and every gradient
  (the input's, ``conv_offset``'s through the offset gradient of K3's
  plain version, the deformable kernel's) within 1e-4 relative L2; the
  shape prediction gets none (detached) on either side.
- The dense location targets level by level, exactly.
- GA-RetinaNet, GA-Faster R-CNN and GA-RPN: ``simple_test`` slot for slot
  (dets ``rtol=1e-5, atol=1e-4``, labels and validity exact), one
  ``forward_train`` with the shape sampler's (each image its own), the
  RPN sampler's and the RoI sampler's draws injected on both sides: every
  loss within 1e-4 relative, every parameter's gradient within 1e-3 relative L2.
- The JAX faults 3aq (unit stds), 3ar (image 0's valid flags), 3as (the
  guided anchors' ``wh_ratio_clip``) and 3au (the window where mmcv's DCN
  is unbounded), and the keys the GA builders refuse.
"""

import copy
import contextlib
import functools
import itertools
import math
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

from test_guided_anchor import ga_faster_toy_cfg, ga_toy_cfg  # noqa: E402
from test_torch_port_cascade import _port_grads  # noqa: E402
from test_torch_port_modules import randomize_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
G = 3                        # the demo batch's GTs
P = 32                       # GA-Faster's proposals in training
# the shape sampler's squares an image in the training step: 2 positives
# of the demo's 4-6 (the toys' 64 keep them all)
GA_SAMPLES = 4
KINDS = ('retina', 'faster', 'rpn')


def toy_cfg(kind):
    if kind == 'retina':
        return ga_toy_cfg()
    model, train_cfg, test_cfg = copy.deepcopy(ga_faster_toy_cfg())
    if kind == 'rpn':
        model = dict(model, type='RPN')
        model.pop('roi_head')
        train_cfg.pop('rcnn')
        test_cfg.pop('rcnn')
    return model, train_cfg, test_cfg


def _demo(b=1):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(0, b=b, h=64, w=64, g=G,
                                                  s=16).items()}


def n_squares(kind):
    strides = (8, 16, 32, 64, 128) if kind == 'retina' else (4, 8, 16, 32,
                                                               64)
    return sum(math.ceil(64 / s) ** 2 for s in strides)


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them). The location biases sit near the filter's threshold, so the
    filter drops some positions and keeps others."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    det = jax_build(*cfg)
    batch = {k: jnp.asarray(v) for k, v in _demo().items()}
    variables = randomize_variables(
        jax.jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    head = variables['params']['bbox_head' if kind == 'retina' else
                               'rpn_head']
    head['conv_loc']['bias'] = np.full((1,), -4.6, np.float32)
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


@contextlib.contextmanager
def ga_draws(pos, neg):
    """While active, the JAX guided-anchor module's shape sampler takes
    ``pos`` and ``neg`` as its two uniform draws: a (B, squares) table
    gives image i its row i, a (squares,) one every image the same. Its
    ``jax.random.split`` gives key j of a split ``[j, key[0]]``, so an
    image's two sampler keys are ``[0, i]`` and ``[1, i]`` under the vmap
    over images, and a draw reads its table and row from its key."""
    import dynamask_tpu.models.guided_anchor as jga
    table = jnp.stack([jnp.asarray(pos), jnp.asarray(neg)])

    def split(key, num=2):
        if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
            key = jax.random.key_data(key)
        return jnp.stack([jnp.stack([jnp.uint32(j), key[0].astype(
            jnp.uint32)]) for j in range(num)])

    def uniform(key, shape, *a, **k):
        rows = table[key[0]]
        return rows[key[1]] if rows.ndim == 2 else rows

    class _Proxy(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jax, name)

    proxy = _Proxy('jax')
    proxy.random = types.SimpleNamespace(
        uniform=uniform, split=split, PRNGKey=jax.random.PRNGKey)
    saved = jga.jax
    jga.jax = proxy
    try:
        yield
    finally:
        jga.jax = saved


# -- FeatureAdaption ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def adaption_pair():
    """The JAX ``FeatureAdaption`` (C 16 -> 16, 4 groups) on a 2x9x13
    plane with a 2-channel shape prediction scaled so the offsets reach
    past ±3, its forward and ``jax.grad`` of a seeded cotangent; the
    port's module with the same weights."""
    from dynamask_tpu.models.guided_anchor import FeatureAdaption as JFA
    from dynamask_torch.models.guided_anchor import FeatureAdaption
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 9, 13, 16)).astype(np.float32)
    shape = (rng.normal(size=(2, 9, 13, 2)) * 12).astype(np.float32)
    cot = rng.normal(size=(2, 9, 13, 16)).astype(np.float32)
    m = JFA(16, deform_groups=4)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x),
                    jnp.asarray(shape))['params']

    def f(p, x_, s_):
        return jnp.sum(m.apply({'params': p}, x_, s_) * cot)

    ref = np.asarray(m.apply({'params': params}, jnp.asarray(x),
                             jnp.asarray(shape)))
    grads = jax.grad(f, argnums=(0, 1, 2))(params, jnp.asarray(x),
                                           jnp.asarray(shape))
    port = FeatureAdaption(16, 16, 4)
    with torch.no_grad():
        port.conv_offset.weight.copy_(torch.from_numpy(np.asarray(
            params['conv_offset']['kernel']).transpose(3, 2, 0, 1).copy()))
        port.conv_adaption.weight.copy_(torch.from_numpy(np.asarray(
            params['weight']).transpose(3, 2, 0, 1).copy()))
    return (x, shape, cot), ref, jax.device_get(grads), port


def test_feature_adaption_forward():
    """The output within 1e-5 of JAX's windowed DCN, and some offsets past
    the window (the clip is exercised)."""
    (x, shape, _), ref, _, port = adaption_pair()
    off = np.einsum('nhwc,co->nhwo', shape, port.conv_offset.weight.detach()
                    .numpy()[:, :, 0, 0].T)
    assert np.abs(off).max() > 3.5
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
               torch.from_numpy(shape).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), ref,
                               atol=1e-5)


def test_feature_adaption_gradients():
    """d_x, conv_offset's and the kernel's gradients within 1e-4 relative
    L2 of ``jax.grad``; the shape prediction's exactly 0 on both sides."""
    (x, shape, cot), _, (gp, gx, gs), port = adaption_pair()
    port = copy.deepcopy(port)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    st = torch.from_numpy(shape).permute(0, 3, 1, 2).requires_grad_()
    out = port(xt, st)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    assert st.grad is None or not st.grad.any()
    assert not np.asarray(gs).any()
    pairs = [(xt.grad.permute(0, 2, 3, 1).numpy(), gx),
             (port.conv_offset.weight.grad.numpy(),
              np.asarray(gp['conv_offset']['kernel']).transpose(3, 2, 0, 1)),
             (port.conv_adaption.weight.grad.numpy(),
              np.asarray(gp['weight']).transpose(3, 2, 0, 1))]
    for got, ref in pairs:
        assert np.abs(ref).max() > 0
        assert rel_l2(got, ref) < 1e-4, rel_l2(got, ref)


def test_window_parts_from_the_unbounded_dcn_3au():
    """3au: ``FeatureAdaption`` clips its displacements to ±3 as JAX does;
    the unbounded (mmcv) form on the same offsets is over 1e-2 relative L2
    away."""
    from dynamask_torch.ops.deform_conv import deform_conv2d_exact
    from dynamask_torch.models.layers import to_nhwc
    (x, shape, _), ref, _, port = adaption_pair()
    with torch.no_grad():
        off = to_nhwc(port.conv_offset(torch.from_numpy(shape).permute(
            0, 3, 1, 2)))
        w = port.conv_adaption.weight.permute(2, 3, 1, 0)
        exact = torch.relu(deform_conv2d_exact(torch.from_numpy(x), off, w,
                                               None, 3, 1, 1, 1, 4))
    assert rel_l2(exact.numpy(), ref) > 1e-2


# -- location targets ---------------------------------------------------------


@pytest.mark.parametrize('lvl', range(5))
def test_loc_targets_match_jax(lvl):
    """Targets and weights of every level exactly as JAX's, 12 random GTs
    (two invalid) of sizes over all levels, on a non-square level."""
    from dynamask_tpu.models.guided_anchor import ga_loc_targets_level as jt
    from dynamask_torch.models.guided_anchor import ga_loc_targets_level
    rng = np.random.RandomState(lvl)
    wh = np.exp(rng.uniform(np.log(12), np.log(400), (12, 2)))
    xy = rng.uniform(0, 600, (12, 2))
    gts = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    valid = np.arange(12) < 10
    strides = np.array([8., 16., 32., 64., 128.], np.float32)
    size = (int(math.ceil(600 / strides[lvl])), int(math.ceil(800 /
                                                              strides[lvl])))
    ref = jt(jnp.asarray(gts), jnp.asarray(valid), lvl, 5, size,
             jnp.asarray(strides), 32.0, 0.2, 0.5)
    got = ga_loc_targets_level(torch.from_numpy(gts), torch.from_numpy(valid),
                               lvl, 5, size, torch.from_numpy(strides), 32.0,
                               0.2, 0.5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1] == 0.1).any()


# -- the detectors ------------------------------------------------------------

TEST_KEYS = ('image', 'img_shape', 'scale_factor')


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    """Dets (proposals on GA-RPN), labels and validity slot for slot on two
    images, one at a non-unit scale factor; the location filter drops
    some positions and keeps others."""
    det, variables, port = twin(kind)
    batch = {k: _demo(2)[k] for k in TEST_KEYS}
    batch['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = port.simple_test({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    assert ref['det_valid'].sum() >= 4
    with torch.no_grad():
        feats = port.extract_feat(port.images(
            {k: torch.from_numpy(v) for k, v in batch.items()}))
        head = port.bbox_head if kind == 'retina' else port.rpn_head
        keep = torch.cat([torch.sigmoid(lp).flatten() for lp in
                          head(feats)[3]]) >= port.loc_filter_thr
    assert 0 < int(keep.sum()) < keep.numel()


@functools.lru_cache(maxsize=None)
def train_step(kind):
    """One training step's logs and gradients on both sides, from the same
    variables and draws (the shape sampler's, its own rows for each image,
    the RPN's and the RoI head's); the JAX gradients in the port's layout
    through the key map. The shape sampler keeps ``GA_SAMPLES`` squares an
    image, so its draws pick which of an image's positives train."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(kind)
    det = det.clone(ga_sample_num=GA_SAMPLES)
    port = copy.deepcopy(port).train()
    port.ga_sample_num = GA_SAMPLES
    batch = _demo(2)
    na = n_squares(kind)
    rng = np.random.RandomState(15)
    # image 1's draws rank its squares the other way round from image 0's
    ga = [np.stack([r, 1 - r]).astype(np.float32)
          for r in (rng.uniform(size=na), rng.uniform(size=na))]
    tables = {n: rng.uniform(size=n).astype(np.float32) for n in (na, G + P)}

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0),
                                    'sampler': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with ga_draws(*ga), jax_sampler_priorities(tables):
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables.get('batch_stats', {}),
            {k: jnp.asarray(x) for k, x in batch.items()})
    noise = {'ga_pos': ga[0], 'ga_neg': ga[1],
             'rpn': np.stack([tables[na]] * 2),
             'rcnn': np.stack([tables[G + P]] * 2)}
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()},
        {k: torch.from_numpy(v) for k, v in noise.items()}))
    total.backward()
    got = _port_grads(port)
    with torch.no_grad():      # image 0's shape draws for both images
        _, row0 = parse_losses(port.forward_train(
            {k: torch.from_numpy(x) for k, x in batch.items()},
            {k: torch.from_numpy(v) for k, v in dict(
                noise, ga_pos=np.stack([ga[0][0]] * 2),
                ga_neg=np.stack([ga[1][0]] * 2)).items()}))
    jax_grads = jax.device_get(jax_grads)
    hints = key_hints(port)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k, **hints))
           for k in got}
    frozen = {k for k, p in port.named_parameters() if not p.requires_grad}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax.device_get(jax_log).items()},
            got, ref, frozen, {k: float(v) for k, v in row0.items()})


LOSS_KEYS = {
    'retina': {'loss_cls', 'loss_bbox', 'loss_shape', 'loss_loc'},
    'rpn': {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_anchor_shape',
            'loss_anchor_loc'},
    'faster': {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_anchor_shape',
               'loss_anchor_loc', 'loss_cls', 'loss_bbox', 'acc'}}


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    """Every loss within 1e-4 relative of JAX's, the draws injected; the
    shape and location losses and the box regression non-zero; the shape
    loss reads each image's own draws (image 0's for both gives another,
    off by more than the tolerance)."""
    port_log, jax_log, _, _, _, row0 = train_step(kind)
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    assert keys == LOSS_KEYS[kind] | {'loss'} and keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    shape = 'loss_shape' if kind == 'retina' else 'loss_anchor_shape'
    box = 'loss_bbox' if kind == 'retina' else 'loss_rpn_bbox'
    assert jax_log[shape] > 0 and jax_log[box] > 0
    assert abs(row0[shape] - jax_log[shape]) > 10 * LOSS_RTOL * jax_log[shape]


@pytest.mark.parametrize('kind', KINDS)
def test_per_leaf_gradients(kind):
    """Every parameter within 1e-3 relative L2 of JAX's gradient; the
    frozen stem and stage 1 get none on either side; each
    ``FeatureAdaption``'s offset conv and kernel, and the shape and
    location convs, get some."""
    _, _, got, ref, frozen, _ = train_step(kind)
    compared, seen = 0, set()
    for k in ref:
        if k in frozen or not ref[k].any():
            assert not got[k].any() and (k not in frozen or
                                         not ref[k].any()), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
        compared += 1
        seen |= {s for s in ('conv_offset', 'conv_adaption', 'conv_shape',
                             'conv_loc') if s in k}
    assert frozen and compared >= 40, (len(frozen), compared)
    assert seen == {'conv_offset', 'conv_adaption', 'conv_shape',
                    'conv_loc'}, seen


# -- the JAX faults and the builders' refusals --------------------------------

CONFIGS = os.path.join(ROOT, 'configs', 'guided_anchoring')


def _config(name):
    from dynamask_torch.utils.config import Config
    return Config.fromfile(os.path.join(CONFIGS, name)).to_dict()


def _meta(cfg):
    from dynamask_torch.models import build_detector
    return build_detector(cfg['model'], cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')


def test_ga_rpn_unit_stds_3aq():
    """3aq: GA-Faster and GA-RPN decode the shape deltas with unit stds
    (JAX ``guided_anchor.py:544, :626``) whatever ``anchor_coder`` says
    (0.07, 0.07, 0.14, 0.14 in every file): the port's guided anchors are
    JAX's ``_guided``, and the config's stds would give others."""
    from dynamask_tpu.models.guided_anchor import GAFasterRCNN as JGA
    from dynamask_torch.core.bbox_transforms import delta2bbox
    cfg = _config('ga_faster_r50_fpn_1x_coco.py')
    assert cfg['model']['rpn_head']['anchor_coder']['target_stds'] == [
        0.07, 0.07, 0.14, 0.14]
    port = _meta(cfg)
    assert port.shape_stds == (1., 1., 1., 1.)
    assert port.target_stds == (0.07, 0.07, 0.11, 0.11)
    rng = np.random.RandomState(0)
    squares = np.array([[0., 0., 32., 32.], [16., 8., 80., 72.]], np.float32)
    shape = rng.normal(size=(1, 2, 1, 2)).astype(np.float32)
    ref = JGA._guided(None, jnp.asarray(squares),
                      [jnp.asarray(shape.transpose(0, 2, 3, 1))], 1)
    got = port.guided_anchors(torch.from_numpy(squares),
                              [torch.from_numpy(shape)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    flat = torch.from_numpy(shape).permute(0, 2, 3, 1).reshape(1, -1, 2)
    coder = delta2bbox(torch.from_numpy(squares), torch.cat(
        [torch.zeros_like(flat), flat], -1), (0.,) * 4, (0.07, 0.07, 0.14,
                                                         0.14))
    assert (coder - got).abs().max() > 1.0


def test_valid_flags_of_image_0_3ar():
    """3ar: one set of square valid flags, image 0's, serves the batch (JAX
    ``guided_anchor.py:298, :597``): the GA-RetinaNet step's losses do not
    move when image 1's ``img_shape`` shrinks, on either side, though its
    own flags would drop squares."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    det, variables, port = twin('retina')
    batch = _demo(2)
    small = dict(batch, img_shape=batch['img_shape'].copy())
    small['img_shape'][1] = [24., 40.]
    logs = []
    with ga_draws(np.full(86, 0.5, np.float32),
                  np.linspace(0, 1, 86, dtype=np.float32)):
        step = jax.jit(lambda v, b: jparse(det.apply(
            v, b, method='forward_train', mutable=['batch_stats'])[0])[1])
        for b in (batch, small):
            logs.append({k: float(v) for k, v in step(
                variables, {k: jnp.asarray(v) for k, v in b.items()}).items()})
    assert logs[0] == logs[1]
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    own = port.square_valid(sizes, torch.from_numpy(small['img_shape'][1:]))
    shared = port.square_valid(sizes, torch.from_numpy(small['img_shape']))
    assert shared.all() and not own.all()
    noise = {'ga_pos': torch.full((2, 86), 0.5),
             'ga_neg': torch.linspace(0, 1, 86).expand(2, -1)}
    with torch.no_grad():
        got = [port.forward_train({k: torch.from_numpy(v)
                                   for k, v in b.items()}, noise)
               for b in (batch, small)]
    for k in got[0]:
        assert float(got[0][k]) == float(got[1][k]), k


def test_guided_anchor_wh_clip_3as():
    """3as: the guided anchors' width and height are clipped at
    ``exp(|log(16 / 1000)|)`` times the square's, the coders' clip (JAX
    ``core/bbox_transforms.py:84-88``), where mmdet decodes them with
    ``wh_ratio_clip=1e-6``: a shape delta of 6 gives 62.5x, not e^6x."""
    from dynamask_tpu.models.guided_anchor import GAFasterRCNN as JGA
    port = _meta(_config('ga_rpn_r50_fpn_1x_coco.py'))
    squares = np.array([[0., 0., 32., 32.]], np.float32)
    shape = np.full((1, 2, 1, 1), 6.0, np.float32)
    ref = JGA._guided(None, jnp.asarray(squares),
                      [jnp.asarray(shape.transpose(0, 2, 3, 1))], 1)
    got = port.guided_anchors(torch.from_numpy(squares),
                              [torch.from_numpy(shape)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    w = float(got[0, 0, 2] - got[0, 0, 0])
    assert abs(w / 32.0 - 62.5) < 1e-3 and w < 32.0 * math.exp(6) / 5


@pytest.mark.parametrize('name,where,edit', [
    ('ga_rpn_r50_fpn_1x_coco.py', 'rpn_head.anchor_coder',
     lambda c: c['model']['rpn_head']['anchor_coder'].update(
         target_means=[0.1, 0., 0., 0.])),
    ('ga_rpn_r50_fpn_1x_coco.py', 'loss_loc',
     lambda c: c['model']['rpn_head']['loss_loc'].update(gamma=3.0)),
    ('ga_rpn_r50_fpn_1x_coco.py', 'square_anchor_generator',
     lambda c: c['model']['rpn_head']['square_anchor_generator'].update(
         scales=[4])),
    ('ga_rpn_r50_fpn_1x_coco.py', 'test_cfg.rpn max_num',
     lambda c: c['test_cfg']['rpn'].update(max_num=300)),
    ('ga_faster_r50_fpn_1x_coco.py', 'ga_sampler',
     lambda c: c['train_cfg']['rpn']['ga_sampler'].update(
         add_gt_as_proposals=True)),
    ('ga_faster_r50_fpn_1x_coco.py', 'loss_shape',
     lambda c: c['model']['rpn_head']['loss_shape'].update(loss_weight=2.)),
    ('ga_retinanet_r50_fpn_1x_coco.py', 'bbox_coder',
     lambda c: c['model']['bbox_head']['bbox_coder'].update(
         target_stds=[0.1, 0.1, 0.2, 0.2])),
    ('ga_retinanet_r50_fpn_1x_coco.py', 'loss_cls',
     lambda c: c['model']['bbox_head']['loss_cls'].update(alpha=0.5)),
    ('ga_retinanet_r50_fpn_1x_coco.py', 'ga_assigner',
     lambda c: c['train_cfg']['ga_assigner'].update(ignore_iof_thr=0.5)),
])
def test_ga_keys_refused(name, where, edit):
    """A GA key JAX drops or fixes, at another value than it computes
    with, is refused (3w); the file as it is builds."""
    cfg = _config(name)
    _meta(cfg)
    edit(cfg)
    with pytest.raises(NotImplementedError, match='3w'):
        _meta(cfg)


@pytest.mark.parametrize('name,cls', [
    ('ga_rpn_r50_fpn_1x_coco.py', 'GARPN'),
    ('ga_faster_r50_fpn_1x_coco.py', 'GAFasterRCNN'),
    ('ga_retinanet_r50_fpn_1x_coco.py', 'GARetinaNet')])
def test_phase17_config_keys_through_the_jax_importer(name, cls):
    """Each GA config of ``chip_smoke.py`` phase 17 builds as its detector
    on the CPU, the options as JAX's builder reads them, and every
    state-dict key maps to a JAX path (the heads' keys that the JAX
    importer has no rule for among them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    cfg = _config(name)
    port = _meta(cfg)
    assert type(port).__name__ == cls
    jdet = jax_build(cfg['model'], cfg.get('train_cfg'), cfg.get('test_cfg'))
    if cls != 'GARetinaNet':
        assert port.rpn_max_num == jdet.rpn_max_num
        assert port.rpn_nms_pre_test == jdet.rpn_nms_pre_test
        assert port.rpn_beta == jdet.rpn_beta
        assert port.target_stds == jdet.target_stds
    else:
        assert port.shape_stds == jdet.target_stds
        assert port.smoothl1_beta == jdet.smoothl1_beta
    assert port.loc_filter_thr == jdet.loc_filter_thr
    assert port.ga_sample_num == jdet.ga_sample_num
    hints = key_hints(port)
    keys = [k for k in port.state_dict() if 'num_batches' not in k]
    assert all(mmdet_key(k, **hints) for k in keys)
    assert any('feature_adaption' in k for k in keys)


def test_jax_importer_skips_the_ga_heads_3ax():
    """3ax: the JAX importer (``dynamask_tpu/engine/pretrained.py:120``)
    has no rule for guided anchoring's head keys: an mmdet GA-RPN or
    GA-RetinaNet checkpoint leaves ``conv_loc``, ``conv_shape``, the
    ``FeatureAdaption`` convs (and GA-RetinaNet's towers and output convs,
    3aa) at init; every other key it maps where the port's key map does
    (but the FPN's extra convs, 3aa)."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    for name, head in (('ga_rpn_r50_fpn_1x_coco.py', 'rpn_head.'),
                       ('ga_retinanet_r50_fpn_1x_coco.py', 'bbox_head.')):
        port = _meta(_config(name))
        hints = key_hints(port)
        skipped = set()
        for k in port.state_dict():
            if k.endswith('num_batches_tracked'):
                continue
            ref = _mmdet_key(k)
            if ref is None:
                skipped.add(k)
            elif not k.startswith('neck.fpn_convs.'):
                assert (ref[0], ref[1]) == mmdet_key(k, **hints)[:2], k
        assert skipped and all(k.startswith(head) for k in skipped)
        assert any('feature_adaption' in k for k in skipped)
        assert any('conv_shape' in k for k in skipped)
