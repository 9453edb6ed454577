"""DeformRoIPool on the CPU: the PyTorch port against the JAX package on the
same seeded inputs, the JAX weights carried across by
``dynamask_torch.engine.convert``.

- ``ops.roi_pool.deform_roi_pooling`` against JAX's (XLA) on one level:
  without offsets, with offsets, with RoIs partly off the map and one
  whose samples reach the map's far edge; the feature and offset
  gradients against ``jax.grad``. ``multilevel_deform_roi_pool``, which
  pools each RoI on its routed level only, against JAX's dense form (every
  level pooled, the routed one kept), forward and gradients. The quantised
  ``roi_pool``. fp32, within 1e-5 relative L2 (gradients 1e-4).
- Both extractors (``DeformRoIPoolPack``, ``ModulatedDeformRoIPoolPack``)
  inside the toy Faster R-CNN (the mini Mask R-CNN of
  ``tests/test_models.py`` without its mask branch): ``simple_test`` slot
  for slot (dets within 1e-4 of the largest coordinate) and one
  ``forward_train`` with the samplers' draws injected (every loss within
  1e-4 relative, every gradient within 1e-3 relative L2), no K2 / K4 on
  the box branch.
- The two config files built as JAX builds them, every key mapped both
  ways; 3bt: the JAX extractor's tree against mmdet's (one offset branch
  for every level; the modulated mask on its hidden layer), an mmdet
  tensor refused by name on load.
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

from test_torch_port_cascade import _port_grads, counted_crops  # noqa: E402
from test_torch_port_item6_ssd import draw_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ANCHORS = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
G = 3
P = 32
DET_RTOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
DPOOL_FILES = {'dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py': False,
               'dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py': True}

# RoIs (image, x1, y1, x2, y2) at a 1/4 scale on 2 x 9 x 11 maps: inside,
# partly off the top-left and the bottom-right, reaching past the far
# edge, one tiny
ROIS = np.array([[0, 4.0, 6.0, 30.0, 28.0], [1, -12.0, -9.0, 14.0, 10.0],
                 [0, 20.0, 12.0, 60.0, 50.0], [1, 2.5, 3.5, 44.0, 36.0],
                 [1, 10.0, 10.0, 12.0, 11.0]], np.float32)


def _inputs(seed=6, c=5):
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 9, 11, c).astype(np.float32)
    offsets = rng.uniform(-2.5, 2.5, (len(ROIS), 7, 7, 2)).astype(np.float32)
    return feats, offsets


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


@pytest.mark.parametrize('with_offsets', [False, True])
def test_deform_roi_pooling(with_offsets):
    """One level at scale 1/4, sample_per_part 4, trans_std 0.1: the
    pooled bins within 1e-5 relative L2 of JAX's; with offsets, the
    feature and offset gradients of a weighted sum within 1e-4 of
    ``jax.grad``'s. The RoIs partly off the map average over their
    in-bounds samples alone."""
    from dynamask_tpu.ops.roi_pool import deform_roi_pooling as jpool
    from dynamask_torch.ops.roi_pool import deform_roi_pooling
    feats, offsets = _inputs()
    rois, rb = ROIS[:, 1:], ROIS[:, 0].astype(np.int32)
    w = np.random.RandomState(7).randn(len(ROIS), 7, 7, 5).astype(np.float32)

    def jfn(f, o):
        out = jpool(f, jnp.asarray(rois), jnp.asarray(rb), o, out_size=7,
                    spatial_scale=0.25, no_trans=not with_offsets)
        return jnp.sum(out * w), out

    (_, ref), (gf, go) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(offsets))
    f, o = _t(feats, True), _t(offsets, with_offsets)
    got = deform_roi_pooling(f, _t(rois), _t(rb).long(),
                             o if with_offsets else None, out_size=7,
                             spatial_scale=0.25)
    assert rel_l2(got.detach().numpy(), np.asarray(ref)) < 1e-5
    (got * _t(w)).sum().backward()
    assert rel_l2(f.grad.numpy(), np.asarray(gf)) < 1e-4
    if with_offsets:
        assert rel_l2(o.grad.numpy(), np.asarray(go)) < 1e-4
    # the RoI off the top-left: its first bins see no in-bounds sample
    assert np.asarray(ref)[1, 0, 0].any() == got[1, 0, 0].detach().any()


def test_multilevel_routed_against_dense():
    """Four levels (strides 4-32), RoIs of every routed level: the port's
    per-RoI gather on its own level against JAX's every-level pooling,
    forward and the gradients of the levels and the offsets."""
    from dynamask_tpu.ops.roi_pool import multilevel_deform_roi_pool as jml
    from dynamask_torch.ops.roi_pool import multilevel_deform_roi_pool
    rng = np.random.RandomState(8)
    feats = [rng.randn(2, 64 // s, 48 // s, 4).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rois = np.array([[2, 3, 30, 25], [0, 0, 63, 47], [10, 5, 130, 120],
                     [30, 20, 50, 40], [-5, -5, 250, 240], [4, 4, 9, 12]],
                    np.float32)
    rb = np.array([0, 1, 1, 0, 0, 1], np.int32)
    offsets = rng.uniform(-1.5, 1.5, (6, 7, 7, 2)).astype(np.float32)
    w = rng.randn(6, 7, 7, 4).astype(np.float32)

    def jfn(fs, o):
        out = jml(list(fs), jnp.asarray(rois), jnp.asarray(rb), 7,
                  (4, 8, 16, 32), offsets=o)
        return jnp.sum(out * w), out

    (_, ref), (gfs, go) = jax.value_and_grad(jfn, argnums=(0, 1),
                                             has_aux=True)(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(offsets))
    fs = [_t(f, True) for f in feats]
    o = _t(offsets, True)
    got = multilevel_deform_roi_pool(fs, _t(rois), _t(rb).long(), 7,
                                     (4, 8, 16, 32), offsets=o)
    assert rel_l2(got.detach().numpy(), np.asarray(ref)) < 1e-5
    (got * _t(w)).sum().backward()
    for f, g in zip(fs, gfs):
        assert rel_l2(f.grad.numpy(), np.asarray(g)) < 1e-4
    assert rel_l2(o.grad.numpy(), np.asarray(go)) < 1e-4
    # the routing reached more than one level
    assert sum(bool(f.grad.abs().sum()) for f in fs) >= 3


def test_roi_pool_quantised_max():
    """The quantised max of every bin (an empty one 0) equals JAX's."""
    from dynamask_tpu.ops.roi_pool import roi_pool as jpool
    from dynamask_torch.ops.roi_pool import roi_pool
    feats, _ = _inputs(c=3)
    rois, rb = ROIS[:, 1:], ROIS[:, 0].astype(np.int32)
    ref = np.asarray(jpool(jnp.asarray(feats), jnp.asarray(rois),
                           jnp.asarray(rb), out_size=7, spatial_scale=0.25))
    got = roi_pool(_t(feats), _t(rois), _t(rb).long(), 7, 0.25)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any() and (ref != 0).any()


# -- the toy Faster R-CNN with DeformRoIPool ---------------------------------

def dpool_toy_cfg(modulated):
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    model['type'] = 'FasterRCNN'
    rh = model['roi_head']
    rh.pop('mask_head')
    rh.pop('mask_roi_extractor')
    rh['bbox_roi_extractor']['roi_layer'] = dict(
        type='ModulatedDeformRoIPoolPack' if modulated else
        'DeformRoIPoolPack', output_size=7, output_channels=32)
    return model, train_cfg, test_cfg


def _demo(b=1):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(
        0, b=b, h=64, w=64, g=G, s=16).items()}


@functools.lru_cache(maxsize=None)
def twin(modulated):
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = dpool_toy_cfg(modulated)
    det = jax_build(*copy.deepcopy(cfg))
    variables = draw_variables(det, _demo())
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


@pytest.mark.parametrize('modulated', [False, True])
def test_simple_test(modulated):
    det, variables, port = twin(modulated)
    assert type(port.roi_head.bbox_roi_extractor).__name__ == \
        'DeformRoIPoolPack'
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch = {k: _demo(2)[k] for k in keys}
    batch['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad(), counted_crops() as crops:
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert crops == {'fwd': 0, 'bwd': 0}
    assert (ref['det_valid'].sum(1) >= 3).all()
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    scale = np.abs(ref['dets'][..., :4]).max()
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=0,
                               atol=DET_RTOL * scale)


@functools.lru_cache(maxsize=None)
def train_step(modulated):
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(modulated)
    port = copy.deepcopy(port).train()
    batch = _demo()
    rng = np.random.RandomState(14)
    tables = {n: rng.uniform(size=n).astype(np.float32)
              for n in (N_ANCHORS, G + P)}

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax_sampler_priorities(tables):
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables.get('batch_stats', {}),
            {k: jnp.asarray(x) for k, x in batch.items()})
    noise = {'rpn': torch.from_numpy(tables[N_ANCHORS][None]),
             'rcnn': torch.from_numpy(tables[G + P][None])}
    with counted_crops() as crops:
        total, log = parse_losses(port.forward_train(
            {k: torch.from_numpy(x) for k, x in batch.items()}, noise))
        total.backward()
    got = _port_grads(port)
    jax_grads = jax.device_get(jax_grads)
    hints = key_hints(port)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k, **hints))
           for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax.device_get(jax_log).items()},
            got, ref, dict(crops))


@pytest.mark.parametrize('modulated', [False, True])
def test_train_step(modulated):
    """Every loss within 1e-4 of JAX's, every parameter's gradient within
    1e-3 relative L2, the offset branch's (and the modulated mask's) among
    them; the box crop is the deform pool's, not K2's."""
    port_log, jax_log, got, ref, crops = train_step(modulated)
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    assert keys == {'loss_cls', 'loss_bbox', 'acc', 'loss_rpn_cls',
                    'loss_rpn_bbox', 'loss'}
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
    ext = 'roi_head.bbox_roi_extractor.'
    for k in ('offset_fc.0.weight', 'offset_fc.4.weight') + (
            ('mask_fc.weight',) if modulated else ()):
        assert ref[ext + k].any(), k
    assert crops == {'fwd': 0, 'bwd': 0}


@pytest.mark.parametrize('rel', sorted(DPOOL_FILES))
def test_dpool_configs_and_key_map(rel):
    """Each file builds as JAX builds it (its options read, the offset
    branch 7 x 7 x 256 -> 1024 -> 1024 -> 98, the modulated file's mask
    fc 1024 -> 49), on the CPU from its seeded init every JAX leaf of the
    extractor reached by the key map and every port key mapped."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', rel))
    port = build_detector(cfg['model'], cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')
    ext = port.roi_head.bbox_roi_extractor
    jext = jax_build(cfg['model'], cfg.get('train_cfg'),
                     cfg.get('test_cfg')).roi_head.bbox_extractor_obj
    assert (ext.modulated, ext.trans_std, ext.sample_per_part,
            ext.featmap_strides, ext.out_size) == (
        jext.modulated, jext.trans_std, jext.sample_per_part,
        tuple(jext.featmap_strides), jext.out_size) == (
        DPOOL_FILES[rel], 0.1, 4, (4, 8, 16, 32), 7)
    assert [tuple(m.weight.shape) for m in ext.offset_fc if
            hasattr(m, 'weight')] == [(1024, 12544), (1024, 1024), (98, 1024)]
    assert hasattr(ext, 'mask_fc') == DPOOL_FILES[rel]
    hints = key_hints(port)
    paths = {tuple(mmdet_key(k, **hints)[0]) for k in port.state_dict()
             if k.startswith('roi_head.bbox_roi_extractor.')}
    assert paths == {('roi_head', 'bbox_extractor_obj', n) for n in (
        'offset_fc1', 'offset_fc2', 'offset_out') + (
            ('mask_out',) if DPOOL_FILES[rel] else ())}
    assert all(mmdet_key(k, **hints) for k in port.state_dict()
               if 'num_batches' not in k)


def test_jax_extractor_tree_is_not_mmdets_3bt():
    """3bt: JAX's extractor holds one offset branch for every level and
    the modulated mask as one fc on its hidden layer (``roi_head.py:
    52-80``), where mmdet's ``SingleRoIExtractor`` holds a
    ``ModulatedDeformRoIPoolingPack`` a level (``roi_layers.{i}.``), each
    with its own two-layer ``mask_fc``. The port computes JAX's function
    and refuses an mmdet tensor by name on load."""
    det, variables, port = twin(True)
    tree = variables['params']['roi_head']['bbox_extractor_obj']
    assert sorted(tree) == ['mask_out', 'offset_fc1', 'offset_fc2',
                            'offset_out']
    assert np.shape(tree['mask_out']['kernel']) == (1024, 49)
    state = copy.deepcopy(port).state_dict()
    for key, shape in (
            ('roi_head.bbox_roi_extractor.roi_layers.0.offset_fc.0.weight',
             (1024, 1568)),
            ('roi_head.bbox_roi_extractor.mask_fc.0.weight', (1024, 1568))):
        with pytest.raises(ValueError, match='3bt'):
            copy.deepcopy(port).load_state_dict(
                dict(state, **{key: torch.zeros(shape)}), strict=False)
