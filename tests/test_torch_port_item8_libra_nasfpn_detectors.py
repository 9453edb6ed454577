"""Libra R-CNN and NAS-FPN toys on the CPU: the PyTorch port against the
JAX package on the same seeded inputs and draws, the JAX weights carried
across by ``dynamask_torch.engine.convert``; the modules are held in
``tests/test_torch_port_item8_libra_nasfpn.py``.

- Toys from the config files at toy width: Libra Faster R-CNN (the mini
  Faster R-CNN with Libra's neck, sampler and loss, 2 images at 64x64),
  Libra RetinaNet and NAS-FPN RetinaNet (at 128x128: its P7 needs P3 at 16
  or more; 1 of the file's 7 stacks, ``tests/test_torch_port_item8_libra_
  nasfpn.py`` holds the neck's 7): ``simple_test`` slot for slot (dets
  within 1e-4 of the largest coordinate) and one ``forward_train`` in
  float64 on both sides (JAX under ``jax_enable_x64``) with the draws
  injected: the RetinaNets' losses within 1e-10 relative and gradients
  within 1e-8 relative L2; Libra Faster R-CNN's within 1e-7 and 1e-5, as
  JAX takes its proposals in fp32 (``STEP_TOL``).
- The JAX faults 3bn (the RPN's ``neg_pos_ub`` dropped), 3bo (the NAS-FPN
  file's head keeps its BatchNorm) and the importer's gaps (3bl).
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
from test_torch_port_item8_libra_nasfpn import (  # noqa: E402
    COMBINED, DRAW_NAMES, LIBRA_NECK, _tables, jax_named_draws)
from test_torch_port_item6_ssd import draw_variables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = 3
P = 32
DET_RTOL = 1e-4
# one step in float64 on both sides: (losses' relative, gradients' relative
# L2) tolerance. JAX stays in float64 on the RetinaNets; it takes the
# two-stage proposals in fp32 (a float32 scatter), which rounds the RoI
# head's losses and the gradients to ~1e-8 and ~1e-6
STEP_TOL = {'libra_faster': (1e-7, 1e-5), 'libra_retina': (1e-10, 1e-8),
            'nasfpn': (1e-10, 1e-8)}
# the zeros of the math (a softmax's invariance to a bias added to every
# key): held against this fraction of the largest gradient's norm
GRAD_FLOOR = 1e-9
NAS_STACKS = 1


# -- toy detectors ------------------------------------------------------------

def libra_faster_cfg():
    """The mini Faster R-CNN with Libra R-CNN's FPN + BFP, balanced L1 box
    loss, combined sampler and the RPN sampler's ``neg_pos_ub`` 5."""
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    model['type'] = 'FasterRCNN'
    rh = model['roi_head']
    rh.pop('mask_head')
    rh.pop('mask_roi_extractor')
    rh['bbox_head']['loss_bbox'] = dict(type='BalancedL1Loss', alpha=0.5,
                                        gamma=1.5, beta=1.0, loss_weight=1.0)
    model['neck'] = copy.deepcopy(LIBRA_NECK)
    train_cfg['rpn']['sampler']['neg_pos_ub'] = 5
    train_cfg['rcnn']['sampler'] = dict(COMBINED)
    return model, train_cfg, test_cfg


def retina_cfg(kind):
    """Libra RetinaNet or NAS-FPN RetinaNet from its file at toy width."""
    from dynamask_torch.utils.config import Config
    path = {'libra_retina': 'configs/libra_rcnn/libra_retinanet_r50_fpn_1x_'
                            'coco.py',
            'nasfpn': 'configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_'
                      'coco.py'}[kind]
    cfg = copy.deepcopy(Config.fromfile(os.path.join(ROOT, path)).to_dict())
    m = cfg['model']
    m.pop('pretrained', None)
    m['backbone']['depth'] = 18
    if kind == 'nasfpn':
        m['neck'].update(in_channels=[128, 256, 512], out_channels=32,
                         stack_times=NAS_STACKS)
    else:
        m['neck'][0].update(in_channels=[64, 128, 256, 512], out_channels=32)
        m['neck'][1].update(in_channels=32)
    m['bbox_head'].update(in_channels=32, feat_channels=32, stacked_convs=2,
                          num_classes=8)
    cfg['test_cfg'].update(nms_pre=50, max_per_img=20)
    return m, cfg['train_cfg'], cfg['test_cfg']


SIDES = {'libra_faster': 64, 'libra_retina': 64, 'nasfpn': 128}


def _demo(kind, b=2):
    from test_models import demo_batch
    s = SIDES[kind]
    return {k: np.array(v) for k, v in demo_batch(
        0, b=b, h=s, w=s, g=G, s=16).items()}


@functools.lru_cache(maxsize=None)
def twin(kind):
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = libra_faster_cfg() if kind == 'libra_faster' else retina_cfg(kind)
    det = jax_build(*copy.deepcopy(cfg))
    variables = draw_variables(det, _demo(kind, 1))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


KINDS = ('libra_faster', 'libra_retina', 'nasfpn')


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    det, variables, port = twin(kind)
    batch = {k: _demo(kind)[k] for k in ('image', 'img_shape', 'ori_shape',
                                         'scale_factor')}
    batch['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert (ref['det_valid'].sum(1) >= 3).all()
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    scale = np.abs(ref['dets'][..., :4]).max()
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=0,
                               atol=DET_RTOL * scale)


@functools.lru_cache(maxsize=None)
def train_step(kind):
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(kind)
    port = copy.deepcopy(port).double().train()
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in _demo(kind).items()}
    n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    tables = {**_tables(G + P), ('', n_anchors): np.random.RandomState(
        13).uniform(size=n_anchors).astype(np.float32)}

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax.enable_x64(True), jax_named_draws(tables):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), variables)
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            v64['params'], v64.get('batch_stats', {}),
            {k: jnp.asarray(x) for k, x in batch.items()})
        jax_log, jax_grads = jax.device_get((jax_log, jax_grads))
    noise = {'rpn': torch.from_numpy(np.tile(tables[('', n_anchors)],
                                             (2, 1)))}
    for name in ('101', '101/1', '202'):
        noise['rcnn_' + DRAW_NAMES[name]] = torch.from_numpy(
            np.tile(tables[(name, G + P)], (2, 1)))
    with counted_crops() as crops:
        total, log = parse_losses(port.forward_train(
            {k: torch.from_numpy(x) for k, x in batch.items()}, noise))
        total.backward()
    got = _port_grads(port)
    hints = key_hints(port)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k, **hints))
           for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax_log.items()}, got, ref,
            dict(crops))


@pytest.mark.parametrize('kind', KINDS)
def test_train_step(kind):
    """Every loss and every gradient within ``STEP_TOL`` of JAX's in
    float64 (BFP's non-local convs and NAS-FPN's cells among them); Libra
    Faster R-CNN's step takes one crop forward and one backward."""
    loss_rtol, grad_rl2 = STEP_TOL[kind]
    got, ref, grads, ref_grads, crops = train_step(kind)
    keys = {k for k in ref if 'loss' in k or k.endswith('acc')}
    assert keys <= set(got) and len(keys) >= 3
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], ref[k], rtol=loss_rtol,
                                   atol=1e-12, err_msg=k)
    norms = {k: np.linalg.norm(v) for k, v in ref_grads.items()}
    floor = GRAD_FLOOR * max(norms.values())
    worst = max((np.linalg.norm(grads[k] - r) / max(norms[k], floor), k)
                for k, r in ref_grads.items())
    assert worst[0] < grad_rl2, worst
    neck = [k for k in ref_grads if k.startswith(('neck.1.', 'neck.fpn_'))]
    assert kind == 'libra_faster' or any(norms[k] > floor for k in neck)
    if kind == 'libra_faster':
        assert crops == {'fwd': 1, 'bwd': 1}


def test_rpn_neg_pos_ub_dropped_3bn():
    """3bn: Libra's ``train_cfg.rpn.sampler.neg_pos_ub=5`` is dropped by the
    JAX builder (its RPN samples by ``num`` and ``pos_fraction`` alone):
    the port builds the file with the RPN's sampler uncapped, while a
    capped RoI ``RandomSampler`` (which JAX drops too) is refused."""
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py'))
    assert cfg.train_cfg.rpn.sampler.neg_pos_ub == 5
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           device='meta')
    assert model.rpn_sampler.neg_pos_ub == -1
    model, tr, te = libra_faster_cfg()
    tr['rcnn']['sampler'] = dict(type='RandomSampler', num=32,
                                 pos_fraction=0.25, neg_pos_ub=3)
    with pytest.raises(NotImplementedError, match='neg_pos_ub'):
        build_detector(model, tr, te, device='meta')


def test_sepbn_no_norm_keeps_batchnorm_3bo():
    """3bo: the NAS-FPN file's ``RetinaSepBNHead`` says ``norm_cfg=None``,
    which the JAX builder drops: its head has BatchNorm and bias-free tower
    convs whatever the config says; the port builds that form."""
    from dynamask_torch.models import build_detector
    model = build_detector(*retina_cfg('nasfpn'), device='meta')
    conv = model.bbox_head.cls_convs[0][0]
    assert hasattr(conv, 'bn') and conv.conv.bias is None
    _, variables, _ = twin('nasfpn')
    assert {'cls_bn_0_0', 'reg_bn_4_1'} <= set(
        variables['batch_stats']['bbox_head'])


def test_jax_importer_skips_bfp_and_nasfpn_3bl():
    """3bl: the JAX importer skips Libra's chained neck (``neck.0.`` and
    BFP's ``neck.1.refine.``) and NAS-FPN's laterals, extra convs and
    cells (it reads ``neck.lateral_convs`` as an FPN's ``lateral_{i}``,
    which NAS-FPN names ``lateral_conv_{i}``); the port's key map carries
    them both ways."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    for kind in ('libra_retina', 'nasfpn'):
        _, variables, port = twin(kind)
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        _, _, report = convert_torch_weights(sd, variables['params'],
                                             variables['batch_stats'])
        neck = sorted(k for k in sd if k.startswith('neck.'))
        assert neck and not set(neck) & set(report['loaded'])
        hints = key_hints(port)
        assert all(mmdet_key(k, **hints) is not None for k in sd
                   if not k.endswith('num_batches_tracked'))
