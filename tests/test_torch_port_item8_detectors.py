"""Toy twins of the detectors on item 8's backbones and necks, on the CPU:
the PyTorch port against the JAX package on the same seeded inputs, the
JAX weights carried across by ``dynamask_torch.engine.convert``; where JAX
reaches RoIAlign it runs its XLA form.

- Two-stage (the mini Mask R-CNN of ``tests/test_models.py``: 32-channel
  neck, 8 classes, 64x64): Mask R-CNN on HRNet + HRFPN (branches of
  8/16/32/64 channels), on a toy RegNet (four stages, 8 groups) and on
  Res2Net-50; Faster R-CNN on ResNet-18 + PAFPN. ``simple_test`` slot for
  slot; one ``forward_train`` with the sampler draws injected on both
  sides (``rpn`` the anchors' table, ``rcnn`` the G + P candidates'):
  every loss, and every parameter's gradient through the key map.
- FCOS on HRNet + HRFPN at ``stride=2`` (strides 8-128), from
  ``configs/hrnet/fcos_hrnetv2p_w32_gn-head_4x4_1x_coco.py`` at toy
  width: ``simple_test`` and one training step's losses.
- The K2/K4 calls on each two-stage path: one box and one mask extract
  an image, their gradients in a step.

Tolerances as the other twins: dets ``rtol=1e-5, atol=1e-4``, labels and
validity exact; losses 1e-4 relative; gradients 1e-3 relative L2.
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

from test_torch_port_cascade import (_demo, _port_grads,  # noqa: E402
                                     counted_crops)
from test_torch_port_item8_backbones import (TOY_HRNET,  # noqa: E402
                                             TOY_REGNET)
from test_torch_port_modules import fast_jit, randomize_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402
from test_torch_port_two_stage_twins import G, N_ANCHORS, P  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
HRNET = dict(type='HRNet', extra=TOY_HRNET, frozen_stages=1)
HRFPN = dict(type='HRFPN', in_channels=[8, 16, 32, 64], out_channels=32)


def toy_cfg(kind):
    """(model, train_cfg, test_cfg): the mini Mask R-CNN on 'hrnet'
    (HRNet + HRFPN), 'regnet' or 'res2net' (+ FPN), or the mini Faster
    R-CNN on 'pafpn' (ResNet-18 + PAFPN)."""
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    if kind == 'hrnet':
        model['backbone'] = dict(HRNET)
        model['neck'] = dict(HRFPN)
    elif kind == 'regnet':
        model['backbone'] = dict(type='RegNet', arch=TOY_REGNET,
                                 frozen_stages=1, norm_eval=True)
        model['neck']['in_channels'] = [16, 32, 64, 128]
    elif kind == 'res2net':
        model['backbone'] = dict(type='Res2Net', depth=50, scales=4,
                                 base_width=26, frozen_stages=1)
        model['neck']['in_channels'] = [256, 512, 1024, 2048]
    elif kind == 'pafpn':
        model['type'] = 'FasterRCNN'
        model['neck']['type'] = 'PAFPN'
        rh = model['roi_head']
        rh['mask_head'] = rh['mask_roi_extractor'] = None
    return model, train_cfg, test_cfg


# HRNet and RegNet here, Res2Net and PAFPN in
# ``tests/test_torch_port_item8_detectors_res2net_pafpn.py`` (the same
# checks), so that the two halves run side by side
KINDS = ['hrnet', 'regnet']
MASKED = {'hrnet', 'regnet', 'res2net'}


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    jcfg = copy.deepcopy(cfg)
    if kind in ('regnet', 'res2net'):
        # no per-block rematerialisation: the same function, a smaller graph
        jcfg[0]['backbone']['block_remat'] = False
    det = jax_build(*jcfg)
    batch = {k: jnp.asarray(v) for k, v in _demo().items()}
    variables = randomize_variables(
        fast_jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    if kind == 'res2net':
        # each residual branch's last BN scale at a tenth (the init's is 0,
        # zero_init_residual): 16 blocks of random weights at full scale
        # saturate the scores into ties
        for name, block in variables['params']['backbone'].items():
            if 'bn3' in block:
                block['bn3']['scale'] = block['bn3']['scale'] * 0.1
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor')


def check_dets(got, ref):
    """Labels and validity exact, dets within tolerance, enough distinct
    scores that the order is the function's, not a tie's."""
    for i in range(len(ref['det_valid'])):
        assert ref['det_valid'][i].sum() >= 4
        scores = ref['dets'][i, ref['det_valid'][i].astype(bool), 4]
        assert np.min(np.abs(np.diff(np.sort(scores)))) > 1e-6, 'ties'
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


def check_simple_test(kind):
    """Dets, labels, validity and (Mask R-CNNs) 28x28 mask probabilities
    slot for slot, two images with a non-unit scale factor."""
    det, variables, port = twin(kind)
    batch_np = {k: _demo(2)[k] for k in TEST_KEYS}
    batch_np['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch_np.items()})
    check_dets(got, ref)
    assert ('mask_probs' in got) == ('mask_probs' in ref) == (kind in MASKED)
    if kind in MASKED:
        probs = got['mask_probs'].numpy()
        assert probs.shape == (2, 8, 28, 28) and probs.std() > 1e-2
        np.testing.assert_allclose(probs, ref['mask_probs'], atol=2e-4)


@functools.lru_cache(maxsize=None)
def train_step(kind):
    """One training step's logs and gradients on both sides, from the same
    variables and draws; the JAX gradients in the port's layout through
    the port's key map."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(kind)
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
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()},
        {'rpn': torch.from_numpy(tables[N_ANCHORS][None]),
         'rcnn': torch.from_numpy(tables[G + P][None])}))
    total.backward()
    got = _port_grads(port)
    jax_grads = jax.device_get(jax_grads)
    hints = key_hints(port)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k, **hints))
           for k in got}
    frozen = {k for k, p in port.named_parameters() if not p.requires_grad}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax.device_get(jax_log).items()},
            got, ref, frozen)


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    check_train_losses(kind)


def check_train_losses(kind):
    """Every loss key of the step within 1e-4 of JAX's, the sampler
    draws injected; the mask and box losses non-zero."""
    port_log, jax_log, _, _, _ = train_step(kind)
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    want = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss', 'loss_cls',
            'loss_bbox', 'acc'} | ({'loss_mask'} if kind in MASKED else set())
    assert keys == want and keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert jax_log['loss_bbox'] > 0 and jax_log.get('loss_mask', 1) > 0


@pytest.mark.parametrize('kind', KINDS)
def test_per_leaf_gradients(kind):
    check_per_leaf_gradients(kind)


def check_per_leaf_gradients(kind):
    """Every parameter within 1e-3 relative L2 of JAX's gradient; the
    frozen stem and stage 1 get none on either side; the neck's new convs
    (HRFPN's reduction conv, PAFPN's bottom-up convs) get some."""
    _, _, got, ref, frozen = train_step(kind)
    compared = 0
    for k in ref:
        if k in frozen or not ref[k].any():
            assert not got[k].any() and (k not in frozen or
                                         not ref[k].any()), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
        compared += 1
    assert frozen and compared >= 40, (len(frozen), compared)
    new = {'hrnet': 'neck.reduction_conv.', 'pafpn': 'neck.pafpn_convs.'}
    if kind in new:
        assert any(k.startswith(new[kind]) and ref[k].any() for k in ref)


@pytest.mark.parametrize('kind', KINDS)
def test_crop_calls_per_path(kind):
    check_crop_calls_per_path(kind)


def check_crop_calls_per_path(kind):
    """K2 per image, K2 / K4 per step: a box and a mask extract on the
    Mask R-CNNs, a box extract on the PAFPN Faster R-CNN, whichever the
    pyramid."""
    _, _, port = twin(kind)
    n = 2 if kind in MASKED else 1
    batch = _demo(2)
    with counted_crops() as counts, torch.no_grad():
        port.simple_test({k: torch.from_numpy(batch[k][:1]) for k in
                          ('image', 'img_shape', 'scale_factor')})
    assert counts == {'fwd': n, 'bwd': 0}
    net = copy.deepcopy(port).train()
    with counted_crops() as counts:
        losses = net.forward_train(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            generator=torch.Generator().manual_seed(0))
        sum(v for k, v in losses.items() if 'loss' in k).backward()
    assert counts == {'fwd': n, 'bwd': n}


# -- FCOS on HRNet + HRFPN at stride 2 ----------------------------------------

FCOS_HRNET = 'configs/hrnet/fcos_hrnetv2p_w32_gn-head_4x4_1x_coco.py'
SCALES = np.array([0.9, 1.1, 1.0, 1.2, 0.8], np.float32)


def fcos_cfg():
    """The FCOS-HRNet config at toy width: the toy HRNet, a 32-channel
    HRFPN at stride 2, two-conv heads of 32 channels, 8 classes, 50
    candidates a level and 20 dets an image."""
    from dynamask_torch.utils.config import Config
    cfg = copy.deepcopy(Config.fromfile(os.path.join(ROOT, FCOS_HRNET))
                        .to_dict())
    m = cfg['model']
    m.pop('pretrained', None)
    m['backbone']['extra'] = TOY_HRNET
    m['neck'].update(in_channels=[8, 16, 32, 64], out_channels=32)
    m['bbox_head'].update(in_channels=32, feat_channels=32, stacked_convs=2,
                          num_classes=8)
    cfg['test_cfg'].update(nms_pre=50, max_per_img=20)
    return m, cfg.get('train_cfg'), cfg['test_cfg']


@functools.lru_cache(maxsize=None)
def fcos_twin():
    from test_torch_port_single_stage import demo
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = fcos_cfg()
    assert cfg[0]['neck']['stride'] == 2
    det = jax_build(*cfg)
    variables = randomize_variables(fast_jit(det.init)(
        {'params': jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in demo().items()}))
    variables['params']['bbox_head']['scales'] = SCALES.copy()
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


def test_fcos_hrnet_simple_test():
    """Dets, labels and validity slot for slot, two images, one with a
    scale factor of 0.8 and an un-padded extent short of the canvas."""
    from test_torch_port_single_stage import demo, jax_simple_test
    det, variables, port = fcos_twin()
    batch = {k: demo(2)[k] for k in TEST_KEYS}
    batch['scale_factor'][1:] = 0.8
    batch['img_shape'][1] = [56, 48]
    ref = jax_simple_test(det, variables, batch)
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    check_dets(got, ref)


def test_fcos_hrnet_train_losses():
    """One training step's losses (cls, bbox, centerness) and gradient norm
    within 1e-4 of JAX's, from the same variables."""
    from test_torch_port_single_stage import demo
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     make_train_step as jstep)
    from dynamask_tpu.engine.optimizer import step_lr_schedule
    from dynamask_torch.engine import DetectorSGD, make_train_step
    from dynamask_torch.engine import step_lr_schedule as tsched
    det, variables, port = fcos_twin()
    port = copy.deepcopy(port).train()
    batch = demo(2)
    batch['img_shape'][1] = [56, 48]
    tx = build_optimizer(
        variables['params'], 0.01, 0.9, 1e-4, 35.0,
        step_lr_schedule(0.01, 10, warmup_iters=0),
        frozen_backbone_prefixes=det.backbone.frozen_param_paths())
    _, ref = jax.jit(jstep(det, tx))(
        create_train_state(variables, tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    opt = DetectorSGD(port, 0.01, 0.9, 1e-4, 35.0,
                      tsched(0.01, 10, warmup_iters=0))
    got = make_train_step(port, opt)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jax.device_get(ref)
    keys = {k for k in ref if 'loss' in k}
    assert {'loss_cls', 'loss_bbox', 'loss_centerness'} <= keys <= set(got)
    for k in sorted(keys) + ['grad_norm']:
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
        assert float(ref[k]) > 0, k
