"""Toy twins of the detectors on item 7's backbones, on the CPU: the
PyTorch port against the JAX package on the same seeded inputs, the JAX
weights carried across by ``dynamask_torch.engine.convert``; where JAX
reaches RoIAlign it runs its XLA form.

- Two-stage (the mini Mask R-CNN of ``tests/test_models.py`` on
  ResNet-50: 32-channel neck, 8 classes, 64x64): Mask R-CNN with DCNv1 on
  c3-c5 and GCNet's ``ContextBlock`` (ratio 1/16) after conv3 on c3-c5,
  as ``configs/gcnet/`` and ``configs/dcn/`` place them; Faster R-CNN
  with DCNv2 in 4 deform groups on c3-c5 and ``GeneralizedAttention``
  ``'1111'`` after conv2 on c4-c5 (``configs/empirical_attention/``; its
  square maps put the stride-1 DCNv2 blocks in JAX's windowed form).
  ``simple_test`` slot for slot; one ``forward_train`` with the sampler
  draws injected on both sides: every loss, and every parameter's
  gradient through the key map (the offset convs', the DCN kernels' and
  the plugins' among them). The K2/K4 calls on each path.
- FCOS with ``dcn_on_last_conv`` from its config file at toy width
  (ResNet-18, two-conv heads of 32 channels): ``simple_test`` and one
  SGD step's losses, gradient norm and parameters.

Tolerances as the other twins: dets ``rtol=1e-5, atol=1e-4``, labels and
validity exact; losses 1e-4 relative; gradients 1e-3 relative L2;
parameters after a step 1e-4 relative.
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
from test_torch_port_item8_detectors import check_dets  # noqa: E402
from test_torch_port_modules import randomize_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402
from test_torch_port_two_stage_twins import G, N_ANCHORS, P  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
PARAM_RTOL = 1e-4
STAGES = (False, True, True, True)
KINDS = ['dcn_gcb', 'mdcn_ga']
MASKED = {'dcn_gcb'}


def toy_cfg(kind):
    """(model, train_cfg, test_cfg): the mini Mask R-CNN on a ResNet-50
    with DCNv1 and GCB ('dcn_gcb'), or the mini Faster R-CNN with DCNv2 in
    4 groups and GA '1111' ('mdcn_ga')."""
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    bb = model['backbone']
    bb['depth'] = 50
    model['neck']['in_channels'] = [256, 512, 1024, 2048]
    if kind == 'dcn_gcb':
        bb.update(dcn=dict(type='DCN', deform_groups=1,
                           fallback_on_stride=False), stage_with_dcn=STAGES,
                  plugins=[dict(cfg=dict(type='ContextBlock', ratio=1 / 16),
                                stages=STAGES, position='after_conv3')])
    else:
        model['type'] = 'FasterRCNN'
        rh = model['roi_head']
        rh['mask_head'] = rh['mask_roi_extractor'] = None
        bb.update(dcn=dict(type='DCNv2', deform_groups=4),
                  stage_with_dcn=STAGES,
                  plugins=[dict(cfg=dict(type='GeneralizedAttention',
                                         spatial_range=-1, num_heads=8,
                                         attention_type='1111', kv_stride=2),
                                stages=(False, False, True, True),
                                position='after_conv2')])
    return model, train_cfg, test_cfg


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    jcfg = copy.deepcopy(cfg)
    jcfg[0]['backbone']['block_remat'] = False
    det = jax_build(*jcfg)
    batch = {k: jnp.asarray(v) for k, v in _demo().items()}
    variables = randomize_variables(
        jax.jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    # each residual branch's last BN scale at a tenth (the init's is 0,
    # zero_init_residual): 16 blocks of random weights at full scale
    # saturate the scores into ties
    for block in variables['params']['backbone'].values():
        if 'bn3' in block:
            block['bn3']['scale'] = block['bn3']['scale'] * 0.1
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor')


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    """Dets, labels, validity and (Mask R-CNN) 28x28 mask probabilities
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
    """Every loss key of the step within 1e-4 of JAX's, the sampler draws
    injected; the box (and mask) losses non-zero."""
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
    """Every parameter within 1e-3 relative L2 of JAX's gradient; the
    frozen stem and stage 1 get none on either side; the offset convs,
    the DCN kernels and the plugins get some."""
    _, _, got, ref, frozen = train_step(kind)
    compared, seen = 0, set()
    for k in ref:
        if k.endswith('conv_mask.bias'):      # softmax shift: zero but noise
            assert max(abs(got[k]).max(), abs(ref[k]).max()) < 1e-6, k
            continue
        if k in frozen or not ref[k].any():
            assert not got[k].any() and (k not in frozen or
                                         not ref[k].any()), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
        compared += 1
        seen |= {s for s in ('conv_offset', 'conv2.weight', 'context_block',
                             'gen_attention_block') if s in k}
    assert frozen and compared >= 60, (len(frozen), compared)
    plugin = 'context_block' if kind == 'dcn_gcb' else 'gen_attention_block'
    assert seen == {'conv_offset', 'conv2.weight', plugin}, seen


@pytest.mark.parametrize('kind', KINDS)
def test_crop_calls_per_path(kind):
    """K2 per image, K2 / K4 per step: a box and a mask extract on the
    Mask R-CNN, a box extract on the Faster R-CNN; the backbone's DCNs
    call neither."""
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


# -- FCOS with dcn_on_last_conv -----------------------------------------------

FCOS_DCN = ('configs/fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_'
            'fpn_gn-head_dcn_4x4_1x_coco.py')
SCALES = np.array([0.9, 1.1, 1.0, 1.2, 0.8], np.float32)


def fcos_cfg():
    """The FCOS DCN config at toy width: ResNet-18, a 32-channel FPN,
    two-conv heads of 32 channels (the second deformable), 8 classes, 50
    candidates a level and 20 dets an image."""
    from dynamask_torch.utils.config import Config
    cfg = copy.deepcopy(Config.fromfile(os.path.join(ROOT, FCOS_DCN))
                        .to_dict())
    m = cfg['model']
    m.pop('pretrained', None)
    assert m['bbox_head']['dcn_on_last_conv']
    m['backbone']['depth'] = 18
    m['neck'].update(in_channels=[64, 128, 256, 512], out_channels=32)
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
    det = jax_build(*cfg)
    variables = randomize_variables(jax.jit(det.init)(
        {'params': jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in demo().items()}))
    head = variables['params']['bbox_head']
    head['scales'] = SCALES.copy()
    assert {'cls_dcn_weight', 'reg_dcn_offset'} <= set(head)
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


def test_fcos_dcn_simple_test():
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


def test_fcos_dcn_one_step():
    """One SGD step (momentum, weight decay, the clip at 35) from the same
    variables: the losses and gradient norm within 1e-4 of JAX's, every
    parameter after it within 1e-4 relative, the deformable convs' among
    them moved."""
    from test_torch_port_single_stage import demo
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     make_train_step as jstep)
    from dynamask_tpu.engine.optimizer import step_lr_schedule
    from dynamask_torch.engine import DetectorSGD, make_train_step
    from dynamask_torch.engine import step_lr_schedule as tsched
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    det, variables, port = fcos_twin()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port = copy.deepcopy(port).train()
    batch = demo(2)
    batch['img_shape'][1] = [56, 48]
    tx = build_optimizer(
        variables['params'], 0.01, 0.9, 1e-4, 35.0,
        step_lr_schedule(0.01, 10, warmup_iters=0),
        frozen_backbone_prefixes=det.backbone.frozen_param_paths())
    state, ref = jax.jit(jstep(det, tx))(
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
    params = jax.device_get(state.params)
    hints = key_hints(port)
    moved = set()
    for k, v in port.state_dict().items():
        if k.endswith(('num_batches_tracked', 'running_mean',
                       'running_var')):
            continue
        want = _torch_layout(params, {}, *mmdet_key(k, **hints))
        np.testing.assert_allclose(v.numpy(), want, rtol=PARAM_RTOL,
                                   atol=1e-6, err_msg=k)
        if not torch.equal(v, before[k]):
            moved |= {s for s in ('conv.conv_offset', 'convs.1.conv.weight')
                      if s in k}
    assert moved == {'conv.conv_offset', 'convs.1.conv.weight'}, moved


def test_fcos_dcn_refuses_an_mmdet_dcnv2_offset_conv():
    """mmdet's ``dcn_on_last_conv`` conv carries DCNv2's 27-channel
    ``conv_offset``; the port's (JAX's) is DCNv1's 18: a checkpoint of the
    other width is refused by name, never cut."""
    _, _, port = fcos_twin()
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    key = 'bbox_head.cls_convs.1.conv.conv_offset.weight'
    assert tuple(sd[key].shape) == (18, 32, 3, 3)
    sd[key] = torch.zeros(27, 32, 3, 3)
    with pytest.raises(ValueError, match='DCNv1'):
        copy.deepcopy(port).load_state_dict(sd)
