"""bf16 on Faster R-CNN and Mask R-CNN: ``configs/fp16/
faster_rcnn_r50_fpn_fp16_1x_coco.py`` and ``mask_rcnn_r50_fpn_fp16_1x_coco.py``
at mini size (their models with ResNet-18, a 32-channel FPN and heads, 8
classes, 64x64), the port in bf16 against the JAX package in bf16 on the
CPU, as ``tests/test_torch_port_bf16.py`` holds the flagship and with its
tolerances:

- the continuous stages (FPN levels, RPN maps, the box head's logits and
  deltas on JAX's proposals) within STAGE_RL2 relative L2;
- Mask R-CNN's ``make_test_fn(..., bf16=True)`` with JAX's dets injected:
  its 28x28 mask probabilities and pasted masks (PROB_*, MASK_*);
- the training step with ``compute_dtype=torch.bfloat16`` against JAX's
  bf16 ``make_train_step``, on JAX's proposals with the same sampler
  draws: every loss within LOSS_RTOL_JAX, the accuracy equal, fp32
  masters and gradients (``train_detector`` takes the configs'
  ``fp16 = dict(loss_scale=512.)`` as this bf16 step).
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

from test_torch_port_bf16 import (CANVAS, FLIP_SHARE,  # noqa: E402
                                  LOSS_RTOL_JAX, MASK_AGREE, MASK_MARGIN,
                                  PROB_ATOL, PROB_MEAN_ATOL, STAGE_RL2,
                                  _batch, _f32, _jax_stages,
                                  _jax_train_proposals, _rel_l2,
                                  injected_dets, injected_proposals)
from test_torch_port_modules import randomize_variables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {'faster': 'configs/fp16/faster_rcnn_r50_fpn_fp16_1x_coco.py',
           'mask': 'configs/fp16/mask_rcnn_r50_fpn_fp16_1x_coco.py'}
LR = 0.01


def mini_cfg(name):
    """The config's model and train/test cfgs at mini size, as plain
    dicts."""
    from dynamask_torch.utils.config import Config
    cfg = copy.deepcopy(Config.fromfile(os.path.join(
        ROOT, CONFIGS[name])).to_dict())
    m = cfg['model']
    m.pop('pretrained', None)
    m['backbone']['depth'] = 18
    m['neck'].update(in_channels=[64, 128, 256, 512], out_channels=32)
    m['rpn_head'].update(in_channels=32, feat_channels=32)
    rh = m['roi_head']
    rh['bbox_roi_extractor']['out_channels'] = 32
    rh['bbox_head'].update(in_channels=32, fc_out_channels=64,
                           num_classes=8)
    if rh.get('mask_head'):
        rh['mask_roi_extractor']['out_channels'] = 32
        rh['mask_head'].update(num_convs=2, in_channels=32,
                               conv_out_channels=32, num_classes=8)
    train_cfg, test_cfg = cfg['train_cfg'], cfg['test_cfg']
    test_cfg['rpn'].update(nms_pre=32, max_num=16)
    test_cfg['rcnn']['max_per_img'] = 8
    train_cfg['rpn']['sampler']['num'] = 64
    train_cfg['rpn_proposal'].update(nms_pre=64, max_num=32)
    train_cfg['rcnn']['sampler']['num'] = 32
    return cfg, (m, train_cfg, test_cfg)


_PAIRS = {}


def pair(name):
    if name not in _PAIRS:
        from test_models import demo_batch
        from dynamask_tpu.models import build_detector as jax_build
        from dynamask_torch.engine import load_jax_variables
        from dynamask_torch.models import build_detector
        _, cfg = mini_cfg(name)
        det = jax_build(*cfg)
        variables = randomize_variables(jax.jit(det.init)(
            {'params': jax.random.PRNGKey(0)},
            demo_batch(0, b=1, h=64, w=64, g=3, s=16)))
        port = build_detector(*cfg, device='cpu')
        load_jax_variables(port, variables)
        _PAIRS[name] = det, variables, port, cfg
    return _PAIRS[name]


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_bf16_stages_match_jax(name):
    from dynamask_torch.core.fp16 import to_bf16
    det, variables, port, _ = pair(name)
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


def test_mask_rcnn_make_test_fn_bf16_matches_jax():
    """Mask R-CNN through ``make_test_fn(..., bf16=True)`` on both sides:
    with JAX's dets injected, the 28x28 mask probabilities within the
    flagship's bounds of JAX's ``simple_test`` in bf16 and the pasted
    masks equal to JAX's wherever JAX's probability is MASK_MARGIN clear
    of 0.5; the dets fp32."""
    from dynamask_tpu.apis.test import make_test_fn as jmake
    from dynamask_tpu.core.fp16 import to_bf16 as jto
    from dynamask_tpu.ops.paste import paste_masks as jpaste
    from dynamask_torch.apis import make_test_fn
    from dynamask_torch.core.fp16 import to_bf16
    det, variables, port, _ = pair('mask')
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax.device_get(jmake(det, variables, CANVAS, 0.5, bf16=True)(jb))
    assert ref['dets'].dtype == np.float32 and ref['valid'].sum() >= 4
    out = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            jto(variables), dict(jb, image=jb['image'].astype(jnp.bfloat16))))
    ref_pasted = np.asarray(jpaste(out['mask_probs'].reshape(-1, 28, 28),
                                   out['dets'][..., :4].reshape(-1, 4),
                                   *CANVAS).astype(jnp.float32))
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    with injected_dets(ref):
        got = make_test_fn(port, CANVAS, 0.5, bf16=True)(bt)
        probs = to_bf16(port).simple_test(
            dict(bt, image=bt['image'].bfloat16()))['mask_probs']
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert got['dets'].dtype == torch.float32
    np.testing.assert_array_equal(got['dets'].numpy(), ref['dets'])
    assert probs.dtype == torch.bfloat16 and probs.shape == (1, 8, 28, 28)
    diff = np.abs(_f32(probs) - _f32(out['mask_probs']))
    assert diff.mean() <= PROB_MEAN_ATOL
    assert (diff > PROB_ATOL).mean() <= FLIP_SHARE
    clear = np.abs(ref_pasted - 0.5) > MASK_MARGIN
    masks = got['masks'].numpy().reshape(ref_pasted.shape)
    assert clear.mean() > 0.5
    assert (masks[clear] == ref['masks'].reshape(ref_pasted.shape)[clear]
            ).mean() >= MASK_AGREE


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_bf16_step_losses_match_jax(name):
    """The bf16 step against JAX's, from the same variables and batch, on
    JAX's proposals with the same sampler priorities: every loss within
    LOSS_RTOL_JAX, the accuracy equal; fp32 masters and gradients."""
    from test_models import demo_batch
    from test_torch_port_train_slice import jax_draws
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     make_train_step as jstep)
    from dynamask_tpu.engine.optimizer import step_lr_schedule
    from dynamask_torch.engine import DetectorSGD, make_train_step
    from dynamask_torch.engine import step_lr_schedule as tsched
    det, variables, port, _ = pair(name)
    assert mini_cfg(name)[0]['fp16'] == {'loss_scale': 512.0}
    port = copy.deepcopy(port).train()
    batch = {k: np.array(v) for k, v in demo_batch(0, b=1, h=64, w=64, g=3,
                                                   s=16).items()}
    rng = np.random.RandomState(12)
    n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = {'rpn': rng.uniform(size=(1, n_anchors)).astype(np.float32),
             'rcnn': rng.uniform(size=(1, 3 + 32)).astype(np.float32),
             'gumbel': np.zeros((8, 4), np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = build_optimizer(
        variables['params'], LR, 0.9, 1e-4, 35.0,
        step_lr_schedule(LR, 10, warmup_iters=0),
        frozen_backbone_prefixes=det.backbone.frozen_param_paths())
    with jax_draws(noise):
        _, ref = jax.jit(jstep(det, tx, compute_dtype=jnp.bfloat16))(
            create_train_state(variables, tx), jb, jax.random.PRNGKey(0))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    opt = DetectorSGD(port, LR, 0.9, 1e-4, 35.0,
                      tsched(LR, 10, warmup_iters=0))
    with injected_proposals(_jax_train_proposals(det, variables, jb)):
        got = make_train_step(port, opt, torch.bfloat16)(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in noise.items()})
    got = {k: float(v) for k, v in got.items()}
    keys = {k for k in ref if 'loss' in k}
    want = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox', 'loss'}
    assert keys == (want | {'loss_mask'} if name == 'mask' else want)
    for k in sorted(keys):
        assert abs(got[k] - ref[k]) <= LOSS_RTOL_JAX * abs(ref[k]) + 1e-6, (
            k, got[k], ref[k])
    assert got['acc'] == pytest.approx(ref['acc'])
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(p.grad.dtype == torch.float32 for p in port.parameters()
               if p.grad is not None)
