"""Toy twins of the single-stage detectors on the CPU: the PyTorch port's
RetinaNet, GHM RetinaNet, FreeAnchor, legacy v1 RetinaNet, ATSS and FCOS
against the JAX package's, built from their unchanged config files at toy
width (ResNet-18, a 32-channel FPN with its extra levels, two-conv heads
of 32 channels, 8 classes, 64x64), the JAX weights carried across by
``dynamask_torch.engine.convert``.

Each holds ``simple_test`` (dets, labels, validity), ``forward_train``'s
losses and one optimizer step's parameters against JAX's. Nothing is drawn
at random in these detectors' training, so no draws are injected.

Tolerances as the other twins: dets ``rtol=1e-5, atol=1e-4``, labels and
validity exact; losses and the stepped parameters 1e-4 relative.
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

from test_torch_port_modules import randomize_variables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'retina': 'configs/retinanet/retinanet_r50_fpn_1x_coco.py',
    'ghm': 'configs/ghm/retinanet_ghm_r50_fpn_1x_coco.py',
    'free_anchor':
        'configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py',
    'legacy': 'configs/legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py',
    'sepbn': 'configs/nas_fpn/retinanet_r50_fpn_crop640_50e_coco.py',
    'atss': 'configs/atss/atss_r50_fpn_1x_coco.py',
    'fcos': 'configs/fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_'
            'fpn_gn-head_4x4_1x_coco.py',
    'fcos_plain': 'configs/fcos/fcos_r50_fpn_1x_coco.py',
}
# the RetinaNet family here; ATSS and FCOS in
# ``tests/test_torch_port_single_stage_atss_fcos.py`` (the same checks)
KINDS = ['retina', 'ghm', 'free_anchor', 'legacy']
LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-4
LR = 0.01
# per-level factors on the heads' learned scales, so a level mismatch shows
SCALES = np.array([0.9, 1.1, 1.0, 1.2, 0.8], np.float32)


def toy_cfg(kind, num_classes=8):
    """(model, train_cfg, test_cfg) of ``kind``'s config file at toy
    width; ``nms_pre`` 50 and 20 dets an image."""
    from dynamask_torch.utils.config import Config
    cfg = copy.deepcopy(Config.fromfile(os.path.join(
        ROOT, CONFIGS[kind])).to_dict())
    m = cfg['model']
    m.pop('pretrained', None)
    m['backbone']['depth'] = 18
    m['neck'].update(in_channels=[64, 128, 256, 512], out_channels=32)
    m['bbox_head'].update(in_channels=32, feat_channels=32, stacked_convs=2,
                          num_classes=num_classes)
    test_cfg = cfg['test_cfg']
    test_cfg.update(nms_pre=50, max_per_img=20)
    return m, cfg.get('train_cfg'), test_cfg


def demo(b=1):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(0, b=b, h=64, w=64, g=3,
                                                   s=16).items()}


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    det = jax_build(*cfg)
    variables = randomize_variables(jax.jit(det.init)(
        {'params': jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in demo().items()}))
    head = variables['params']['bbox_head']
    if 'scales' in head:
        head['scales'] = SCALES[:head['scales'].shape[0]].copy()
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


def jax_simple_test(det, variables, batch):
    return jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))


TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor')


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


def check_simple_test(kind):
    """Dets, labels and validity slot for slot, two images, one with a
    scale factor of 0.8 and an un-padded extent short of the canvas."""
    det, variables, port = twin(kind)
    batch = {k: demo(2)[k] for k in TEST_KEYS}
    batch['scale_factor'][1:] = 0.8
    batch['img_shape'][1] = [56, 48]
    ref = jax_simple_test(det, variables, batch)
    got = port.simple_test({k: torch.from_numpy(v)
                            for k, v in batch.items()})
    for i in range(2):
        assert ref['det_valid'][i].sum() >= 4
        scores = ref['dets'][i, ref['det_valid'][i].astype(bool), 4]
        assert np.min(np.abs(np.diff(np.sort(scores)))) > 1e-6, 'ties'
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)


@functools.lru_cache(maxsize=None)
def train_step(kind):
    """One SGD step from the same variables on both sides: (port log, JAX
    log, port parameters after, JAX parameters after in the port's
    layout)."""
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     make_train_step as jstep)
    from dynamask_tpu.engine.optimizer import step_lr_schedule
    from dynamask_torch.engine import DetectorSGD, make_train_step
    from dynamask_torch.engine import step_lr_schedule as tsched
    from dynamask_torch.engine.convert import (_torch_layout, mmdet_key,
                                               neck_laterals)
    det, variables, port = twin(kind)
    port = copy.deepcopy(port).train()
    batch = demo(2)
    batch['img_shape'][1] = [56, 48]
    tx = build_optimizer(
        variables['params'], LR, 0.9, 1e-4, 35.0,
        step_lr_schedule(LR, 10, warmup_iters=0),
        frozen_backbone_prefixes=det.backbone.frozen_param_paths())
    state, ref = jax.jit(jstep(det, tx))(
        create_train_state(variables, tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    opt = DetectorSGD(port, LR, 0.9, 1e-4, 35.0,
                      tsched(LR, 10, warmup_iters=0))
    got = make_train_step(port, opt)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    params = jax.device_get(state.params)
    laterals = neck_laterals(port)
    after = {k: v.detach().numpy() for k, v in port.state_dict().items()
             if not k.endswith(('num_batches_tracked', 'running_mean',
                                'running_var'))}
    ref_after = {k: _torch_layout(params, {}, *mmdet_key(k, laterals))
                 for k in after}
    return ({k: float(v) for k, v in got.items()},
            {k: float(v) for k, v in jax.device_get(ref).items()},
            after, ref_after)


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    check_train_losses(kind)


def check_train_losses(kind):
    """Every loss of the step within 1e-4 of JAX's, each non-zero."""
    got, ref, _, _ = train_step(kind)
    keys = {k for k in ref if 'loss' in k}
    assert len(keys) >= 3 and keys <= set(got)
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
        assert ref[k] > 0, k
    np.testing.assert_allclose(got['grad_norm'], ref['grad_norm'],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('kind', KINDS)
def test_one_step_parameters(kind):
    check_one_step_parameters(kind)


def check_one_step_parameters(kind):
    """Every parameter after one SGD step (momentum, weight decay, the
    clip at 35) within 1e-4 relative of JAX's; the head's and the FPN's
    moved."""
    _, _, after, ref = train_step(kind)
    _, variables, port = twin(kind)
    moved = 0
    for k, v in after.items():
        np.testing.assert_allclose(v, ref[k], rtol=PARAM_RTOL, atol=1e-6,
                                   err_msg=k)
        before = port.state_dict()[k].numpy()
        moved += k.startswith(('bbox_head.', 'neck.')) and \
            not np.array_equal(v, before)
    assert moved >= 10, moved
