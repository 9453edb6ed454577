"""Toy twins of item 6's FPN dense detectors on the CPU: the PyTorch port's
GFL, FSAF and FoveaBox against the JAX package's, built from their
unchanged config files at toy width (ResNet-18, a 32-channel FPN with its
extra levels, one-conv towers of 32 channels, 8 classes, 64x64), the JAX
weights carried across by ``dynamask_torch.engine.convert``. The align
FoveaBox, RepPoints (moment, minmax, partial minmax, grid) and NAS-FCOS
run the same checks in ``tests/test_torch_port_item6_detectors_*.py``, so
that the files run side by side.

Each twin holds:

- ``simple_test`` of two images (one at a scale factor of 0.8 and an
  extent short of the canvas): labels and validity exact, dets within 1e-4
  of the largest coordinate (``DET_RTOL``);
- one ``forward_train`` in float64 on both sides (JAX under
  ``jax_enable_x64``, which still rounds through fp32 where its code casts
  to it): every loss within 1e-5 relative (``LOSS_RTOL``), every
  parameter's gradient within 1e-4 relative L2 (``GRAD_RL2``) of JAX's,
  against a floor of 1e-6 of the largest gradient's norm for the ones that
  are zero in the math (a GroupNorm over single values).

The JAX variables are drawn, leaf by leaf, from a numpy seed on the tree
``jax.eval_shape`` gives (no compiled init): kernels N(0, 1 / fan-in),
biases and the moment transfer N(0, 0.1), norm scales and variances
U(0.5, 1.5), the learned scales a factor a level.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'gfl': 'configs/gfl/gfl_r50_fpn_1x_coco.py',
    'fsaf': 'configs/fsaf/fsaf_r50_fpn_1x_coco.py',
    'fovea': 'configs/foveabox/fovea_r50_fpn_4x4_1x_coco.py',
    'fovea_align':
        'configs/foveabox/fovea_align_r50_fpn_gn-head_4x4_2x_coco.py',
    'reppoints':
        'configs/reppoints/reppoints_moment_r50_fpn_gn-neck+head_1x_coco.py',
    'reppoints_minmax':
        'configs/reppoints/reppoints_minmax_r50_fpn_gn-neck+head_1x_coco.py',
    'reppoints_partial_minmax': 'configs/reppoints/reppoints_partial_minmax_'
                                'r50_fpn_gn-neck+head_1x_coco.py',
    'reppoints_grid':
        'configs/reppoints/bbox_r50_grid_fpn_gn-neck+head_1x_coco.py',
    'nas_fcos': 'configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_'
                '4x4_1x_coco.py',
}
# the detectors in this file; the others in the files named above
KINDS = ['gfl', 'fsaf', 'fovea']
DET_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
GRAD_FLOOR = 1e-6
# per-level factors on the heads' learned scales, so a level mismatch shows
SCALES = np.array([0.9, 1.1, 1.0, 1.2, 0.8])
# the NAS-FCOS toy keeps 3 of the 5 levels: JAX compiles its windowed DCNv2
# tower a level, a minute at 5 (its levels are the config's otherwise)
NAS_LEVELS = 3


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
    head = dict(in_channels=32, feat_channels=32, num_classes=num_classes)
    if kind.startswith('reppoints'):
        head['point_feat_channels'] = 32
    if kind == 'nas_fcos':
        m['neck']['num_outs'] = NAS_LEVELS
        head.update(strides=[8, 16, 32][:NAS_LEVELS], regress_ranges=[
            [-1, 64], [64, 128], [128, 1e8]][:NAS_LEVELS])
    else:
        head['stacked_convs'] = 1
    m['bbox_head'].update(head)
    test_cfg = cfg['test_cfg']
    test_cfg.update(nms_pre=50, max_per_img=20)
    return m, cfg.get('train_cfg'), test_cfg


def demo(b=1):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(0, b=b, h=64, w=64, g=3,
                                                   s=16).items()}


def draw_variables(det, batch, seed=0):
    """The JAX detector's variables drawn from ``seed`` on the tree of
    ``jax.eval_shape(det.init)`` (see the module docstring)."""
    shapes = jax.eval_shape(det.init, {'params': jax.random.PRNGKey(0)},
                            {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = path[-1].key
        if name == 'scales':
            return SCALES[:x.shape[0]].astype(np.float32)
        if len(x.shape) >= 2:
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, x.shape).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0, 0.1, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its drawn variables, the port loaded from
    them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    det = jax_build(*copy.deepcopy(cfg))
    variables = draw_variables(det, demo())
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor')


def check_simple_test(kind):
    """Dets, labels and validity slot for slot, two images, one with a
    scale factor of 0.8 and an un-padded extent short of the canvas."""
    det, variables, port = twin(kind)
    batch = {k: demo(2)[k] for k in TEST_KEYS}
    batch['scale_factor'][1:] = 0.8
    batch['img_shape'][1] = [56, 48]
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = port.simple_test({k: torch.from_numpy(v)
                            for k, v in batch.items()})
    for i in range(2):
        assert ref['det_valid'][i].sum() >= 4
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    scale = np.abs(ref['dets'][..., :4]).max()
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=0,
                               atol=DET_RTOL * scale)


@functools.lru_cache(maxsize=None)
def train_step64(kind, grads=True):
    """One ``forward_train`` in float64 on both sides from the same
    variables: (port losses, JAX losses, port gradients, JAX gradients in
    the port's layout through the port's key map); the losses alone
    without ``grads``."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(kind)
    port = copy.deepcopy(port).double().train()
    batch = demo(2)
    batch['img_shape'][1] = [56, 48]
    wide = {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train', mutable=['batch_stats'])
        return jparse(losses)

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), variables)
        args = (v64['params'], v64.get('batch_stats', {}),
                {k: jnp.asarray(v) for k, v in wide.items()})
        if grads:
            (_, ref), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(*args)
        else:
            ref = jax.jit(loss_fn)(*args)[1]
        ref, grads = jax.device_get(ref), jax.device_get(grads)
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(v) for k, v in wide.items()}))
    if not grads:
        return ({k: float(v.detach()) for k, v in log.items()},
                {k: float(v) for k, v in ref.items()}, None, None)
    total.backward()
    hints = key_hints(port)
    got = {k: p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
           for k, p in port.named_parameters()}
    ref_g = {k: _torch_layout(grads, {}, *mmdet_key(k, **hints))
             for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in ref.items()}, got, ref_g)


def check_losses(kind, grads=False):
    """Every loss within 1e-5 relative of JAX's, each non-zero."""
    got, ref, _, _ = train_step64(kind, grads)
    keys = {k for k in ref if 'loss' in k}
    assert len(keys) >= 3 and keys <= set(got)
    for k in sorted(keys):
        assert abs(got[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), (k, got[k],
                                                                 ref[k])
        assert ref[k] > 0, k


def check_train_step(kind):
    """The losses (:func:`check_losses`); every parameter's gradient within
    1e-4 relative L2, the zeros of the math against the floor."""
    check_losses(kind, True)
    _, _, grads, ref_grads = train_step64(kind)
    norms = {k: np.linalg.norm(v) for k, v in ref_grads.items()}
    floor = GRAD_FLOOR * max(norms.values())
    worst = max((np.linalg.norm(grads[k] - r) / max(norms[k], floor), k)
                for k, r in ref_grads.items())
    assert worst[0] < GRAD_RL2, worst
    moved = sum(norms[k] > floor for k in norms if k.startswith('bbox_head'))
    assert moved >= 6, moved


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_train_step(kind):
    check_train_step(kind)


def test_train_and_eval_clis_on_gfl(tmp_path, capsys):
    """The entry points take item 6's detectors: the train CLI one step on
    the toy GFL over a seeded COCO set (its losses logged), then the eval
    CLI on the work dir it wrote (bbox AP)."""
    from test_torch_port_eval_slice import (TEST_PIPELINE, TRAIN_PIPELINE,
                                            _write_cfg, data_cfg, make_set)
    from test_torch_port_train_loop import rows
    from dynamask_torch.tools.test import main as test_main
    from dynamask_torch.tools.train import main as train_main
    coco = make_set(tmp_path)
    model, train_cfg, test_cfg = toy_cfg('gfl')
    cfg = _write_cfg(tmp_path / 'cfg.py', dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        optimizer=dict(type='SGD', lr=0.002, momentum=0.9,
                       weight_decay=1e-4),
        optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=5,
                       warmup_ratio=0.001, step=[8, 11]),
        total_epochs=1, log_config=dict(interval=1),
        evaluation=dict(interval=1, metric=['bbox']),
        data=dict(samples_per_gpu=2, workers_per_gpu=0, max_gts=8,
                  mask_crop_size=32,
                  train=data_cfg(*coco, TRAIN_PIPELINE),
                  val=data_cfg(*coco, TEST_PIPELINE),
                  test=data_cfg(*coco, TEST_PIPELINE))))
    work = str(tmp_path / 'work')
    assert train_main([cfg, '--work-dir', work, '--device', 'cpu',
                       '--max-steps-per-epoch', '1', '--no-validate']) == 0
    train = [r for r in rows(work) if r['mode'] == 'train']
    assert len(train) == 1
    assert all(np.isfinite(train[0][k]) for k in ('loss_cls', 'loss_bbox',
                                                  'loss_dfl'))
    assert test_main([cfg, work, '--device', 'cpu', '--eval', 'bbox']) == 0
    assert 'bbox_mAP:' in capsys.readouterr().out
