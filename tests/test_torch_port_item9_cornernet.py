"""CornerNet on the CPU: the PyTorch port against the JAX package on the same
seeded inputs, the JAX weights carried across by
``dynamask_torch.engine.convert``.

- ``corner_pool`` in its four directions (values and gradients), the dense
  ``corner_targets`` (heatmaps, offsets, masks, corner cells; padded GTs
  and corners on the map's edge), the Gaussian focal loss and the
  associative embedding's pull and push (with their gradients): fp32,
  within 1e-6 (targets exact).
- The toy CornerNet of the JAX package's own tests (``tests/
  test_cornernet.py``: an Hourglass of ``downsample_times=2``,
  ``stage_channels=[16, 16, 32]``, ``stage_blocks=[1, 1, 1]``, 8 classes)
  on 64x64 images: ``simple_test``'s dets slot for slot (labels and
  validity exact, boxes within 1e-4 of the largest coordinate) and one
  ``forward_train`` (every loss within 1e-4 relative, every gradient
  within 1e-3 relative L2); the key map both ways; the three config files
  built as JAX builds them.
- The train pipeline's ``PhotoMetricDistortion`` and
  ``RandomCenterCropPad`` (both modes) and the config files' pipelines
  under one seed, bit for bit with cv2 on both sides.
- The JAX faults (ROADMAP.md queue 3): the Hourglass canvas (3bq), the
  SGD-for-Adam recipe (3br), the importer's missing rules (3bs), the
  heatmap loss's mean (3bu) and ``low3``'s widths (3bv).
"""

import contextlib
import copy
import functools
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

from test_torch_port_cascade import _port_grads  # noqa: E402
from test_torch_port_item6_ssd import draw_variables  # noqa: E402
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNER_FILES = ('cornernet/cornernet_hourglass104_mstest_10x5_210e_coco.py',
                'cornernet/cornernet_hourglass104_mstest_32x3_210e_coco.py',
                'cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py')
DET_RTOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


# -- ops, targets, losses -----------------------------------------------------

@pytest.mark.parametrize('direction', ['top', 'bottom', 'left', 'right'])
def test_corner_pool(direction):
    """The running maximum and its gradient against ``lax.cummax``'s."""
    from dynamask_tpu.ops.corner_pool import corner_pool as jpool
    from dynamask_torch.ops.corner_pool import corner_pool
    rng = np.random.RandomState(9)
    x = rng.randn(2, 6, 7, 3).astype(np.float32)
    w = rng.randn(2, 6, 7, 3).astype(np.float32)
    out = jpool(jnp.asarray(x), direction)
    grad = jax.grad(lambda a: jnp.sum(jpool(a, direction) * w))(
        jnp.asarray(x))
    xt = _t(x.transpose(0, 3, 1, 2), True)
    got = corner_pool(xt, direction)
    np.testing.assert_array_equal(got.detach().numpy().transpose(0, 2, 3, 1),
                                  np.asarray(out))
    (got * _t(w.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(grad), atol=1e-6)
    assert not np.array_equal(np.asarray(out), x)


GTS = np.array([[[4.0, 8.0, 32.0, 32.0], [10.5, 2.25, 63.9, 40.0],
                 [0.0, 0.0, 0.0, 0.0]],
                [[30.0, 30.0, 38.0, 35.0], [0.0, 50.0, 20.0, 64.0],
                 [1.0, 1.0, 63.0, 63.0]]], np.float32)
LABELS = np.array([[3, 3, 0], [7, 1, 3]], np.int32)
VALID = np.array([[True, True, False], [True, True, True]])


def test_corner_targets():
    """Heatmaps (the max over the GTs of a class), offsets, offset masks
    and corner cells equal JAX's; a padded GT paints nothing; two GTs of
    one class share a map."""
    from dynamask_tpu.models.cornernet import corner_targets as jct
    from dynamask_torch.models.cornernet import corner_targets
    ref = jax.device_get(jax.vmap(lambda g, l, v: jct(
        g, l, v, 16, 16, 64.0, 64.0, 8))(jnp.asarray(GTS),
                                         jnp.asarray(LABELS),
                                         jnp.asarray(VALID)))
    got = corner_targets(_t(GTS), _t(LABELS), _t(VALID), 16, 16, 64.0, 64.0,
                         8)
    for k in ('tl_heat', 'br_heat', 'tl_off', 'br_off', 'tl_mask',
              'br_mask', 'tl_yx', 'br_yx'):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    assert (ref['tl_heat'][0, 3] == 1).sum() == 2
    assert ref['tl_heat'][0, 0].max() == 0


def test_losses_and_gradients():
    """``gaussian_focal_loss`` (its mean, as JAX reduces it) and the
    embedding's pull and push summed over the images, with their
    gradients."""
    from dynamask_tpu.models.cornernet import ae_loss_single, corner_targets
    from dynamask_tpu.models.losses import gaussian_focal_loss as jgfl
    from dynamask_torch.models.cornernet import ae_loss
    from dynamask_torch.models.losses import gaussian_focal_loss
    rng = np.random.RandomState(10)
    tgt = jax.device_get(jax.vmap(lambda g, l, v: corner_targets(
        g, l, v, 16, 16, 64.0, 64.0, 8))(jnp.asarray(GTS),
                                         jnp.asarray(LABELS),
                                         jnp.asarray(VALID)))
    logits = rng.randn(2, 8, 16, 16).astype(np.float32)
    tl_e, br_e = rng.randn(2, 2, 16, 16).astype(np.float32)

    def jfn(lg, te, be):
        det = jnp.sum(jgfl(jax.nn.sigmoid(lg), tgt['tl_heat']))
        pl, ps = jax.vmap(lambda a, b, c, d, v: ae_loss_single(
            a[..., None], b[..., None], c, d, v))(
            te, be, tgt['tl_yx'], tgt['br_yx'], jnp.asarray(VALID))
        return det + jnp.sum(pl) + jnp.sum(ps), (det, jnp.sum(pl),
                                                 jnp.sum(ps))

    (_, ref), grads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(logits), jnp.asarray(tl_e), jnp.asarray(br_e))
    lg, te, be = _t(logits, True), _t(tl_e, True), _t(br_e, True)
    det = gaussian_focal_loss(torch.sigmoid(lg), _t(tgt['tl_heat'])).sum()
    pl, ps = ae_loss(te, be, _t(tgt['tl_yx']).long(),
                     _t(tgt['br_yx']).long(), _t(VALID))
    (det + pl + ps).backward()
    for g, r in zip((det, pl, ps), ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
        assert float(r) > 0
    for t, r in zip((lg, te, be), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-9)


# -- the toy CornerNet --------------------------------------------------------

def _demo(b=2):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(
        0, b=b, h=64, w=64, g=3, s=16).items()}


@functools.lru_cache(maxsize=None)
def twin():
    from test_cornernet import corner_toy_cfg
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = corner_toy_cfg()
    det = jax_build(*copy.deepcopy(cfg))
    variables = draw_variables(det, _demo())
    # the heatmaps' biases at their init (-2.19) but class 0's at 1, the
    # embeddings near 0: the top corners pair up within the threshold
    heads = variables['params']['bbox_head']
    for k, v in heads.items():
        if 'heat' in k:
            v['out']['bias'] = np.full_like(v['out']['bias'], -2.19)
            v['out']['bias'][0] = 1.0
        if 'emb' in k:
            v['out']['kernel'] = v['out']['kernel'] * 0.05
            v['out']['bias'] = np.zeros_like(v['out']['bias'])
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


def test_simple_test():
    """Dets, labels and validity slot for slot (the second image at a scale
    factor of 0.8)."""
    det, variables, port = twin()
    batch = {k: _demo()[k] for k in ('image', 'img_shape', 'ori_shape',
                                     'scale_factor')}
    batch['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert got['dets'].shape == (2, 10, 5)
    assert ref['det_valid'].sum() >= 2
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    v = ref['det_valid']
    scale = np.abs(ref['dets'][..., :4][v]).max()
    np.testing.assert_allclose(got['dets'].numpy()[v], ref['dets'][v],
                               rtol=0, atol=DET_RTOL * scale)


@functools.lru_cache(maxsize=None)
def train_step():
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin()
    port = copy.deepcopy(port).train()
    batch = _demo()

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train', mutable=['batch_stats'])
        return jparse(losses)

    (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'], variables['batch_stats'],
                                {k: jnp.asarray(x) for k, x in batch.items()})
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()}))
    total.backward()
    got = _port_grads(port)
    jax_grads = jax.device_get(jax_grads)
    hints = key_hints(port)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k, **hints))
           for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax.device_get(jax_log).items()},
            got, ref)


def test_train_step():
    """The four losses within 1e-4 of JAX's (BatchNorms on batch
    statistics on both sides), every parameter's gradient within 1e-3
    relative L2, the corner pools' and every branch's among them."""
    port_log, jax_log, got, ref = train_step()
    keys = {'det_loss', 'pull_loss', 'push_loss', 'off_loss', 'loss'}
    assert keys == set(jax_log) and keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
        assert jax_log[k] > 0, k
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
    for k in ('bbox_head.tl_pool.1.direction1_conv.conv.weight',
              'bbox_head.br_off.0.1.conv.weight',
              'backbone.hourglass_modules.1.low2.low2.0.conv1.weight'):
        assert ref[k].any(), k


def test_key_map_both_ways():
    """Every port tensor of the toy has one JAX leaf and every JAX leaf is
    reached."""
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    det, variables, port = twin()

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,)

    reached = set()
    hints = key_hints(port)
    for k in port.state_dict():
        if 'num_batches' in k:
            continue
        path, leaf, _ = mmdet_key(k, **hints)
        if leaf in ('running_mean', 'running_var'):
            got = ('batch_stats',) + tuple(path) + (leaf[8:],)
        elif leaf == 'weight':
            node = variables['params']
            for p in path:
                node = node[p]
            got = ('params',) + tuple(path) + (
                'scale' if 'scale' in node else 'kernel',)
        else:
            got = ('params',) + tuple(path) + (leaf,)
        assert got not in reached, k
        reached.add(got)
    want = {('params',) + p for p in flat(variables['params'])} | {
        ('batch_stats',) + p for p in flat(variables['batch_stats'])}
    assert reached == want, (sorted(want - reached)[:5],
                             sorted(reached - want)[:5])


@pytest.mark.parametrize('rel', CORNER_FILES)
def test_cornernet_configs_as_jax_builds_them(rel):
    """Each file builds on the ``meta`` device with JAX's options:
    Hourglass-104 (two stacks, five downsamplings), the head's loss weights,
    the decode's top-k, threshold, detections and Soft-NMS; every key
    mapped."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', rel))
    port = build_detector(cfg['model'], cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')
    jdet = jax_build(cfg['model'], cfg.get('train_cfg'), cfg.get('test_cfg'))
    for k in ('pull_weight', 'push_weight', 'offset_beta', 'corner_topk',
              'local_maximum_kernel', 'distance_threshold', 'num_dets',
              'num_classes', 'nms_sigma'):
        assert getattr(port, k) == getattr(jdet, k), k
    assert port.test_cfg['iou_thr'] == jdet.nms_iou_thr
    assert port.test_cfg['max_per_img'] == jdet.max_per_img
    assert port.test_cfg['score_thr'] == jdet.score_thr
    bb = port.backbone
    assert len(bb.hourglass_modules) == 2 and len(bb.inters) == 1
    assert bb.hourglass_modules[0].low2.low2.low2.low2.low2[3].conv1.\
        in_channels == 512
    assert 2.0e8 < sum(p.numel() for p in port.parameters()) < 2.02e8
    hints = key_hints(port)
    assert all(mmdet_key(k, **hints) for k in port.state_dict()
               if 'num_batches' not in k)


# -- the pipelines ------------------------------------------------------------

def _image(seed, h=90, w=120):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (h, w, 3)).astype(np.float32)


def _results(seed, boxes=True):
    r = {'img': _image(seed), 'img_shape': (90, 120, 3),
         'ori_shape': (90, 120, 3), '_rng': np.random.RandomState(seed)}
    if boxes:
        r.update(gt_bboxes=np.array([[10, 12, 50, 60], [70, 5, 115, 40],
                                     [2, 70, 20, 88]], np.float32),
                 gt_bboxes_ignore=np.zeros((0, 4), np.float32),
                 gt_labels=np.array([1, 5, 2], np.int64))
    return r


def _same(a, b):
    assert sorted(k for k in a if k != '_rng') == sorted(
        k for k in b if k != '_rng')
    for k in a:
        if k == '_rng':
            continue
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif isinstance(a[k], dict):
            assert a[k].keys() == b[k].keys(), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_transforms_under_one_seed(seed):
    """``PhotoMetricDistortion`` and ``RandomCenterCropPad`` (training and
    test mode) give JAX's results bit for bit from the same
    ``results['_rng']``."""
    from dynamask_tpu.data import transforms as jt
    from dynamask_torch.data import transforms as pt
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
    for make in (lambda m: m.PhotoMetricDistortion(),
                 lambda m: m.RandomCenterCropPad(
                     crop_size=(63, 63), ratios=(0.6, 0.8, 1.0, 1.3),
                     border=32, **norm),
                 lambda m: m.RandomCenterCropPad(
                     test_mode=True, test_pad_mode=('logical_or', 127),
                     **norm),
                 lambda m: m.RandomCenterCropPad(
                     test_mode=True, test_pad_mode=('size_divisor', 32),
                     **norm)):
        a = make(jt)(_results(seed))
        b = make(pt)(_results(seed))
        _same(a, b)
        assert a['_rng'].randint(1 << 30) == b['_rng'].randint(1 << 30)


@pytest.mark.parametrize('which', ['train', 'test'])
def test_config_pipelines_under_one_seed(which):
    """The CornerNet file's train pipeline (distortion, crop, resize to
    511x511, flip, normalise, the formatting no-ops) and its test pipeline
    from the loaded image on: JAX's results bit for bit."""
    from dynamask_tpu.data.transforms import Compose as JCompose
    from dynamask_torch.data.transforms import Compose
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', CORNER_FILES[2]))
    pipeline = cfg.data[which]['pipeline'][1:]
    if which == 'train':
        pipeline = pipeline[1:]
    for seed in (4, 5):
        a = JCompose(copy.deepcopy(pipeline))(_results(seed, which == 'train'))
        b = Compose(copy.deepcopy(pipeline))(_results(seed, which == 'train'))
        _same(a, b)
        assert a['img'].shape[:2] == ((511, 511) if which == 'train' else
                                      (383, 511))


# -- the JAX package's faults -------------------------------------------------

def test_hourglass_canvas_3bq():
    """3bq: each hourglass level adds ``up1`` to its halved branch
    upsampled twice (``hourglass.py:98-99``), so the stride-4 map must
    halve evenly ``downsample_times`` times. The toy at 64x60 (a 16x15
    stride-4 map) fails in JAX with a ``TypeError``; the port raises a
    ``ValueError`` naming 3bq and both shapes. Hourglass-104 at the COCO
    canvas 800x1344 (200x336 at stride 4) and at the 511x341 that the test
    pipeline gives a 640x427 image fail the same way; at 511x511 (128x128)
    it runs."""
    from test_cornernet import corner_toy_cfg
    from dynamask_tpu.models.hourglass import HourglassNet as JHourglass
    from dynamask_torch.models.hourglass import HourglassNet
    det, variables, port = twin()
    x = np.zeros((1, 64, 60, 3), np.float32)
    with pytest.raises(TypeError, match='incompatible shapes'):
        det.apply(variables, jnp.asarray(x), method='extract_feat')
    with pytest.raises(ValueError, match='3bq'), torch.no_grad():
        port.backbone(_t(x.transpose(0, 3, 1, 2)))
    spec = dict(downsample_times=5, num_stacks=1, stage_channels=(8,) * 6,
                stage_blocks=(1,) * 6, feat_channel=8)
    for (h, w), ok in (((800, 1344), False), ((341, 511), False),
                       ((511, 511), True)):
        shape = jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32)
        if ok:
            jax.eval_shape(lambda a: JHourglass(**spec).init(
                jax.random.PRNGKey(0), a), shape)
        else:
            with pytest.raises(TypeError, match='incompatible shapes'):
                jax.eval_shape(lambda a: JHourglass(**spec).init(
                    jax.random.PRNGKey(0), a), shape)
    with torch.device('meta'):
        net = HourglassNet(**spec)
        assert net(torch.zeros(1, 3, 511, 511))[0].shape[-2:] == (128, 128)
        with pytest.raises(ValueError, match=r'\(13, 21\).*\(14, 22\).*3bq'):
            net(torch.zeros(1, 3, 800, 1344))
    assert corner_toy_cfg()[0]['backbone']['downsample_times'] == 2


def test_hourglass_low3_widths_3bv():
    """3bv: JAX's ``ResLayer`` builds every block of ``low3`` at the output
    width (``hourglass.py:53-69``), so a stage of two blocks that changes
    the width cannot add a block to its identity: JAX's Hourglass-104
    (``stage_blocks=[2, 2, 2, 2, 2, 4]``, 384 channels into 256) does not
    run. The port puts the change in the last block, as mmdet's
    ``downsample_first=False``; where JAX runs (one block a stage, the toy)
    the two are one function (``test_train_step``)."""
    from dynamask_tpu.models.hourglass import HourglassNet as JHourglass
    from dynamask_torch.models.hourglass import HourglassNet
    spec = dict(downsample_times=2, num_stacks=1, stage_channels=(16, 16, 24),
                stage_blocks=(2, 2, 2), feat_channel=16)
    with pytest.raises(TypeError, match='incompatible shapes'):
        jax.eval_shape(lambda a: JHourglass(**spec).init(
            jax.random.PRNGKey(0), a),
            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    net = HourglassNet(**spec).eval()
    low3 = net.hourglass_modules[0].low2.low3
    assert [b.conv1.in_channels for b in low3] == [24, 24]
    assert [b.conv2.out_channels for b in low3] == [24, 16]
    with torch.no_grad():
        assert net(torch.zeros(1, 3, 64, 64))[0].shape == (1, 16, 16, 16)


class _Stop(Exception):
    pass


def test_sgd_for_adam_3br():
    """3br: JAX's trainer reads no ``optimizer.type``, no
    ``optimizer.grad_clip`` and no ``lr_config.warmup``
    (``dynamask_tpu/apis/train.py:134-150``): the CornerNet file's Adam at
    lr 5e-4 trains as SGD at momentum 0.9, weight decay 0, no clip, with
    500 warmup iterations. The port's optimizer is the same; another type
    is refused by name."""
    import flax.linen as nn
    import dynamask_tpu.apis.train as japi
    from dynamask_tpu.utils.config import Config as JConfig
    from dynamask_torch.engine.optimizer import build_optimizer
    from dynamask_torch.utils.config import Config
    path = os.path.join(ROOT, 'configs', CORNER_FILES[2])

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, batch):
            return nn.Dense(1)(batch['image'].reshape(1, -1))

    seen = {}

    def capture(params, **kw):
        seen.update(kw)
        raise _Stop

    batch = {'image': np.zeros((1, 4, 4, 3), np.float32)}
    patches = dict(
        build_dataset=lambda *a, **k: [0],
        build_dataloader=lambda *a, **k: [batch] * 10,
        build_detector=lambda *a, **k: types.SimpleNamespace(
            init=Tiny().init, backbone=types.SimpleNamespace(
                frozen_param_paths=lambda: ())),
        build_optimizer=capture)
    saved = {k: getattr(japi, k) for k in patches}
    for k, v in patches.items():
        setattr(japi, k, v)
    try:
        with pytest.raises(_Stop), contextlib.suppress(OSError):
            import tempfile
            with tempfile.TemporaryDirectory() as d:
                japi.train_detector(JConfig.fromfile(path), work_dir=d,
                                    validate=False)
    finally:
        for k, v in saved.items():
            setattr(japi, k, v)
    assert (seen['momentum'], seen['weight_decay'],
            seen['grad_clip_norm']) == (0.9, 0.0, None)
    cfg = Config.fromfile(path)
    assert cfg.optimizer['type'] == 'Adam' and cfg.lr_config['warmup'] is None
    model = torch.nn.Linear(2, 1)
    opt = build_optimizer(model, cfg.optimizer, cfg.get('optimizer_config'),
                          cfg.get('lr_config'), steps_per_epoch=10)
    assert isinstance(opt.sgd, torch.optim.SGD)
    assert opt.grad_clip_norm is None
    assert opt.sgd.defaults['momentum'] == 0.9
    for step in (0, 250, 499, 500, 1799, 1800):
        # JAX's schedule in fp32
        assert opt.lr_schedule(step) == pytest.approx(
            float(seen['lr_schedule'](step)), rel=1e-4), step
    assert opt.lr_schedule(0) == pytest.approx(5e-7)
    with pytest.raises(NotImplementedError, match="'AdamW'.*3br"):
        build_optimizer(model, dict(cfg.optimizer, type='AdamW'), None, None,
                        steps_per_epoch=10)


def test_jax_importer_skips_the_rest_of_item9_3bs():
    """3bs: the JAX importer (``dynamask_tpu/engine/pretrained.py:120``) has
    no rule for the C4 shared head, the DeformRoIPool extractor,
    HourglassNet or the ``CornerHead``: an mmdet checkpoint leaves them at
    init; the port's key map carries them (``test_key_map_both_ways`` here
    and in the C4 and DeformRoIPool files)."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    parts = {'mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py':
             'roi_head.shared_head.',
             'dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py':
             'roi_head.bbox_roi_extractor.',
             CORNER_FILES[2]: ''}
    for rel, part in parts.items():
        cfg = Config.fromfile(os.path.join(ROOT, 'configs', rel))
        keys = [k for k in build_detector(
            cfg['model'], cfg.get('train_cfg'), cfg.get('test_cfg'),
            device='meta').state_dict() if k.startswith(part) and
            'num_batches' not in k]
        assert keys and all(_mmdet_key(k) is None for k in keys), rel


def test_heatmap_loss_is_a_mean_3bu():
    """3bu: JAX reduces the Gaussian focal loss to its mean over every cell
    (``losses.py:332``, ``weight_reduce_loss`` without weights) before
    dividing by the peak count (``cornernet.py:276-284``); mmdet's sums
    the cells. The toy step's ``det_loss`` is the per-cell sum over
    B·C·H·W; the port computes JAX's."""
    from dynamask_torch.models.cornernet import corner_targets
    from dynamask_torch.models.losses import gaussian_focal_loss
    port_log, jax_log, _, _ = train_step()
    det, variables, port = twin()
    batch = _demo()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _, outs = copy.deepcopy(port).train().head(b)
        tgt = corner_targets(b['gt_boxes'], b['gt_labels'], b['gt_valid'],
                             16, 16, 64.0, 64.0, 8)
        summed = 0.0
        for lvl in outs:
            for heat, t in ((lvl[0], tgt['tl_heat']), (lvl[1],
                                                       tgt['br_heat'])):
                avg = (t == 1).sum().clamp(min=1)
                summed += float((gaussian_focal_loss(
                    torch.sigmoid(heat), t, avg_factor=avg)) / 2)
    cells = 2 * 8 * 16 * 16
    assert summed == pytest.approx(jax_log['det_loss'] * cells, rel=1e-4)
    assert port_log['det_loss'] == pytest.approx(jax_log['det_loss'],
                                                 rel=1e-4)
