"""The C4 detectors on the CPU: the PyTorch port against the JAX package on
the same seeded inputs and draws, the JAX weights carried across by
``dynamask_torch.engine.convert``; where JAX reaches RoIAlign it runs its
XLA form.

- The toys: a caffe ResNet-18 cut after its first stage (``num_stages=1``,
  ``strides=(1,)``, 64 channels at stride 4) with no neck, an RPN of 15
  anchors a cell on that one level, RoIAlign to 14x14 and a ``ResLayer``
  shared head at the next stage (``stage=1``: two Bottlenecks to 512
  channels at 7x7) before the plain avg-pooled ``BBoxHead`` and, for Mask
  R-CNN, an ``FCNMaskHead`` with ``num_convs=0``: Faster R-CNN, Mask
  R-CNN and the RPN alone, as the three ``*_r50_caffe_c4_1x_coco.py``
  files build them at full width.
- The modules: ResNet's ``strides`` / ``dilations`` (a dilated stage 3) in
  eval and training mode, the shared head with its BatchNorms on running
  statistics in training mode, ``BBoxHead`` and the deconv-only mask head;
  fp32, within 1e-5 relative L2.
- ``simple_test`` slot for slot (dets within 1e-4 of the largest
  coordinate, labels and validity exact, mask probabilities within 2e-4) and one ``forward_train`` with
  the samplers' draws injected: every loss within 1e-4 relative, every
  parameter's gradient within 1e-3 relative L2 (fp32, as the other
  two-stage parity tests); the K2 / K4 calls a path.
- The three config files built on the ``meta`` device as JAX builds them,
  every key mapped; the shared head's BatchNorm affine trains under
  ``requires_grad=False`` (3j).
"""

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

from test_torch_port_cascade import _port_grads, counted_crops  # noqa: E402
from test_torch_port_item6_ssd import draw_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ANCHORS = 15 * 16 * 16     # 15 anchors a cell of the 16x16 stride-4 map
G = 3                        # the demo batch's GTs
P = 32                       # the toy's training proposals an image
DET_RTOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
KINDS = ('faster', 'mask', 'rpn')
C4_FILES = {'faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py': 'FasterRCNN',
            'mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py': 'MaskRCNN',
            'rpn/rpn_r50_caffe_c4_1x_coco.py': 'RPN'}


def c4_toy_cfg(kind):
    """(model, train_cfg, test_cfg) of the C4 toy ``kind``."""
    from test_models import mini_mask_rcnn_cfg
    _, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    norm = dict(type='BN', requires_grad=False)
    coder = dict(type='DeltaXYWHBBoxCoder', target_means=[0., 0., 0., 0.],
                 target_stds=[0.1, 0.1, 0.2, 0.2])
    crop = dict(type='SingleRoIExtractor', roi_layer=dict(
        type='RoIAlign', output_size=14, sampling_ratio=0), out_channels=64,
        featmap_strides=[4])
    model = dict(
        type={'faster': 'FasterRCNN', 'mask': 'MaskRCNN', 'rpn': 'RPN'}[kind],
        backbone=dict(type='ResNet', depth=18, num_stages=1, strides=(1,),
                      dilations=(1,), out_indices=(0,), frozen_stages=0,
                      norm_cfg=norm, norm_eval=True, style='caffe'),
        rpn_head=dict(
            type='RPNHead', in_channels=64, feat_channels=64,
            anchor_generator=dict(type='AnchorGenerator',
                                  scales=[2, 4, 8, 16, 32],
                                  ratios=[0.5, 1.0, 2.0], strides=[4]),
            bbox_coder=dict(coder, target_stds=[1.0, 1.0, 1.0, 1.0]),
            loss_cls=dict(type='CrossEntropyLoss', use_sigmoid=True,
                          loss_weight=1.0),
            loss_bbox=dict(type='L1Loss', loss_weight=1.0)),
        roi_head=dict(
            type='StandardRoIHead',
            shared_head=dict(type='ResLayer', depth=18, stage=1, stride=2,
                             dilation=1, style='caffe', norm_cfg=norm,
                             norm_eval=True),
            bbox_roi_extractor=crop,
            bbox_head=dict(
                type='BBoxHead', with_avg_pool=True, roi_feat_size=7,
                in_channels=512, num_classes=8, bbox_coder=coder,
                reg_class_agnostic=False,
                loss_cls=dict(type='CrossEntropyLoss', use_sigmoid=False,
                              loss_weight=1.0),
                loss_bbox=dict(type='L1Loss', loss_weight=1.0))))
    if kind == 'mask':
        model['roi_head'].update(
            mask_roi_extractor=dict(crop),
            mask_head=dict(type='FCNMaskHead', num_convs=0, in_channels=512,
                           conv_out_channels=32, num_classes=8,
                           loss_mask=dict(type='CrossEntropyLoss',
                                          use_mask=True, loss_weight=1.0)))
    if kind == 'rpn':
        model['roi_head'] = None
    return model, train_cfg, test_cfg


def _demo(b=1):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(
        0, b=b, h=64, w=64, g=G, s=16).items()}


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its drawn variables, the port loaded from
    them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = c4_toy_cfg(kind)
    det = jax_build(*copy.deepcopy(cfg))
    variables = draw_variables(det, _demo())
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


# -- modules -----------------------------------------------------------------

def _nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_strides_and_dilations():
    """``num_stages=3`` at ``strides=(1, 2, 1)`` and ``dilations=(1, 1,
    2)`` (a stride-8 ``layer3`` with its 3x3s at dilation 2, padding 2):
    the port's ResNet against JAX's in eval and in training mode (batch
    statistics), within 1e-5 relative L2."""
    from dynamask_tpu.models import ResNet as JResNet
    from dynamask_torch.engine.convert import _resnet_key, _torch_layout
    from dynamask_torch.models.resnet import ResNet
    x = np.random.RandomState(4).randn(2, 48, 40, 3).astype(np.float32)
    kw = dict(depth=18, num_stages=3, strides=(1, 2, 1), dilations=(1, 1, 2),
              out_indices=(1, 2), norm_eval=False)
    jnet = JResNet(block_remat=False, **kw)
    v = draw_variables(types.SimpleNamespace(
        init=lambda rngs, b: jnet.init(rngs, b['x'])), {'x': x}, seed=3)
    net = ResNet(**kw)
    assert net.layer3[0].conv1.dilation == (2, 2)
    assert net.layer3[0].conv1.padding == (2, 2)
    with torch.no_grad():
        for k, t in net.state_dict().items():
            if not k.endswith('num_batches_tracked'):
                path, leaf = _resnet_key(k)
                t.copy_(torch.from_numpy(_torch_layout(
                    v['params'], v['batch_stats'], path, leaf, {})))
    for train in (False, True):
        ref = jnet.apply(v, jnp.asarray(x), train=train,
                         mutable=['batch_stats'])[0]
        with torch.no_grad():
            got = net.train(train)(_nhwc(x))
        assert [tuple(g.shape[2:]) for g in got] == [(6, 5), (6, 5)]
        for g, r in zip(got, ref):
            r = np.asarray(r).transpose(0, 3, 1, 2)
            assert rel_l2(g.numpy(), r) < 1e-5, train


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_shared_head_bbox_head_and_mask_head(mode):
    """The shared head (two caffe Bottlenecks at stride 2, its BatchNorms
    on running statistics in training mode too: ``norm_eval``), then the
    avg-pooled ``BBoxHead`` and the deconv-only mask head on 14x14 crops,
    against JAX's RoI head modules within 1e-5 relative L2."""
    det, variables, port = twin('mask')
    rh = det.roi_head
    x = np.random.RandomState(5).randn(6, 14, 14, 64).astype(np.float32)
    train = mode == 'train'

    def body(m, x):
        y = m.shared_head(x, train=train)
        return y, m.bbox_head(y, train=train), m.mask_head(y, train=train)

    rv = {c: v['roi_head'] for c, v in variables.items() if 'roi_head' in v}
    y, (cls, reg), mask = jax.device_get(jax.jit(
        lambda v, x: rh.apply(v, x, method=body))(rv, jnp.asarray(x)))
    prh = port.roi_head.train(train)
    with torch.no_grad():
        py = prh.shared_head(_nhwc(x))
        pcls, preg = prh.bbox_head(py.permute(0, 2, 3, 1).contiguous())
        pmask = prh.mask_head(py)
    prh.eval()
    assert py.shape == (6, 512, 7, 7) and pmask.shape == (6, 8, 14, 14)
    assert rel_l2(py.numpy(), y.transpose(0, 3, 1, 2)) < 1e-5
    assert rel_l2(pcls.numpy(), cls) < 1e-5
    assert rel_l2(preg.numpy(), reg) < 1e-5
    assert rel_l2(pmask.numpy(), mask.transpose(0, 3, 1, 2)) < 1e-5


# -- detectors ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def outputs(kind):
    det, variables, port = twin(kind)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch_np = {k: _demo(2)[k] for k in keys}
    batch_np['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch_np.items()})
    return ref, got


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    """Dets, labels and validity slot for slot; the mask probabilities of
    the valid slots (14x14: the shared head halves the 14x14 crop, the
    deconv doubles it)."""
    _, _, port = twin(kind)
    assert type(port).__name__ == {'faster': 'FasterRCNN', 'mask': 'MaskRCNN',
                                   'rpn': 'RPN'}[kind]
    ref, got = outputs(kind)
    assert (ref['det_valid'].sum(1) >= 3).all()
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    scale = np.abs(ref['dets'][..., :4]).max()
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=0,
                               atol=DET_RTOL * scale)
    assert ('mask_probs' in got) == ('mask_probs' in ref) == (kind == 'mask')
    if kind == 'mask':
        v = ref['det_valid'].astype(bool)
        probs = got['mask_probs'].numpy()
        assert probs.shape[2:] == (14, 14) and probs[v].std() > 1e-2
        np.testing.assert_allclose(probs[v], ref['mask_probs'][v], atol=2e-4)


@functools.lru_cache(maxsize=None)
def train_step(kind):
    """One step's logs and gradients on both sides from the same variables
    and draws (the RPN's and the RoI sampler's priority tables); the JAX
    gradients in the port's layout through the port's key map; the crop
    forwards and backwards the port's step ran."""
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


LOSSES = {'faster': {'loss_cls', 'loss_bbox', 'acc'},
          'mask': {'loss_cls', 'loss_bbox', 'acc', 'loss_mask'}, 'rpn': set()}


@pytest.mark.parametrize('kind', KINDS)
def test_train_step(kind):
    """Every loss within 1e-4 of JAX's and every parameter's gradient
    within 1e-3 relative L2; the shared head's and the heads' leaves get
    one, the frozen stem none."""
    port_log, jax_log, got, ref, _ = train_step(kind)
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    assert keys == LOSSES[kind] | {'loss_rpn_cls', 'loss_rpn_bbox', 'loss'}
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
        if k != 'acc':
            assert jax_log[k] > 0, k
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
    assert not got['backbone.conv1.weight'].any()
    assert got['backbone.layer1.0.conv1.weight'].any()
    if kind != 'rpn':
        assert ref['roi_head.shared_head.layer2.1.conv2.weight'].any()


@pytest.mark.parametrize('kind,calls', [('faster', (1, 1, 1)),
                                        ('mask', (2, 2, 2)),
                                        ('rpn', (0, 0, 0))])
def test_crop_calls_per_path(kind, calls):
    """K2 an image and K2 / K4 a step (``chip_smoke.py`` phase 21): the box
    crop, and on Mask R-CNN the mask crop, one launch each; none on the
    RPN."""
    _, _, port = twin(kind)
    infer, k2, k4 = calls
    batch = _demo()
    with counted_crops() as counts, torch.no_grad():
        port.simple_test({k: torch.from_numpy(batch[k]) for k in
                          ('image', 'img_shape', 'scale_factor')})
    assert counts == {'fwd': infer, 'bwd': 0}
    assert train_step(kind)[4] == {'fwd': k2, 'bwd': k4}


def test_key_map_both_ways():
    """Every port tensor of the Mask R-CNN toy has one JAX leaf, and every
    JAX leaf is reached (the shared head's among them)."""
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    det, variables, port = twin('mask')

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
        path, leaf, h = mmdet_key(k, **hints)
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


# -- the config files and the faults -----------------------------------------

def _config(rel):
    from dynamask_torch.utils.config import Config
    return Config.fromfile(os.path.join(ROOT, 'configs', rel))


@pytest.mark.parametrize('rel', sorted(C4_FILES))
def test_c4_configs_as_jax_builds_them(rel):
    """Each C4 file builds on the ``meta`` device as JAX's builder reads
    it: the stride-16 layer3 at 1024 channels, no neck, the RPN's 15
    anchors a cell, the shared head (res5, 2048 channels) before the
    avg-pooled box head and the deconv-only mask head; every key mapped."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    from dynamask_torch.models import build_detector
    cfg = _config(rel)
    port = build_detector(cfg['model'], cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')
    assert type(port).__name__ == C4_FILES[rel]
    jdet = jax_build(cfg['model'], cfg.get('train_cfg'), cfg.get('test_cfg'))
    assert not hasattr(port.backbone, 'layer4')
    assert port.backbone.layer3[0].conv1.stride == (2, 2)
    assert port.rpn_head.rpn_cls.out_channels == 15
    assert port.rpn_max_num == jdet.rpn_max_num
    if C4_FILES[rel] != 'RPN':
        rh, jrh = port.roi_head, jdet.roi_head
        assert (rh.featmap_strides, rh.bbox_roi_out, rh.mask_roi_out) == (
            tuple(jrh.featmap_strides), jrh.bbox_roi_out, jrh.mask_roi_out)
        assert len(rh.shared_head.layer4) == 3
        assert rh.shared_head.layer4[0].conv1.stride == (2, 2)
        assert rh.shared_head.out_channels == 2048
        assert rh.bbox_head.fc_cls.in_features == 2048
        assert len(rh.bbox_head.shared_fcs) == 0
        if rh.mask_head is not None:
            assert len(rh.mask_head.convs) == 0
            assert rh.mask_head.upsample.in_channels == 2048
    hints = key_hints(port)
    assert all(mmdet_key(k, **hints) for k in port.state_dict()
               if 'num_batches' not in k)


def test_shared_head_bn_affine_trains_3j():
    """3j at the shared head: JAX pops its ``norm_cfg``
    (``builder.py:355-361``), so under ``requires_grad=False`` the res5
    BatchNorms' scale and bias get a gradient in JAX's step, and train in
    the port's; their running statistics stay (``norm_eval``)."""
    _, _, got, ref, _ = train_step('faster')
    for k in ('roi_head.shared_head.layer2.0.bn1.weight',
              'roi_head.shared_head.layer2.1.bn3.bias'):
        assert ref[k].any() and got[k].any(), k
    _, _, port = twin('faster')
    m = copy.deepcopy(port).train()
    assert all(p.requires_grad for p in m.roi_head.shared_head.parameters())
    assert not any(b.training for b in m.roi_head.shared_head.modules()
                   if isinstance(b, torch.nn.BatchNorm2d))
