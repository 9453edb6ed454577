"""DetectoRS in the port against the JAX package, on the CPU
(``dynamask_torch/models/detectors_resnet.py`` and ``necks_extra.py``
against ``dynamask_tpu/models/detectors_resnet.py`` and
``necks_extra.py``; the JAX weights carried across by
``dynamask_torch.engine.convert``).

- ``SAConv`` at stride 1 with deformable branches (dilations 1 and 3:
  K1/K3's plain versions, window 3), at stride 2 (the exact gather) and
  plain with groups: the output within 1e-5 and every gradient (the
  input's, the kernel's, ``weight_diff``'s, the switch's, the contexts'
  and the offset convs') within 1e-4 relative L2 of ``jax.grad``.
- 3f reaching SAC: from the zero init the stride-1 offset convs get
  exactly zero gradient on both sides, the strided ones do not (3ak).
- ``ASPP`` against JAX's within 1e-5.
- A toy DetectoRS cascade (the toy Cascade Mask R-CNN of
  ``tests/test_torch_port_cascade.py`` on the DetectoRS ResNet of
  ``tests/test_detectors_rs.py`` with deformable SAC and a two-step RFP
  with ASPP): ``simple_test`` slot for slot (dets ``rtol=1e-5,
  atol=1e-4``, labels and validity exact), one ``forward_train`` with
  every sampler's draws injected: each loss within 1e-4 relative, every
  parameter's gradient within 1e-3 relative L2.
- The JAX faults 3at (``conv_cfg=ConvAWS`` dropped, its affine refused on
  load), 3av (no ``frozen_param_paths``) and 3aw (SAC where a file names
  none), the phase-17 DetectoRS configs built on the CPU, the keys
  refused.
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

from test_detectors_rs import detectors_toy_cfg  # noqa: E402
from test_torch_port_cascade import (_demo, _port_grads, _tables,  # noqa
                                     _want_keys, port_noise)
from test_torch_port_cascade import toy_cfg as cascade_cfg  # noqa: E402
from test_torch_port_modules import randomize_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
SAC_KINDS = {'stride1_deform': (1, True, 1), 'stride2_deform': (2, True, 1),
             'stride1_plain_groups': (1, False, 2)}
SAC_GAIN = 30.0
SAC_LEAVES = ('pre_context', 'post_context', 'switch', 'offset_s',
              'offset_l')


def load_sac(port, params):
    """The JAX ``SAConv``'s parameters into the port's module."""
    def oihw(a):
        return torch.from_numpy(np.asarray(a).transpose(3, 2, 0, 1).copy())

    with torch.no_grad():
        port.weight.copy_(oihw(params['weight']))
        port.weight_diff.copy_(oihw(params['weight_diff']))
        for name in SAC_LEAVES:
            if name in params:
                conv = getattr(port, name)
                conv.weight.copy_(oihw(params[name]['kernel']))
                conv.bias.copy_(torch.from_numpy(np.asarray(
                    params[name]['bias'])))


@functools.lru_cache(maxsize=None)
def sac_pair(kind, zero_offsets=False):
    """The JAX ``SAConv`` (C 8 -> 8) of ``kind`` on a 2x11x14 input, its
    randomised parameters (``weight_diff`` N(0, 0.1); the offset convs
    zero with ``zero_offsets``, as initialised), the output and the
    gradients of a seeded cotangent; the port's module loaded from
    them."""
    from dynamask_tpu.models.detectors_resnet import SAConv as JSAC
    from dynamask_torch.models.detectors_resnet import SAConv
    stride, deform, groups = SAC_KINDS[kind]
    rng = np.random.RandomState(7)
    x = rng.normal(size=(2, 11, 14, 8)).astype(np.float32)
    m = JSAC(8, stride=stride, use_deform=deform, groups=groups)
    params = jax.device_get(m.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        'params'])
    params = jax.device_get(randomize_variables({'params': params},
                                                seed=3)['params'])
    params['weight_diff'] = rng.normal(
        0, 0.1, params['weight_diff'].shape).astype(np.float32)
    for name in ('offset_s', 'offset_l'):
        if name in params:
            k = params[name]['kernel']
            params[name] = dict(
                kernel=np.zeros_like(k) if zero_offsets else
                rng.normal(0, 0.3, k.shape).astype(np.float32),
                bias=np.zeros_like(params[name]['bias']) if zero_offsets
                else params[name]['bias'])
    out = np.asarray(jax.jit(m.apply)({'params': params}, jnp.asarray(x)))
    cot = rng.normal(size=out.shape).astype(np.float32)
    grads = jax.device_get(jax.jit(jax.grad(lambda p, x_: jnp.sum(m.apply(
        {'params': p}, x_) * cot), argnums=(0, 1)))(params, jnp.asarray(x)))
    port = SAConv(8, 8, stride, 1, deform, groups)
    load_sac(port, params)
    return x, cot, out, grads, port


def _port_sac(port, x, cot):
    port = copy.deepcopy(port)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = port(xt)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    return port, out.permute(0, 2, 3, 1).detach().numpy(), xt.grad


@pytest.mark.parametrize('kind', sorted(SAC_KINDS))
def test_sac_forward(kind):
    """The SAC output within 1e-5 of JAX's (stride 2: a 6x7 map)."""
    x, cot, out, _, port = sac_pair(kind)
    _, got, _ = _port_sac(port, x, cot)
    assert got.shape == out.shape
    np.testing.assert_allclose(got, out, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('kind', sorted(SAC_KINDS))
def test_sac_gradients(kind):
    """Every gradient within 1e-4 relative L2 of ``jax.grad``: the input,
    the kernel, ``weight_diff``, the switch, the contexts and (deformable)
    both offset convs."""
    x, cot, _, (gp, gx), port = sac_pair(kind)
    net, _, dx = _port_sac(port, x, cot)
    pairs = {'x': (dx.permute(0, 2, 3, 1).numpy(), gx)}
    for name in ('weight', 'weight_diff'):
        pairs[name] = (getattr(net, name).grad.numpy(),
                       np.asarray(gp[name]).transpose(3, 2, 0, 1))
    for name in SAC_LEAVES:
        if name in gp:
            conv = getattr(net, name)
            pairs[name] = (conv.weight.grad.numpy(), np.asarray(
                gp[name]['kernel']).transpose(3, 2, 0, 1))
            pairs[name + '.bias'] = (conv.bias.grad.numpy(),
                                     np.asarray(gp[name]['bias']))
    assert len(pairs) == (13 if SAC_KINDS[kind][1] else 9)
    for name, (got, ref) in pairs.items():
        assert np.abs(ref).max() > 0, name
        assert rel_l2(got, ref) < 1e-4, (name, rel_l2(got, ref))


@pytest.mark.parametrize('kind', ['stride1_deform', 'stride2_deform'])
def test_sac_offsets_from_zero_3f(kind):
    """3f reaches SAC: from the zero init the stride-1 branches' offset
    convs get exactly zero gradient on both sides (the windowed VJP at
    integer displacements, dilations 1 and 3 alike), so they never train;
    the strided ones get JAX's tie-rule gradient (3ak), non-zero and
    within 1e-4 relative L2."""
    x, cot, _, (gp, _), port = sac_pair(kind, zero_offsets=True)
    net, _, _ = _port_sac(port, x, cot)
    for name in ('offset_s', 'offset_l'):
        got = net.__getattr__(name).weight.grad.numpy()
        ref = np.asarray(gp[name]['kernel']).transpose(3, 2, 0, 1)
        if kind == 'stride1_deform':
            assert not got.any() and not ref.any(), name
        else:
            assert np.abs(ref).max() > 0
            assert rel_l2(got, ref) < 1e-4, (name, rel_l2(got, ref))


def test_aspp_matches_jax():
    """ASPP (dilations 1, 3, 6 and the global branch, 8 channels each)
    within 1e-5 of JAX's on a 2x9x12x16 map."""
    from dynamask_tpu.models.necks_extra import ASPP as JASPP
    from dynamask_torch.models.necks_extra import ASPP
    rng = np.random.RandomState(2)
    x = rng.normal(size=(2, 9, 12, 16)).astype(np.float32)
    m = JASPP(8)
    params = jax.device_get(randomize_variables(m.init(
        jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)['params'])
    ref = np.asarray(m.apply({'params': params}, jnp.asarray(x)))
    port = ASPP(16, 8)
    with torch.no_grad():
        for i, conv in enumerate(port.aspp):
            p = params[f'aspp_{i}']
            conv.weight.copy_(torch.from_numpy(np.asarray(
                p['kernel']).transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(np.asarray(p['bias'])))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 32, 9, 12)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)


# -- the toy DetectoRS cascade ------------------------------------------------


def toy_cfg():
    """The toy Cascade Mask R-CNN (32-channel FPN, 8 classes, 64x64) on
    ``tests/test_detectors_rs.py``'s DetectoRS ResNet (depth 18 in
    bottlenecks) with deformable SAC in stages 2-4 and a two-step RFP, its
    ASPP 8 channels a branch."""
    model, train_cfg, test_cfg = cascade_cfg('cascade')
    rs = detectors_toy_cfg()[0]
    model['backbone'] = copy.deepcopy(rs['backbone'])
    model['neck'] = copy.deepcopy(rs['neck'])
    for bb in (model['backbone'], model['neck']['rfp_backbone']):
        bb['sac'] = dict(type='SAC', use_deform=True)
    model['neck'].update(out_channels=32, aspp_out_channels=8)
    model['neck']['rfp_backbone']['rfp_inplanes'] = 32
    return model, train_cfg, test_cfg


@functools.lru_cache(maxsize=None)
def twin():
    """(JAX toy detector, its randomised variables, the port loaded from
    them). The randomised offset convs make the SAC offsets non-trivial,
    the gates and feedback convs non-zero. Scaled so the random net does
    not amplify the two sides' rounding past the tolerances (at the
    randomiser's scale it turns a 1e-7 change of its input into 1e-2 by
    the neck, on either side alone): each block's last BN scale at a
    tenth, the SAC blocks' ``bn2`` variance raised by ``SAC_GAIN ** 2``
    (the standardised kernel has unit deviation, ~sqrt(9 C) times a He
    kernel's)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg()
    det = jax_build(*cfg)
    batch = {k: jnp.asarray(v) for k, v in _demo().items()}
    variables = randomize_variables(
        jax.jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    params, stats = variables['params'], variables['batch_stats']
    for tree, tree_stats in ((params['backbone'], stats['backbone']), (
            params['neck']['rfp_backbones_0'],
            stats['neck']['rfp_backbones_0'])):
        for name, block in tree.items():
            if 'bn3' in block:
                block['bn3']['scale'] = block['bn3']['scale'] * 0.1
            if 'sac_conv2' in block:
                tree_stats[name]['bn2']['var'] = \
                    tree_stats[name]['bn2']['var'] * SAC_GAIN ** 2
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


def test_toy_detectors_modules():
    """The toy's port has JAX's structure: SAC in stages 2-4 of both
    backbones with both offset convs, the RFP's feedback conv on each
    stage's first block of the second backbone only, the RFP's ASPP and
    gate."""
    from dynamask_torch.models.detectors_resnet import SAConv
    from dynamask_torch.models.necks_extra import RFP
    _, variables, port = twin()
    assert isinstance(port.neck, RFP) and len(port.neck.rfp_modules) == 1
    sac = [n for n, m in port.named_modules() if isinstance(m, SAConv)]
    assert len(sac) == 2 * 6 and all(
        hasattr(port.get_submodule(n), 'offset_l') for n in sac)
    rfp = sorted(n for n, _ in port.named_modules() if n.endswith('rfp_conv'))
    assert rfp == [f'neck.rfp_modules.0.layer{s}.0.rfp_conv'
                   for s in (2, 3, 4)]
    neck = variables['params']['neck']
    assert {'fpn', 'rfp_aspp', 'rfp_weight', 'rfp_backbones_0'} <= set(neck)


def test_simple_test():
    """Dets, labels, validity and 28x28 mask probabilities slot for slot,
    two images with a non-unit scale factor."""
    det, variables, port = twin()
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch = {k: _demo(2)[k] for k in keys}
    batch['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert ref['det_valid'].sum() >= 8
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    probs = got['mask_probs'].numpy()
    assert probs.std() > 1e-2
    np.testing.assert_allclose(probs, ref['mask_probs'], atol=2e-4)


@functools.lru_cache(maxsize=None)
def train_step():
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin()
    port = copy.deepcopy(port).train()
    batch = _demo()
    tables = _tables()

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax_sampler_priorities(tables):
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables['batch_stats'],
            {k: jnp.asarray(x) for k, x in batch.items()})
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()},
        port_noise(tables)))
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


def test_train_losses():
    """Every loss of the cascade's step within 1e-4 relative of JAX's."""
    port_log, jax_log, _, _, _ = train_step()
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    assert keys == _want_keys('cascade') and keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)


def test_per_leaf_gradients():
    """Every parameter within 1e-3 relative L2 of JAX's gradient; the
    frozen stems and stage 1 of both backbones get none; the SAC kernels,
    ``weight_diff``, the switches, the contexts, the feedback convs, the
    ASPP and the gate get some; the stride-1 SAC offset convs' are zero
    on both sides only where their offsets are (here they are random)."""
    _, _, got, ref, frozen = train_step()
    compared, seen = 0, set()
    for k in ref:
        if k in frozen or not ref[k].any():
            assert not got[k].any() and (k not in frozen or
                                         not ref[k].any()), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
        compared += 1
        seen |= {s for s in ('conv2.weight', 'weight_diff', 'switch',
                             'pre_context', 'post_context', 'offset_s',
                             'offset_l', 'rfp_conv', 'rfp_aspp',
                             'rfp_weight') if s in k}
    assert any(k.startswith('neck.rfp_modules.0.layer1.') for k in frozen)
    assert any(k.startswith('backbone.layer1.') for k in frozen)
    assert compared >= 100, compared
    assert seen == {'conv2.weight', 'weight_diff', 'switch', 'pre_context',
                    'post_context', 'offset_s', 'offset_l', 'rfp_conv',
                    'rfp_aspp', 'rfp_weight'}, seen


# -- the configs, the faults and the refusals ---------------------------------

PHASE17 = ('cascade_rcnn_r50_sac_1x_coco.py', 'detectors_htc_r50_1x_coco.py',
           'htc_r50_rfp_1x_coco.py')


def _config(name):
    from dynamask_torch.utils.config import Config
    return Config.fromfile(os.path.join(ROOT, 'configs', 'detectors',
                                        name)).to_dict()


def _meta(cfg):
    from dynamask_torch.models import build_detector
    return build_detector(cfg['model'], cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')


@pytest.mark.parametrize('name', PHASE17)
def test_phase17_config_keys_through_the_jax_importer(name):
    """Each DetectoRS config of ``chip_smoke.py`` phase 17 builds with the
    options JAX's builder reads (SAC's deform flag, the RFP's steps and
    ASPP) and every state-dict key maps to a JAX path."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    from dynamask_torch.models.detectors_resnet import SAConv
    cfg = _config(name)
    port = _meta(cfg)
    jdet = jax_build(cfg['model'], cfg.get('train_cfg'), cfg.get('test_cfg'))
    deform = cfg['model']['backbone'].get('sac', {}).get('use_deform', False)
    assert jdet.backbone.sac_use_deform == deform
    sac = [m for m in port.modules() if isinstance(m, SAConv)]
    rfp = cfg['model']['neck']['type'] == 'RFP'
    # stages 2-4 of each backbone, SAC or not in the file (3aw)
    assert len(sac) == 13 * (2 if rfp else 1)
    assert all(m.use_deform == deform for m in sac)
    if rfp:
        assert len(port.neck.rfp_modules) == len(jdet.neck.rfp_backbones)
    hints = key_hints(port)
    keys = [k for k in port.state_dict() if 'num_batches' not in k]
    assert all(mmdet_key(k, **hints) for k in keys)


def test_conv_aws_dropped_and_its_affine_refused_3at(tmp_path):
    """3at: ``conv_cfg=ConvAWS`` is dropped (JAX ``builder.py:116-131``
    reads none; ``detectors_resnet.py:128-160`` builds plain convs and SAC
    without ``weight_gamma`` / ``weight_beta``): the port builds the same
    plain convs, and an mmdet checkpoint's ``weight_gamma`` is refused on
    load by name, as is a ``conv_cfg`` other than ConvAWS."""
    from dynamask_torch.engine.pretrained import apply_pretrained
    from dynamask_torch.models import build_detector
    cfg = _config('cascade_rcnn_r50_sac_1x_coco.py')
    assert cfg['model']['backbone']['conv_cfg'] == {'type': 'ConvAWS'}
    port = _meta(cfg)
    assert type(port.backbone.layer1[0].conv2) is torch.nn.Conv2d
    small = copy.deepcopy(cfg)
    small['model']['backbone'].update(depth=50, stage_with_sac=(
        False, False, False, True))
    det = build_detector(small['model'], small.get('train_cfg'),
                         small.get('test_cfg'), device='cpu')
    path = tmp_path / 'aws.pth'
    sd = {k: v for k, v in det.state_dict().items()
          if k.startswith('backbone.layer4.0.')}
    sd['backbone.layer4.0.conv2.weight_gamma'] = torch.ones(512, 1, 1, 1)
    torch.save({'state_dict': sd}, path)
    with pytest.raises(ValueError, match='3at'):
        apply_pretrained(det, str(path))
    with pytest.raises(ValueError, match='3at'):
        det.load_state_dict(dict(det.state_dict(), **{
            'backbone.layer1.0.conv1.weight_beta': torch.zeros(64, 1, 1,
                                                               1)}),
            strict=False)
    bad = copy.deepcopy(cfg)
    bad['model']['backbone']['conv_cfg'] = {'type': 'ConvWS'}
    with pytest.raises(NotImplementedError, match='3w'):
        _meta(bad)


def test_jax_detectors_resnet_has_no_frozen_param_paths_3av():
    """3av: JAX's ``DetectoRSResNet`` has no ``frozen_param_paths``, which
    its ``train_detector`` calls on the backbone (``apis/train.py:149``),
    so the JAX trainer cannot build an optimizer for a DetectoRS config.
    The port freezes the stem and stage 1 of every DetectoRS backbone, the
    RFP's too, as its other backbones."""
    from dynamask_tpu.models.detectors_resnet import DetectoRSResNet
    assert not hasattr(DetectoRSResNet, 'frozen_param_paths')
    port = _meta(_config('detectors_htc_r50_1x_coco.py'))
    for bb in (port.backbone, port.neck.rfp_modules[0]):
        assert not any(p.requires_grad for p in bb.layer1.parameters())
        assert not bb.conv1.weight.requires_grad
        assert all(p.requires_grad for p in bb.layer2.parameters())


def test_jax_builds_sac_where_the_config_names_none_3aw():
    """3aw: JAX's builder defaults ``stage_with_sac`` to (False, True, True,
    True) (``builder.py:126-127``), where mmdet's ``DetectoRS_ResNet``
    defaults to no SAC stage and builds none without ``sac``: the RFP-only
    files (``htc_r50_rfp``, ``cascade_rcnn_r50_rfp``) name no SAC, and JAX
    builds plain-branch SAC in stages 2-4 of both backbones. The port
    builds what JAX builds."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.models.detectors_resnet import SAConv
    for name in ('htc_r50_rfp_1x_coco.py', 'cascade_rcnn_r50_rfp_1x_coco.py'):
        cfg = _config(name)
        for bb in (cfg['model']['backbone'],
                   cfg['model']['neck']['rfp_backbone']):
            assert 'sac' not in bb and 'stage_with_sac' not in bb
        jdet = jax_build(cfg['model'], cfg.get('train_cfg'),
                         cfg.get('test_cfg'))
        for bb in (jdet.backbone, jdet.neck.rfp_backbones[0]):
            assert bb.stage_with_sac == (False, True, True, True)
            assert not bb.sac_use_deform
        port = _meta(cfg)
        assert isinstance(port.backbone.layer2[1].conv2, SAConv)
        assert isinstance(port.neck.rfp_modules[0].layer4[0].conv2, SAConv)
        assert not port.backbone.layer2[1].conv2.use_deform


@pytest.mark.parametrize('where,edit', [
    ('sac type', lambda c: c['model']['backbone']['sac'].update(type='X')),
    ('dcn', lambda c: c['model']['backbone'].update(
        dcn=dict(type='DCN'), stage_with_dcn=(False, True, True, True))),
    ('style', lambda c: c['model']['backbone'].update(style='caffe')),
    ('RFP relu', lambda c: c['model']['neck'].update(
        relu_before_extra_convs=True)),
])
def test_detectors_keys_refused(where, edit):
    """A DetectoRS key JAX drops, at another value than it computes with,
    is refused (3w); the file as it is builds."""
    cfg = _config('detectors_htc_r50_1x_coco.py')
    _meta(cfg)
    edit(cfg)
    with pytest.raises(NotImplementedError, match='3w'):
        _meta(cfg)


def test_jax_importer_misses_sac_and_the_rfp_3ax():
    """3ax: the JAX importer (``dynamask_tpu/engine/pretrained.py:120``)
    maps an mmdet DetectoRS checkpoint's SAC keys (``conv2.weight``,
    ``conv2.weight_diff``, ``conv2.switch.*``, ...) to a plain ``conv2``
    that JAX's SAC blocks do not have (theirs is ``sac_conv2``), the RFP's
    FPN convs to ``neck/lateral_{i}`` where JAX's RFP holds them under
    ``neck/fpn``, and has no rule for the RFP's own keys
    (``neck.rfp_modules``, ``rfp_aspp``, ``rfp_weight``); the port's key
    map carries each to JAX's leaf."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    _, variables, _ = twin()
    block = variables['params']['backbone']['layer2_block1']
    assert 'sac_conv2' in block and 'conv2' not in block
    port = _meta(_config('detectors_htc_r50_1x_coco.py'))
    hints = key_hints(port)
    wrong, skipped = set(), set()
    for k in port.state_dict():
        if k.endswith('num_batches_tracked'):
            continue
        ref, got = _mmdet_key(k), mmdet_key(k, **hints)
        assert got is not None, k
        if ref is None:
            skipped.add(k)
        elif (ref[0], ref[1]) != got[:2]:
            wrong.add(k)
    fpn = {k for k in wrong if k.startswith('neck.')}
    assert all(k.startswith(('neck.lateral_convs', 'neck.fpn_convs'))
               for k in fpn) and len(fpn) == 2 * (4 + 4)
    assert all('.conv2.' in k for k in wrong - fpn)
    assert len(wrong - fpn) == 13 * 12
    rfp = {k for k in skipped if k.startswith('neck.rfp')}
    assert any('rfp_aspp' in k for k in rfp) and any(
        'rfp_modules.0.layer3' in k for k in rfp)
    assert 'neck.rfp_weight.weight' in rfp
