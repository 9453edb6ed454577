"""The backbones' deformable convs and block plugins of the port against
the JAX package, on the CPU, each built on both sides by its builder from
the same config dict, the JAX weights carried into the port by its key map
(``engine/convert.py``), on seeded inputs:

- ResNet-50's first three stages with ``dcn`` / ``stage_with_dcn``
  (DCNv1; DCNv2 with 4 deform groups on a square map, where JAX's
  stride-1 blocks take the windowed form, and on a non-square one, where
  every block takes the exact gather), with GCNet's ``ContextBlock`` and
  ``GeneralizedAttention`` ``'1111'`` as the gcnet and
  empirical_attention configs place them, and ResNeXt's dense DCN kernel:
  eval outputs within 1e-4 relative L2; train mode in float64, every
  parameter's gradient within 1e-4 relative L2.
- ``ContextBlock`` (``att``, ``avg``) and ``GeneralizedAttention``
  (``'0010'``, ``'1111'``, ``spatial_range`` 2, ``q_stride`` 2 on odd
  sizes) alone: eval and float64 training, the same tolerances.
- A toy RegNet with ``mdconv`` (JAX's block-diagonal grouped DCNv2).
- The key map both ways (every port tensor has one JAX leaf, every JAX
  leaf a port tensor), the keys JAX drops refused, and the JAX package's
  faults these modules show (ROADMAP.md queue 3): 3al (the importer
  skips the DCN and plugin keys), 3an (GA's init is not the identity),
  3ao (ResNeXt's DCN kernel is dense), 3ap (the plugins before the
  ReLU).

Offsets come from offset convs drawn at the scale of the other convs, so
the samples spread over several pixels and are never on the grid (the
tie rule, 3ak, is ``tests/test_torch_port_item7_ops.py``'s).
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

from test_torch_port_item8_backbones import (TOY_REGNET,  # noqa: E402
                                             _cotangents, _jax_train,
                                             _port_train)
from test_torch_port_modules import fast_jit, nchw  # noqa: E402
from test_torch_port_train_slice import rel_l2                 # noqa: E402

RL2 = 1e-4
GCB = dict(cfg=dict(type='ContextBlock', ratio=1. / 16),
           stages=(False, True, True, True), position='after_conv3')
GA = dict(cfg=dict(type='GeneralizedAttention', spatial_range=-1,
                   num_heads=8, attention_type='1111', kv_stride=2),
          stages=(False, False, True, True), position='after_conv2')
STAGES = (False, True, True, True)
BACKBONES = {
    'dcn': dict(type='ResNet', depth=50, dcn=dict(type='DCN'),
                stage_with_dcn=STAGES),
    'mdcn4': dict(type='ResNet', depth=50, stage_with_dcn=STAGES,
                  dcn=dict(type='DCNv2', deform_groups=4)),
    'gcb_ga_dcn': dict(type='ResNet', depth=50, plugins=[GCB, GA],
                       dcn=dict(type='DCN', fallback_on_stride=False),
                       stage_with_dcn=STAGES),
    'x101_dcn': dict(type='ResNeXt', depth=50, groups=32, base_width=4,
                     dcn=dict(type='DCN'), stage_with_dcn=STAGES),
    'regnet_mdconv': dict(type='RegNet', arch=TOY_REGNET,
                          stage_with_dcn=STAGES,
                          dcn=dict(type='DCNv2', deform_groups=1)),
}
# the first three stages of the ResNets: the GA stages begin at the third
RESNET_STAGES = dict(num_stages=3, out_indices=(0, 1, 2), frozen_stages=1)


def fill_variables(module, *args, seed=3):
    """The variables of ``module`` drawn from a numpy seed over the shapes
    of its init: kernels (a DCN's ``*_weight`` and the offset convs' too)
    N(0, 1/fan_in), biases and GA's biases N(0, 0.1), BN and LayerNorm
    scales and variances U(0.5, 1.5), means N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, a):
        name = path[-1].key
        if name == 'kernel' or name.endswith('_weight'):
            fan_in = int(np.prod(a.shape[:-1])) // (
                a.shape[0] if a.ndim == 5 else 1)
            return rng.normal(0, fan_in ** -0.5, a.shape).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _cfg(name):
    cfg = dict(BACKBONES[name])
    if cfg['type'] != 'RegNet':
        cfg.update(RESNET_STAGES)
    else:
        cfg['frozen_stages'] = 1
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(name, hw):
    from dynamask_tpu.models.builder import build_backbone as jbuild
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models.builder import build_backbone
    x = np.random.RandomState(7).randn(2, *hw, 3).astype(np.float32)
    jb = jbuild(dict(_cfg(name), block_remat=False))
    v = fill_variables(jb, jnp.asarray(x))
    root = torch.nn.Module()
    with torch.device('meta'):
        root.backbone = build_backbone(_cfg(name))
    root = root.to_empty(device='cpu')
    load_jax_variables(root, {'params': {'backbone': v['params']},
                              'batch_stats': {'backbone':
                                              v.get('batch_stats', {})}})
    root.backbone.freeze_stages()
    return jb, v, root, x


def pair(name, hw=(48, 48)):
    """(JAX backbone, its variables, a holder of the port backbone under
    ``backbone``, the input)."""
    jb, v, root, x = _pair(name, hw)
    return jb, v, copy.deepcopy(root), x


EVAL = [('dcn', (48, 64)), ('mdcn4', (48, 48)), ('mdcn4', (48, 64)),
        ('gcb_ga_dcn', (48, 64)), ('x101_dcn', (48, 48)),
        ('regnet_mdconv', (48, 48)), ('regnet_mdconv', (48, 64))]


@pytest.mark.parametrize('name,hw', EVAL)
def test_backbone_eval(name, hw):
    jb, v, root, x = pair(name, hw)
    ref = fast_jit(jb.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = root.backbone.eval()(nchw(x))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        d = rel_l2(b.permute(0, 2, 3, 1).numpy(), a)
        assert d < RL2, f'output {i}: rel-L2 {d:.2e}'


TRAIN = [('mdcn4', (48, 48)), ('gcb_ga_dcn', (48, 64)),
         ('regnet_mdconv', (48, 64))]


@pytest.mark.parametrize('name,hw', TRAIN)
def test_backbone_train_gradients(name, hw):
    """Train mode in float64 at ``frozen_stages=1``: the outputs and every
    parameter's gradient (the JAX leaf in the port's layout through the
    key map; the offset convs', the DCN kernels' and the plugins' among
    them)."""
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    jb, v, root, x = pair(name, hw)
    cots = _cotangents(jax.eval_shape(jb.apply, v, jnp.asarray(x)))
    ref, (jgrads, _) = _jax_train(jb, v, x, cots)
    got, _ = _port_train(root.backbone, x, cots)
    for i, (a, b) in enumerate(zip(ref, got)):
        d = rel_l2(b.detach().permute(0, 2, 3, 1).numpy(), a)
        assert d < RL2, f'output {i}: rel-L2 {d:.2e}'
    grads = {'backbone': jax.device_get(jgrads)}
    hints = key_hints(root)
    kinds = set()
    for k, p in root.named_parameters():
        want = _torch_layout(grads, {}, *mmdet_key(k, **hints))
        if not p.requires_grad:
            assert p.grad is None and not np.any(want), k
            continue
        if _shift_invariant(k, p.grad.numpy(), want):
            continue
        d = rel_l2(p.grad.numpy(), want)
        assert d < RL2, f'{k}: rel-L2 {d:.2e}'
        kinds |= {s for s in ('conv_offset', 'conv2.weight', 'context_block',
                              'gen_attention_block') if s in k}
    assert {'conv_offset', 'conv2.weight'} <= kinds
    assert ('context_block' in kinds) == ('gcb' in name)


def _shift_invariant(key, got, want) -> bool:
    """The ``conv_mask`` bias shifts every logit of the softmax pooling by
    one constant: its gradient is zero but for rounding, on both sides."""
    if not key.endswith('conv_mask.bias'):
        return False
    assert np.abs(got).max() < 1e-6 and np.abs(want).max() < 1e-6, key
    return True


# -- the plugins alone --------------------------------------------------------

PLUGINS = {
    'gcb_att': (dict(type='ContextBlock', ratio=1. / 4), (6, 7)),
    'gcb_avg': (dict(type='ContextBlock', ratio=1. / 4, pooling_type='avg'),
                (6, 7)),
    'ga_0010': (dict(type='GeneralizedAttention', num_heads=4,
                     attention_type='0010', kv_stride=2), (6, 7)),
    'ga_1111': (dict(type='GeneralizedAttention', num_heads=4,
                     attention_type='1111', kv_stride=2), (6, 7)),
    'ga_1111_range': (dict(type='GeneralizedAttention', num_heads=4,
                           attention_type='1111', kv_stride=2,
                           spatial_range=2, position_magnitude=2), (7, 9)),
    'ga_1100_q2': (dict(type='GeneralizedAttention', num_heads=4,
                        attention_type='1100', kv_stride=1, q_stride=2,
                        position_embedding_dim=12), (7, 9)),
}
PLUGIN_C = 16


@functools.lru_cache(maxsize=None)
def plugin_pair(name):
    """(JAX plugin, its variables, the port holder with the plugin at
    ``backbone.layer1.0.<mmdet name>``, the input)."""
    from dynamask_tpu.models import plugins as jp
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models.plugins import build_plugin
    cfg, hw = PLUGINS[name]
    kwargs = {k: v for k, v in cfg.items() if k != 'type'}
    jm = getattr(jp, cfg['type'])(in_channels=PLUGIN_C, **kwargs)
    x = np.random.RandomState(2).randn(2, *hw, PLUGIN_C).astype(np.float32)
    v = fill_variables(jm, jnp.asarray(x), seed=6)
    module = build_plugin(cfg, PLUGIN_C)
    holder = torch.nn.Module()
    holder.backbone = torch.nn.Module()
    holder.backbone.layer1 = torch.nn.ModuleList([torch.nn.Module()])
    block = holder.backbone.layer1[0]
    block.add_module(module.abbr, module)
    block.plugin_names = [('after_conv3', module.abbr, 'after_conv3_plugin0')]
    load_jax_variables(holder, {'params': {'backbone': {'layer1_block0': {
        'after_conv3_plugin0': v['params']}}}})
    return jm, v, holder, x


@pytest.mark.parametrize('name', sorted(PLUGINS))
def test_plugin_eval(name):
    jm, v, holder, x = plugin_pair(name)
    ref = np.asarray(fast_jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = holder.backbone.layer1[0].get_submodule(
            PLUGIN_ABBR[PLUGINS[name][0]['type']])(nchw(x))
    d = rel_l2(got.permute(0, 2, 3, 1).numpy(), ref)
    assert d < RL2 and rel_l2(ref, x) > 1e-2, d


PLUGIN_ABBR = {'ContextBlock': 'context_block',
               'GeneralizedAttention': 'gen_attention_block'}


@pytest.mark.parametrize('name', sorted(PLUGINS))
def test_plugin_train_float64(name):
    """float64 on both sides (GA's energy fp32 on both, as in JAX): the
    gradients in every parameter and in the input."""
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    jm, v, holder, x = plugin_pair(name)
    holder = copy.deepcopy(holder).double()
    cot = np.random.RandomState(9).randn(*x.shape)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     v)
        jgrads, jx = jax.device_get(jax.grad(
            lambda p, xx: jnp.sum(jm.apply({'params': p}, xx) * cot),
            argnums=(0, 1))(v64['params'], jnp.asarray(x, jnp.float64)))
    module = holder.backbone.layer1[0].get_submodule(
        PLUGIN_ABBR[PLUGINS[name][0]['type']])
    xt = nchw(x).double().requires_grad_()
    (module(xt) * nchw(cot)).sum().backward()
    d = rel_l2(xt.grad.permute(0, 2, 3, 1).numpy(), jx)
    assert d < RL2, d
    hints = key_hints(holder)
    grads = {'backbone': {'layer1_block0': {'after_conv3_plugin0': jgrads}}}
    for k, p in holder.named_parameters():
        want = _torch_layout(grads, {}, *mmdet_key(k, **hints))
        if _shift_invariant(k, p.grad.numpy(), want):
            continue
        d = rel_l2(p.grad.numpy(), want)
        assert d < RL2, f'{k}: rel-L2 {d:.2e}'


def test_jax_nearest_resize():
    """GA's ``q_stride`` output resize is ``jax.image.resize``'s
    nearest, the half-pixel rule, at the sizes the strides give."""
    from dynamask_torch.models.plugins import jax_nearest_resize
    for (h, w), (oh, ow) in (((4, 5), (7, 9)), ((3, 3), (5, 6)),
                             ((13, 21), (25, 42))):
        x = np.random.RandomState(h).randn(1, 2, h, w).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, oh, ow),
                                          'nearest'))
        got = jax_nearest_resize(torch.from_numpy(x), oh, ow)
        np.testing.assert_array_equal(got.numpy(), ref)


# -- the key map --------------------------------------------------------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize('name', ['gcb_ga_dcn', 'mdcn4', 'regnet_mdconv'])
def test_key_map_both_ways(name):
    """Every port tensor reaches its own JAX leaf and every JAX leaf is
    reached; the loaded port gives JAX's values back through it."""
    from dynamask_torch.engine.convert import (_node, _torch_layout,
                                               key_hints, mmdet_key)
    _, v, root, _ = pair(name)
    variables = {'params': {'backbone': v['params']},
                 'batch_stats': {'backbone': v.get('batch_stats', {})}}
    hints = key_hints(root)
    reached = set()
    for k, t in root.state_dict().items():
        if k.endswith('num_batches_tracked'):
            continue
        path, leaf, h = mmdet_key(k, **hints)
        if leaf in ('running_mean', 'running_var'):
            got = ('batch_stats',) + tuple(path) + (leaf[8:],)
        elif leaf == 'weight':
            node = _node(variables['params'], path)
            got = ('params',) + tuple(path) + (
                h.get('flax_leaf') or ('scale' if 'scale' in node
                                       else 'kernel'),)
        else:
            got = ('params',) + tuple(path) + (leaf,)
        assert got not in reached, k
        reached.add(got)
        want = _torch_layout(variables['params'], variables['batch_stats'],
                             path, leaf, h)
        np.testing.assert_array_equal(t.numpy(), want, err_msg=k)
    leaves = {('params',) + p for p in _flat(variables['params'])} | {
        ('batch_stats',) + p for p in _flat(variables['batch_stats'])}
    assert reached == leaves, (sorted(leaves - reached)[:5],
                               sorted(reached - leaves)[:5])
    assert any('offset' in str(p) for p in reached)


# -- refusals: the keys JAX drops ---------------------------------------------

@pytest.mark.parametrize('cfg,what', [
    (dict(dcn=dict(type='DCN', fallback_on_stride=True)), '3w'),
    (dict(dcn=dict(type='DCNv3')), '3w'),
    (dict(dcn=dict(type='DCN', use_bias=True)), '3w'),
    (dict(plugins=[dict(cfg=dict(type='ContextBlock', ratio=0.25,
                                 fusion_types=('channel_mul',)))]), '3w'),
    (dict(plugins=[dict(cfg=dict(type='ContextBlock', pooling_type='max'))]),
     '3w'),
    (dict(plugins=[dict(cfg=dict(type='GeneralizedAttention', gamma=1.0))]),
     '3w'),
    (dict(plugins=[dict(cfg=dict(type='ContextBlock'),
                        position='after_conv4')]), '3w'),
    (dict(plugins=[dict(cfg=dict(type='ContextBlock'), drop=True)]), '3w'),
    (dict(plugins=[dict(cfg=dict(type='NonLocal2d'))]), 'ContextBlock'),
    (dict(depth=18, plugins=[dict(cfg=dict(type='ContextBlock'))]), '3w')])
def test_dropped_keys_refused(cfg, what):
    from dynamask_torch.models.builder import build_backbone
    with pytest.raises(NotImplementedError, match=what), \
            torch.device('meta'):
        build_backbone(dict(dict(type='ResNet', depth=50), **cfg))


def test_duplicate_plugin_names_refused():
    """Two plugins of one type in a block need their own ``postfix``, as
    mmdet's ``make_block_plugins`` asks; with them both build."""
    from dynamask_torch.models.builder import build_backbone
    two = [dict(cfg=dict(type='ContextBlock'), position='after_conv2'),
           dict(cfg=dict(type='ContextBlock'), position='after_conv3')]
    with pytest.raises(ValueError, match='duplicate'), torch.device('meta'):
        build_backbone(dict(type='ResNet', depth=50, plugins=two))
    two[1]['postfix'] = '_3'
    with torch.device('meta'):
        net = build_backbone(dict(type='ResNet', depth=50, plugins=two))
    assert [n for _, n, _ in net.layer1[0].plugin_names] == [
        'context_block', 'context_block_3']


# -- the JAX package's faults (ROADMAP.md queue 3) ----------------------------

def test_jax_importer_skips_dcn_and_plugin_keys_3al():
    """An mmdet checkpoint of a DCN + GCB + GA backbone through JAX's
    importer: the DCN stages' 3x3 kernels, their offset convs and every
    plugin tensor are skipped and stay at init; the port's key map loads
    each of them."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    _, v, root, _ = pair('gcb_ga_dcn')
    sd = {k: t.numpy() for k, t in root.state_dict().items()}
    _, _, report = convert_torch_weights(
        sd, {'backbone': v['params']}, {'backbone': v['batch_stats']},
        scope='mmdet')
    skipped = set(report['skipped'])
    dcn = {k for k in sd if '.conv2.' in k and k.startswith(
        ('backbone.layer2.', 'backbone.layer3.'))}
    plugins = {k for k in sd if 'context_block' in k or
               'gen_attention_block' in k}
    assert dcn and plugins and (dcn | plugins) <= skipped
    assert not (skipped - dcn - plugins - {
        k for k in sd if k.endswith('num_batches_tracked')})


def test_jax_generalized_attention_is_not_the_identity_at_init_3an():
    """mmcv's GA adds ``gamma * out`` with ``gamma`` 0 at init and a
    biased ``proj_conv``; JAX's adds ``out`` directly and has neither, so
    at its init the block changes its input. Its position embedding
    takes ``pe_dim`` features where mmcv's fc takes ``pe_dim / 2``."""
    from dynamask_tpu.models.plugins import GeneralizedAttention as JGA
    x = jnp.asarray(np.random.RandomState(0).randn(1, 6, 6, 16), jnp.float32)
    jm = JGA(in_channels=16, num_heads=4, attention_type='1111')
    v = jm.init(jax.random.PRNGKey(0), x)
    assert float(jnp.abs(jm.apply(v, x) - x).max()) > 1e-2
    assert 'gamma' not in v['params'] and 'bias' not in v['params'][
        'proj_conv']
    assert v['params']['appr_geom_fc_x']['kernel'].shape == (16, 16)


def test_jax_resnext_dcn_kernel_is_dense_3ao():
    """JAX's DCN 3x3 drops ``groups`` (``resnet.py:255-256, :162-163``):
    ResNeXt-50-32x4d's DCN stages carry a dense (3, 3, 256, 256) kernel
    where its plain stages are grouped. The port builds the same; a
    grouped checkpoint tensor is refused there by name."""
    jb, v, root, _ = pair('x101_dcn')
    assert v['params']['layer2_block0']['conv2_weight'].shape == (
        3, 3, 256, 256)
    assert v['params']['layer1_block0']['conv2']['kernel'].shape == (
        3, 3, 4, 128)
    net = root.backbone
    assert tuple(net.layer2[0].conv2.weight.shape) == (256, 256, 3, 3)
    sd = net.state_dict()
    sd['layer2.0.conv2.weight'] = torch.zeros(256, 8, 3, 3)
    with pytest.raises(ValueError, match='3ao'):
        net.load_state_dict(sd)
    assert net.weight_fault('layer2.0.conv2.weight', (256, 8, 3, 3))


def test_jax_plugins_before_the_relu_3ap():
    """JAX applies an ``after_conv1`` / ``after_conv2`` plugin to the
    block's BN output before its ReLU (``resnet.py:251-262``); mmdet's
    ``Bottleneck.forward`` after it. The port's block is JAX's: its output
    equals the before-ReLU order and not the after-ReLU one."""
    import torch.nn.functional as F
    _, _, root, x = pair('gcb_ga_dcn')
    block = root.backbone.layer3[1]
    assert [p for p, _, _ in block.plugin_names] == ['after_conv3',
                                                     'after_conv2']
    with torch.no_grad():
        inp = torch.randn(1, 1024, 3, 4)
        got = block.eval()(inp)
        out = F.relu(block.bn1(block.conv1(inp)))
        out = block.bn2(block.conv2(out))
        ga = block.gen_attention_block
        before = block.bn3(block.conv3(F.relu(ga(out))))
        after = block.bn3(block.conv3(ga(F.relu(out))))
        gcb = block.context_block
        want = F.relu(gcb(before) + inp)
        other = F.relu(gcb(after) + inp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert rel_l2(other.numpy(), want.numpy()) > 1e-3
