"""HRNet, RegNet and Res2Net, HRFPN and PAFPN of the port against the JAX
package's, on the CPU, each built on both sides by its builder from the
same config dict, the JAX weights carried into the port by its key map
(``engine/convert.py``), on seeded inputs:

- Eval mode: every backbone output within 1e-4 relative L2: a toy HRNet
  (one module a stage, branches of 8/16/32/64 channels), a toy RegNet
  (an arch dict of four stages, 8 groups) and ``regnetx_800mf``, Res2Net
  at depth 50 with 4 scales of 26 channels.
- Train mode in float64 on both sides: the outputs and each parameter's
  gradient of a fixed random projection of them within 1e-4 relative L2
  at ``frozen_stages=1`` (the frozen parameters get none on either
  side), the input's gradient at ``frozen_stages=-1``.
- The necks on random pyramids within 1e-5 relative L2: HRFPN at
  ``stride`` 1 and 2 (its bilinear upsample against JAX's
  ``core.boundary.interpolate_bilinear``), PAFPN.
- RegNet's layout of every ``ARCH_SETTINGS`` entry equal to JAX's, and
  each ``configs/regnet/`` file's FPN ``in_channels`` its stage widths;
  Res2Net's pool against JAX's ``_avg_pool`` at odd and tiny sizes; the
  frozen parameters against JAX's ``frozen_param_paths``; the key map
  both ways (every port tensor has a JAX leaf and every JAX leaf a port
  tensor); the ``open-mmlab://`` specs resolved as local files.

Beside them, the JAX package's faults these modules show (ROADMAP.md
queue 3): 3ag (RegNet's group count), 3ah (the importer's skipped keys),
3ai (Res2Net's stage pool), and the keys its builder drops, refused here.
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

from test_torch_port_modules import fast_jit, nchw  # noqa: E402
from test_torch_port_train_slice import rel_l2                 # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RL2 = 1e-4
NECK_RL2 = 1e-5
TOY_HRNET = dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(2,), num_channels=(16,)),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(1, 2), num_channels=(8, 16)),
    stage3=dict(num_modules=1, num_branches=3, block='BASIC',
                num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=1, num_branches=4, block='BASIC',
                num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)))
TOY_REGNET = dict(w0=16, wa=16.0, wm=2.0, group_w=8, depth=7, bot_mul=1.0)
BACKBONES = {
    'hrnet': dict(type='HRNet', extra=TOY_HRNET, norm_eval=True),
    'regnet_toy': dict(type='RegNet', arch=TOY_REGNET, norm_eval=True,
                       norm_cfg=dict(type='BN', requires_grad=True),
                       style='pytorch'),
    'regnetx_800mf': dict(type='RegNet', arch='regnetx_800mf',
                          norm_eval=True),
    'res2net': dict(type='Res2Net', depth=50, scales=4, base_width=26,
                    norm_eval=True, style='pytorch'),
}
# the blocks are rematerialised in JAX by default: the same function
REMAT = {'regnet_toy', 'regnetx_800mf', 'res2net'}


def _jax_cfg(name, frozen_stages):
    cfg = dict(BACKBONES[name], frozen_stages=frozen_stages)
    return dict(cfg, block_remat=False) if name in REMAT else cfg


def seeded_variables(module, *args, seed=3):
    """The variables of ``module`` drawn from a numpy seed over the shapes
    of its init (traced, not run): kernels N(0, 1/fan_in), biases
    N(0, 0.1), BN scales and variances U(0.5, 1.5), means N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, a):
        name = path[-1].key
        if name == 'kernel':
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, a.shape).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _pair(name, frozen_stages, hw):
    from dynamask_tpu.models.builder import build_backbone as jbuild
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models.builder import build_backbone
    x = np.random.RandomState(7).randn(2, hw, hw, 3).astype(np.float32)
    jb = jbuild(_jax_cfg(name, frozen_stages))
    v = seeded_variables(jb, jnp.asarray(x))
    root = torch.nn.Module()
    with torch.device('meta'):
        root.backbone = build_backbone(dict(BACKBONES[name],
                                            frozen_stages=frozen_stages))
    root = root.to_empty(device='cpu')
    load_jax_variables(root, {'params': {'backbone': v['params']},
                              'batch_stats': {'backbone':
                                              v.get('batch_stats', {})}})
    root.backbone.freeze_stages()
    return jb, v, root.backbone, x


def pair(name, frozen_stages=1, hw=64):
    """(JAX backbone, its seeded variables, the port backbone under
    ``backbone.`` loaded from them, the input); the port a copy of its
    own."""
    jb, v, port, x = _pair(name, frozen_stages, hw)
    return jb, v, copy.deepcopy(port), x


@pytest.mark.parametrize('name', sorted(BACKBONES))
def test_backbone_eval(name):
    jb, v, port, x = pair(name)
    ref = fast_jit(jb.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert len(got) == len(ref) == 4
    for i, (a, b) in enumerate(zip(ref, got)):
        assert tuple(b.shape) == (2, a.shape[3], a.shape[1], a.shape[2])
        d = rel_l2(b.permute(0, 2, 3, 1).numpy(), a)
        assert d < RL2, f'output {i}: rel-L2 {d:.2e}'


def _cotangents(outs):
    rng = np.random.RandomState(11)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


def _jax_train(jb, v, x, cots):
    """Train-mode outputs and the gradients of sum(outputs * cots) in the
    parameters and the input, in float64 (the variables besides the
    parameters and the cotangents arguments of the compiled program, not
    constants folded into it)."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     v)

        def loss(params, xx, rest, cs):
            outs, _ = jb.apply({**rest, 'params': params}, xx, train=True,
                               mutable=['batch_stats'])
            return sum(jnp.sum(o * c) for o, c in zip(outs, cs)), outs
        (_, outs), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
            v64['params'], jnp.asarray(x, jnp.float64),
            {k: a for k, a in v64.items() if k != 'params'},
            [jnp.asarray(c, jnp.float64) for c in cots])
        return jax.device_get((outs, grads))


def _port_train(port, x, cots):
    port = port.double()
    xt = nchw(x).double().requires_grad_()
    outs = port.train()(xt)
    sum((o * nchw(c).double()).sum() for o, c in zip(outs, cots)).backward()
    return outs, xt.grad


TRAIN = ['hrnet', 'regnet_toy', 'res2net']


@pytest.mark.parametrize('name', TRAIN)
def test_backbone_train_parameter_gradients(name):
    """Train mode at ``frozen_stages=1`` in float64: the outputs and every
    parameter's gradient (the JAX leaf in the port's layout through the
    key map)."""
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    jb, v, port, x = pair(name)
    cots = _cotangents(jax.eval_shape(jb.apply, v, jnp.asarray(x)))
    ref, (jgrads, _) = _jax_train(jb, v, x, cots)
    got, _ = _port_train(port, x, cots)
    for i, (a, b) in enumerate(zip(ref, got)):
        d = rel_l2(b.detach().permute(0, 2, 3, 1).numpy(), a)
        assert d < RL2, f'output {i}: rel-L2 {d:.2e}'
    grads = {'backbone': jax.device_get(jgrads)}
    kind = type(port).__name__
    compared = frozen = 0
    for k, p in port.named_parameters():
        want = _torch_layout(grads, {}, *mmdet_key('backbone.' + k,
                                                   backbone=kind))
        if not p.requires_grad:
            assert p.grad is None and not np.any(want), k
            frozen += 1
            continue
        d = rel_l2(p.grad.numpy(), want)
        assert d < RL2, f'{k}: rel-L2 {d:.2e}'
        compared += 1
    assert frozen >= 6 and compared > 30, (frozen, compared)


@pytest.mark.parametrize('name', TRAIN)
def test_backbone_train_input_gradient(name):
    jb, v, port, x = pair(name, frozen_stages=-1)
    cots = _cotangents(jax.eval_shape(jb.apply, v, jnp.asarray(x)))
    _, (_, jx) = _jax_train(jb, v, x, cots)
    _, gx = _port_train(port, x, cots)
    d = rel_l2(gx.permute(0, 2, 3, 1).numpy(), np.asarray(jx))
    assert np.abs(np.asarray(jx)).max() > 0 and d < RL2, d


@pytest.mark.parametrize('name', TRAIN)
def test_frozen_parameters_are_jaxs(name):
    """The parameters the port freezes at ``frozen_stages=1`` are the
    leaves JAX's optimizer freezes (``frozen_param_paths``, matched on the
    module directly under ``backbone``), through the key map."""
    from dynamask_torch.engine.convert import mmdet_key
    jb, v, port, _ = pair(name)
    prefixes = jb.frozen_param_paths()
    kind = type(port).__name__
    for k, p in port.named_parameters():
        path = mmdet_key('backbone.' + k, backbone=kind)[0]
        assert (not p.requires_grad) == path[1].startswith(prefixes), k


# -- the necks ---------------------------------------------------------------

NECKS = {
    'hrfpn': dict(type='HRFPN', in_channels=[8, 16, 32, 64],
                  out_channels=16, num_outs=5),
    'hrfpn_stride2': dict(type='HRFPN', in_channels=[8, 16, 32, 64],
                          out_channels=16, num_outs=5, stride=2),
    'pafpn': dict(type='PAFPN', in_channels=[8, 16, 32, 64],
                  out_channels=16, num_outs=5),
}


def neck_pair(name):
    from dynamask_tpu.models.builder import build_neck as jbuild
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models.builder import build_neck
    rng = np.random.RandomState(5)
    xs = [rng.randn(2, 32 // 2 ** i, 24 // 2 ** i, c).astype(np.float32)
          for i, c in enumerate(NECKS[name]['in_channels'])]
    jn = jbuild(dict(NECKS[name]))
    v = seeded_variables(jn, [jnp.asarray(a) for a in xs], seed=4)
    root = torch.nn.Module()
    with torch.device('meta'):
        root.neck = build_neck(dict(NECKS[name]))
    root = root.to_empty(device='cpu')
    load_jax_variables(root, {'params': {'neck': v['params']}})
    return jn, v, root.neck, xs


@pytest.mark.parametrize('name', sorted(NECKS))
def test_neck(name):
    jn, v, port, xs = neck_pair(name)
    ref = jn.apply(v, [jnp.asarray(a) for a in xs])
    with torch.no_grad():
        got = port([nchw(a) for a in xs])
    stride = NECKS[name].get('stride', 1)
    assert len(got) == len(ref) == 5
    for i, (a, b) in enumerate(zip(ref, got)):
        if name.startswith('hrfpn'):
            h = -(-(32 // 2 ** i) // stride)
            assert b.shape[-2] == h, (i, b.shape)
        d = rel_l2(b.permute(0, 2, 3, 1).numpy(), a)
        assert d < NECK_RL2, f'level {i}: rel-L2 {d:.2e}'


def test_hrfpn_upsample_is_jaxs_bilinear():
    """HRFPN's x2^i upsample is JAX's ``interpolate_bilinear`` with
    ``align_corners=False`` (and torch's own bilinear at an exact
    factor)."""
    from dynamask_tpu.core.boundary import interpolate_bilinear as jinterp
    from dynamask_torch.core.boundary import interpolate_bilinear
    x = np.random.RandomState(2).randn(2, 3, 5, 7).astype(np.float32)
    for f in (2, 4, 8):
        ref = np.asarray(jinterp(jnp.asarray(x), 5 * f, 7 * f,
                                 align_corners=False))
        got = interpolate_bilinear(torch.from_numpy(x), 5 * f, 7 * f,
                                   align_corners=False)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x), scale_factor=f, mode='bilinear',
            align_corners=False)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)


# -- layouts, pools, key map --------------------------------------------------

def test_regnet_layouts_are_jaxs():
    """Every ``ARCH_SETTINGS`` entry's widths, depths, bottleneck ratios
    and group counts equal JAX's, and the port's blocks take them."""
    from dynamask_tpu.models.regnet import (ARCH_SETTINGS as JARCH,
                                            RegNet as JRegNet)
    from dynamask_torch.models.regnet import ARCH_SETTINGS, RegNet
    assert ARCH_SETTINGS == JARCH
    for arch in list(JARCH) + [TOY_REGNET]:
        ref = JRegNet(arch=arch)._layout()
        with torch.device('meta'):
            port = RegNet(arch=arch)
        widths, blocks, _, groups = ref
        for i, (w, n, g) in enumerate(zip(widths, blocks, groups)):
            layer = getattr(port, f'layer{i + 1}')
            assert len(layer) == n and layer[0].conv3.out_channels == w
            assert all(b.conv2.groups == g for b in layer), arch
        from dynamask_torch.models.regnet import regnet_layout
        assert tuple(map(list, regnet_layout(arch))) == tuple(
            map(list, ref)), arch


@pytest.mark.parametrize('rel', sorted(
    os.path.relpath(f, ROOT) for f in __import__('glob').glob(
        os.path.join(ROOT, 'configs', 'regnet', '*.py'))))
def test_regnet_config_fpn_widths(rel):
    """Each RegNet config's FPN ``in_channels`` are its arch's stage
    widths."""
    from dynamask_torch.models.regnet import regnet_layout
    from dynamask_torch.utils.config import Config
    m = Config.fromfile(os.path.join(ROOT, rel)).model
    assert list(m.neck.in_channels) == regnet_layout(m.backbone.arch)[0]


@pytest.mark.parametrize('n', [1, 2, 3, 4, 5, 6, 7, 9])
@pytest.mark.parametrize('k,s', [(2, 2), (3, 2), (3, 3)])
def test_res2net_pool_is_jaxs(n, k, s):
    """Ceil mode without counting padding, at odd and tiny sizes (where
    torch's own ceil mode refuses the input or drops a window)."""
    from dynamask_tpu.models.res2net import _avg_pool
    from dynamask_torch.models.res2net import ceil_avg_pool
    x = np.random.RandomState(n).randn(1, n, n + 1, 3).astype(np.float32)
    ref = np.asarray(_avg_pool(jnp.asarray(x), k, s))
    got = ceil_avg_pool(nchw(x), k, s).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _leaf(path, leaf, hints):
    """The JAX leaf (collection, path) behind a port tensor's key map
    entry."""
    if leaf in ('running_mean', 'running_var'):
        return ('batch_stats',) + tuple(path) + (leaf[8:],)
    if leaf == 'weight':
        return None       # a conv's kernel or a BN's scale: both below
    return ('params',) + tuple(path) + (leaf,)


def key_map_both_ways(model, variables, scope):
    """Every port tensor under ``scope`` maps to a JAX leaf (one each),
    and every JAX leaf under it is reached."""
    from dynamask_torch.engine.convert import _node, key_hints, mmdet_key
    hints = key_hints(model)
    reached = set()
    for k in model.state_dict():
        if k.endswith('num_batches_tracked') or not k.startswith(scope):
            continue
        path, leaf, _ = mmdet_key(k, **hints)
        if leaf == 'weight':
            node = _node(variables['params'], path)
            got = ('params',) + tuple(path) + (
                'scale' if 'scale' in node else 'kernel',)
        else:
            got = _leaf(path, leaf, {})
        assert got not in reached, k
        reached.add(got)
    want = {('params',) + p for p in _flat(variables['params'])} | {
        ('batch_stats',) + p for p in _flat(variables.get('batch_stats',
                                                          {}))}
    want = {p for p in want if p[1] == scope[:-1]}
    assert reached == want, (sorted(want - reached)[:5],
                             sorted(reached - want)[:5])
    return len(reached)


@pytest.mark.parametrize('name', sorted(BACKBONES) + sorted(NECKS))
def test_key_map_round_trip(name):
    """Each module's key map, both ways, no key skipped; the loaded port
    gives JAX's values back through it."""
    from dynamask_torch.engine.convert import _torch_layout, key_hints
    from dynamask_torch.engine.convert import mmdet_key
    if name in BACKBONES:
        _, v, port, _ = pair(name)
        scope, root = 'backbone.', port
    else:
        _, v, port, _ = neck_pair(name)
        scope, root = 'neck.', port
    holder = torch.nn.Module()
    setattr(holder, scope[:-1], root)
    variables = {'params': {scope[:-1]: v['params']},
                 'batch_stats': {scope[:-1]: v.get('batch_stats', {})}}
    n = key_map_both_ways(holder, variables, scope)
    assert n > 10
    hints = key_hints(holder)
    for k, t in holder.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            want = _torch_layout(variables['params'],
                                 variables['batch_stats'],
                                 *mmdet_key(k, **hints))
            np.testing.assert_array_equal(t.numpy(), want, err_msg=k)


def test_open_mmlab_specs_resolve_locally(tmp_path, monkeypatch):
    """``open-mmlab://msra/hrnetv2_w32``, ``regnetx_3.2gf`` and
    ``res2net101_v1d_26w_4s`` are looked for as local files, as the
    ``torchvision://`` specs are; a missing one resolves to None."""
    from dynamask_torch.engine.pretrained import resolve_pretrained_path
    hub = tmp_path / 'hub' / 'checkpoints'
    hub.mkdir(parents=True)
    monkeypatch.setenv('TORCH_HOME', str(tmp_path))
    files = {'open-mmlab://msra/hrnetv2_w32': 'hrnetv2_w32-dc9eeb4f.pth',
             'open-mmlab://regnetx_3.2gf': 'regnetx_3.2gf-c2599b0f.pth',
             'open-mmlab://res2net101_v1d_26w_4s':
                 'res2net101_v1d_26w_4s_mmdetv2-f0a600f9.pth'}
    for spec, f in files.items():
        assert resolve_pretrained_path(spec) is None
        (hub / f).write_bytes(b'')
        assert resolve_pretrained_path(spec) == str(hub / f)
    assert resolve_pretrained_path('open-mmlab://msra/hrnetv2_w18') is None


# -- the refusals and the JAX package's faults (ROADMAP.md queue 3) ----------

@pytest.mark.parametrize('cfg,what', [
    (dict(type='RegNet', arch='regnetx_3.2gf',
          dcn=dict(type='DCNv2', deform_groups=1, fallback_on_stride=True),
          stage_with_dcn=(False, True, True, True)), '3w'),
    (dict(type='Res2Net', depth=50, dcn=dict(type='DCN'),
          stage_with_dcn=(False, True, True, True)), '3w'),
    (dict(type='HRNet', extra=dict(TOY_HRNET, stage2=dict(
        TOY_HRNET['stage2'], block='BOTTLENECK'))), '3w'),
    (dict(type='HRNet', extra=TOY_HRNET, with_cp=True), '3w'),
    (dict(type='RegNet', arch='regnetx_800mf',
          norm_cfg=dict(type='GN', num_groups=32)), '3w'),
    (dict(type='Res2Net', depth=50,
          norm_cfg=dict(type='BN', requires_grad=False)), '3w'),
    (dict(type='Res2Net', depth=50, style='caffe'), '3w'),
    (dict(type='HRNet', extra=TOY_HRNET, norm_cfg=dict(type='SyncBN')),
     '3w')])
def test_backbone_keys_refused(cfg, what):
    from dynamask_torch.models.builder import build_backbone
    with pytest.raises(NotImplementedError, match=what), \
            torch.device('meta'):
        build_backbone(cfg)


@pytest.mark.parametrize('extra', [
    dict(pooling_type='MAX'), dict(norm_cfg=dict(type='BN')),
    dict(with_cp=True), dict(conv_cfg=dict(type='ConvWS'))])
def test_hrfpn_keys_refused(extra):
    from dynamask_torch.models.builder import build_neck
    with pytest.raises(NotImplementedError, match='3w'), \
            torch.device('meta'):
        build_neck(dict(NECKS['hrfpn'], **extra))


@pytest.mark.parametrize('extra', [
    dict(add_extra_convs='on_input'), dict(norm_cfg=dict(type='GN',
                                                         num_groups=8))])
def test_pafpn_keys_refused(extra):
    """JAX's PAFPN computes with neither extra convs nor a norm."""
    from dynamask_torch.models.builder import build_neck
    with pytest.raises(NotImplementedError, match='3w'), \
            torch.device('meta'):
        build_neck(dict(NECKS['pafpn'], **extra))


def test_jax_regnet_group_count_3ag(tmp_path, capsys):
    """3ag: JAX passes the group width as the group count: its
    ``regnetx_3.2gf`` conv2 kernels are (3, 3, 2, 96) ... (3, 3, 21, 1008),
    48 groups of 2 channels where mmdet has 2 groups of 48. The port
    computes JAX's function, and an mmdet-shaped ``conv2.weight`` is
    refused on load, naming 3ag, by ``load_state_dict`` and by
    ``apply_pretrained``; it is never reshaped."""
    from dynamask_tpu.models.regnet import RegNet as JRegNet
    from dynamask_torch.engine.pretrained import apply_pretrained
    from dynamask_torch.models.builder import build_backbone
    shapes = jax.eval_shape(
        JRegNet(arch='regnetx_3.2gf', block_remat=False).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))['params']
    kernels = [shapes[f'layer{s}_block0']['conv2']['kernel'].shape
               for s in range(1, 5)]
    assert kernels == [(3, 3, 2, 96), (3, 3, 4, 192), (3, 3, 9, 432),
                       (3, 3, 21, 1008)]
    root = torch.nn.Module()
    with torch.device('meta'):
        root.backbone = build_backbone(dict(type='RegNet',
                                            arch='regnetx_3.2gf'))
    root = root.to_empty(device='cpu')
    conv = root.backbone.layer1[0].conv2
    assert conv.groups == 48 and tuple(conv.weight.shape) == (96, 2, 3, 3)
    # mmdet: stage_groups = width // group_width = 2, so (96, 48, 3, 3)
    sd = {k: v.clone() for k, v in root.backbone.state_dict().items()}
    sd['layer1.0.conv2.weight'] = torch.zeros(96, 48, 3, 3)
    with pytest.raises(ValueError, match='3ag'):
        root.backbone.load_state_dict(sd)
    path = tmp_path / 'regnet.pth'
    torch.save({'layer1.0.conv2.weight': torch.zeros(96, 48, 3, 3)}, path)
    with pytest.raises(ValueError, match='3ag'):
        apply_pretrained(root, str(path))
    # a tensor that fits still loads, and another mismatch is reported
    torch.save({'layer1.0.conv2.weight': torch.ones(96, 2, 3, 3),
                'conv1.weight': torch.ones(8, 3, 3, 3)}, path)
    report = apply_pretrained(root, str(path))
    assert report['loaded'] == ['layer1.0.conv2.weight']
    assert len(report['mismatched']) == 1 and torch.equal(
        conv.weight, torch.ones(96, 2, 3, 3))


# per model, the keys of a port state dict the JAX importer has no rule for
# (3ah): they stay at their init in JAX
SKIPPED_BY_JAX = {'hrnet': ('conv2', 'bn2', 'transition', 'branches',
                            'fuse_layers'),
                  'res2net': ('stem.', 'convs.', 'bns.'),
                  'hrfpn': ('reduction_conv',),
                  'pafpn': ('downsample_convs', 'pafpn_convs')}


@pytest.mark.parametrize('name', sorted(SKIPPED_BY_JAX))
def test_jax_importer_skips_the_new_keys_3ah(name):
    """3ah: JAX's ``_mmdet_key`` maps only a ResNet's ``conv1|bn1`` and
    ``layer*`` and the FPN's convs: it skips HRNet's stem ``conv2``/``bn2``,
    transitions, branches and fuse layers, Res2Net's stem, split convs and
    projection BN, HRFPN's reduction conv and PAFPN's bottom-up convs
    (and maps HRNet's ``conv1``/``bn1`` and Res2Net's ``downsample.1`` to
    the wrong leaves). The port's key map takes every one."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    if name in BACKBONES:
        _, _, module, _ = pair(name)
        scope = 'backbone.'
    else:
        _, _, module, _ = neck_pair(name)
        scope = 'neck.'
    holder = torch.nn.Module()
    setattr(holder, scope[:-1], module)
    hints = key_hints(holder)
    keys = [k for k in holder.state_dict()
            if not k.endswith('num_batches_tracked')]
    skipped = [k for k in keys if _mmdet_key(k) is None]
    assert all(mmdet_key(k, **hints) is not None for k in keys)
    assert skipped and all(any(p in k for p in SKIPPED_BY_JAX[name])
                           for k in skipped), skipped[:5]
    counts = {p: sum(p in k for k in skipped) for p in SKIPPED_BY_JAX[name]}
    assert all(counts.values()), counts
    wrong = {'hrnet': ('backbone.conv1.weight', ['backbone', 'conv1'],
                       ['backbone', 'stem_conv1', 'conv']),
             'res2net': ('backbone.layer1.0.downsample.1.weight',
                         ['backbone', 'layer1_block0', 'downsample_bn'],
                         ['backbone', 'layer1_block0', 'downsample_conv'])}
    if name in wrong:
        key, jax_path, port_path = wrong[name]
        assert _mmdet_key(key)[0] == jax_path
        assert mmdet_key(key, **hints)[0] == port_path


def test_res2net_stage_pool_differs_from_mmdet_3ai():
    """3ai: in a stage's strided first block JAX pools the last split 3x3
    at stride 2 in ceil mode with no left padding; mmdet v2's
    ``Bottle2neck`` builds ``AvgPool2d(3, 2, padding=1)`` (padding
    counted), its windows lined up with the strided 3x3 convs'. Same
    size, other windows: the two differ. The port pools as JAX."""
    from dynamask_tpu.models.res2net import _avg_pool
    from dynamask_torch.models.res2net import ceil_avg_pool
    x = np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32)
    jax_pool = np.asarray(_avg_pool(jnp.asarray(x), 3, 2))
    mmdet = torch.nn.AvgPool2d(3, 2, padding=1)(nchw(x))
    port = ceil_avg_pool(nchw(x), 3, 2)
    assert jax_pool.shape == tuple(mmdet.permute(0, 2, 3, 1).shape)
    np.testing.assert_allclose(port.permute(0, 2, 3, 1).numpy(), jax_pool,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(mmdet.permute(0, 2, 3, 1).numpy() - jax_pool).max() > 0.1


def test_jax_hrnet_norm_eval_default_3aj():
    """3aj: JAX's builder defaults HRNet's ``norm_eval`` to True
    (``builder.py:86-91``); mmdet v2's HRNet defaults it to False and the
    HRNet configs set none, so mmdet trains HRNet's BatchNorms on batch
    statistics. On running statistics at their init (mean 0, variance 1)
    nothing bounds HRNet's sums of branches and un-zeroed residuals: at
    the JAX initialisers the full-width HRNet-W18 of
    ``configs/hrnet/mask_rcnn_hrnetv2p_w18_1x_coco.py`` maps a
    unit-variance input to outputs of std > 1e4, where ResNet-50's stay
    below 1. The port computes JAX's function: ``norm_eval`` True, the
    BatchNorms on their running statistics in training mode."""
    from dynamask_tpu.models.builder import build_backbone as jbuild
    from dynamask_torch.models.builder import build_backbone
    from dynamask_torch.models.layers import init_weights
    from dynamask_torch.utils.config import Config
    backbone = Config.fromfile(os.path.join(
        ROOT, 'configs/hrnet/mask_rcnn_hrnetv2p_w18_1x_coco.py')).to_dict()[
            'model']['backbone']
    assert 'norm_eval' not in backbone
    assert jbuild(dict(backbone)).norm_eval is True
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    stds = {}
    for name, cfg in (('hrnet', backbone),
                      ('resnet50', dict(type='ResNet', depth=50))):
        with torch.device('meta'):
            bb = build_backbone(cfg)
        bb = init_weights(bb.to_empty(device='cpu'),
                          torch.Generator().manual_seed(0))
        assert bb.norm_eval is True
        bb.train()
        assert not any(mod.training for mod in bb.modules()
                       if isinstance(mod, torch.nn.BatchNorm2d))
        with torch.no_grad():
            stds[name] = max(float(o.std()) for o in bb(x))
    assert stds['hrnet'] > 1e4 and stds['resnet50'] < 1, stds
