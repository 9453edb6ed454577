"""The ResNet variants of the port against the JAX package's, on the CPU:
caffe style, ResNeXt 32x4d, ResNetV1d, GN, GN + ConvWS and SyncBN (as BN
on one device), each at depth 50 on 2 images of 64x64, built on both sides
by their builders from the same config dict, the JAX weights carried into
the port by its key map (``engine/convert.py``: the deep stem's
``stem.{0,1,3,4,6,7}`` and mmdet's GN names ``gn1``... among them).

- Eval mode: every stage output within 1e-4 relative L2.
- Train mode, with the config's ``norm_eval`` and ``frozen_stages=1``, in
  float64 on both sides: the outputs, and each parameter's gradient of a
  fixed random projection of them within 1e-4 relative L2 (the frozen
  stem and stage 1 get none on either side); with ``frozen_stages=-1``
  the input's gradient within 1e-4 relative L2 (JAX stops it at a frozen
  stage's boundary, the port does not compute it there). In fp32 the
  backward through 50 layers of random weights (BN scales 0.5-1.5, no
  zero-init residuals) amplifies the two sides' rounding to ~1e-2 at
  stage 2's first conv, so float64 holds the function, not the rounding.

Beside them, the JAX package's faults these variants show (ROADMAP.md
queue 3): ``avg_down`` unused, the importer's missing ``stem.*`` and
``gn*`` rules, ``norm_cfg.requires_grad=False`` not freezing the BN affine,
the biased deviation of its ``WSConv`` and its plain stem and projection
convs under ``ConvWS``.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import nchw, randomize_variables  # noqa: E402
from test_torch_port_train_slice import rel_l2                 # noqa: E402

RL2 = 1e-4
VARIANTS = {
    'caffe': dict(type='ResNet', depth=50, style='caffe', norm_eval=True,
                  norm_cfg=dict(type='BN', requires_grad=False)),
    'resnext': dict(type='ResNeXt', depth=50, groups=32, base_width=4,
                    norm_eval=True),
    'v1d': dict(type='ResNetV1d', depth=50, norm_eval=True),
    'gn': dict(type='ResNet', depth=50, norm_eval=False,
               norm_cfg=dict(type='GN', num_groups=32, requires_grad=True)),
    'gn_ws': dict(type='ResNet', depth=50, norm_eval=False,
                  norm_cfg=dict(type='GN', num_groups=32, requires_grad=True),
                  conv_cfg=dict(type='ConvWS')),
    'syncbn': dict(type='ResNet', depth=50, norm_eval=False,
                   norm_cfg=dict(type='SyncBN', requires_grad=True)),
}


@pytest.fixture(scope='module')
def jax_side():
    """``jax_side(name)``: a variant's randomised JAX variables and its
    eval-mode outputs on the input, computed once for the module's three
    tests of the variant. ``frozen_stages`` only stops gradients, so
    neither depends on it."""
    from dynamask_tpu.models.builder import build_backbone as jbuild
    cache = {}

    def get(name):
        if name not in cache:
            x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(
                np.float32)
            jb = jbuild(dict(VARIANTS[name], frozen_stages=1,
                             block_remat=False))
            v = randomize_variables(jb.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)), seed=3)
            cache[name] = (v, x, jb.apply(v, jnp.asarray(x)))
        return cache[name]
    return get


def _pair(jax_side, name, frozen_stages=1):
    """(JAX backbone, its randomised variables, the port backbone under
    ``backbone.`` with them, the input, JAX's eval-mode outputs)."""
    from dynamask_tpu.models.builder import build_backbone as jbuild
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models.builder import build_backbone
    cfg = dict(VARIANTS[name], frozen_stages=frozen_stages)
    v, x, ref = jax_side(name)
    # no per-block rematerialisation: the same function, a smaller graph
    jb = jbuild(dict(cfg, block_remat=False))
    root = torch.nn.Module()
    with torch.device('meta'):
        root.backbone = build_backbone(cfg)
    root = root.to_empty(device='cpu')
    load_jax_variables(root, {'params': {'backbone': v['params']},
                              'batch_stats': {'backbone':
                                              v.get('batch_stats', {})}})
    root.backbone.freeze_stages()
    return jb, v, root.backbone, x, ref


def _cotangents(outs):
    rng = np.random.RandomState(11)
    return [rng.randn(*np.shape(o)).astype(np.float32) for o in outs]


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_backbone_eval(jax_side, name):
    jb, v, port, x, ref = _pair(jax_side, name)
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert len(got) == len(ref) == 4
    for i, (a, b) in enumerate(zip(ref, got)):
        d = rel_l2(b.permute(0, 2, 3, 1).numpy(), a)
        assert d < RL2, f'C{i + 2}: rel-L2 {d:.2e}'


def _jax_train(jb, v, x, cots):
    """Train-mode outputs and the gradients of sum(outputs * cots) in the
    parameters and the input, in float64."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     v)

        def loss(params, xx):
            outs, _ = jb.apply({**v64, 'params': params}, xx, train=True,
                               mutable=['batch_stats'])
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs
        (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(
            v64['params'], jnp.asarray(x, jnp.float64))
        return jax.device_get((outs, grads))


def _port_train(port, x, cots):
    port = port.double()
    xt = nchw(x).double().requires_grad_()
    outs = port.train()(xt)
    sum((o * nchw(c).double()).sum() for o, c in zip(outs, cots)).backward()
    return outs, xt.grad


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_backbone_train_parameter_gradients(jax_side, name):
    """Train mode at ``frozen_stages=1``: outputs and every parameter's
    gradient (the JAX leaf in the port's layout through the key map)."""
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    jb, v, port, x, probe = _pair(jax_side, name)
    cots = _cotangents(probe)
    ref, (jgrads, _) = _jax_train(jb, v, x, cots)
    got, _ = _port_train(port, x, cots)
    for i, (a, b) in enumerate(zip(ref, got)):
        d = rel_l2(b.detach().permute(0, 2, 3, 1).numpy(), a)
        assert d < RL2, f'C{i + 2}: rel-L2 {d:.2e}'
    grads = {'backbone': jax.device_get(jgrads)}
    compared = frozen = 0
    for k, p in port.named_parameters():
        want = _torch_layout(grads, {}, *mmdet_key('backbone.' + k))
        if not p.requires_grad:
            assert p.grad is None and not np.any(want), k
            frozen += 1
            continue
        d = rel_l2(p.grad.numpy(), want)
        assert d < RL2, f'{k}: rel-L2 {d:.2e}'
        compared += 1
    assert frozen > 10 and compared > 100, (frozen, compared)


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_backbone_train_input_gradient(jax_side, name):
    jb, v, port, x, probe = _pair(jax_side, name, frozen_stages=-1)
    cots = _cotangents(probe)
    _, (_, jx) = _jax_train(jb, v, x, cots)
    _, gx = _port_train(port, x, cots)
    d = rel_l2(gx.permute(0, 2, 3, 1).numpy(), np.asarray(jx))
    assert np.abs(np.asarray(jx)).max() > 0 and d < RL2, d


def test_resnext_101_width_and_groups():
    """``configs/mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py``'s backbone:
    stage widths 128/256/512/1024 (32 groups of 4, doubling), grouped
    3x3s, 23 blocks in stage 3."""
    from dynamask_torch.models.builder import build_backbone
    with torch.device('meta'):
        bb = build_backbone(dict(type='ResNeXt', depth=101, groups=32,
                                 base_width=4))
    for i, width in enumerate((128, 256, 512, 1024)):
        block = getattr(bb, f'layer{i + 1}')[0]
        assert block.conv2.weight.shape == (width, width // 32, 3, 3)
        assert block.conv2.groups == 32
        assert block.conv3.out_channels == 256 * 2 ** i
    assert len(bb.layer3) == 23


def test_caffe_stride_on_the_first_1x1():
    from dynamask_torch.models.builder import build_backbone
    with torch.device('meta'):
        caffe = build_backbone(VARIANTS['caffe'])
        torch_style = build_backbone(dict(type='ResNet', depth=50))
    assert caffe.layer2[0].conv1.stride == (2, 2)
    assert caffe.layer2[0].conv2.stride == (1, 1)
    assert torch_style.layer2[0].conv1.stride == (1, 1)
    assert torch_style.layer2[0].conv2.stride == (2, 2)


@pytest.mark.parametrize('cfg,what', [
    (dict(dcn=dict(type='DCN', fallback_on_stride=True),
          stage_with_dcn=(False, True, True, True)), '3w'),
    (dict(plugins=[dict(cfg=dict(type='ContextBlock',
                                 fusion_types=('channel_mul',)))]), '3w'),
    (dict(dcn=dict(type='DCN'), strides=(1, 2, 2, 1),
          dilations=(1, 1, 1, 2)), 'dilation 2'),
    (dict(norm_cfg=dict(type='BN', eps=1e-3)), 'GN(num_groups)'),
    (dict(conv_cfg=dict(type='ConvAWS')), 'Conv and ConvWS')])
def test_unported_keys_refused(cfg, what):
    from dynamask_torch.models.builder import build_backbone
    with pytest.raises(NotImplementedError, match=what.replace('(', r'\(')
                       .replace(')', r'\)')), torch.device('meta'):
        build_backbone(dict(type='ResNet', depth=50, **cfg))


# -- faults of the JAX package (ROADMAP.md queue 3) ---------------------------

def test_jax_avg_down_unused():
    """ResNetV1d's ``avg_down`` changes nothing in JAX: its projections
    are stride-s 1x1 convs, no average pool (mmdet pools, then a stride-1
    conv); the port matches JAX."""
    from dynamask_tpu.models import ResNet as JResNet
    x = jnp.asarray(np.random.RandomState(0).randn(1, 64, 64, 3), jnp.float32)
    a = JResNet(depth=18, deep_stem=True, avg_down=True, block_remat=False)
    b = JResNet(depth=18, deep_stem=True, avg_down=False, block_remat=False)
    v = a.init(jax.random.PRNGKey(0), x)
    for p, q in zip(a.apply(v, x), b.apply(v, x)):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


def test_jax_importer_skips_stem_and_gn_keys():
    """The JAX importer has no rule for the deep stem's ``stem.*`` nor for
    mmdet's GN names: a ResNetV1d or GN checkpoint leaves those leaves at
    their init; the port's key map takes each."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.engine.convert import mmdet_key
    for k in ('backbone.stem.0.weight', 'backbone.stem.7.running_var',
              'backbone.gn1.weight', 'backbone.layer1.0.gn2.bias'):
        assert _mmdet_key(k) is None and mmdet_key(k) is not None, k


def test_jax_requires_grad_false_trains_the_bn_affine():
    """``norm_cfg=dict(requires_grad=False)`` (the caffe configs): JAX's
    builder drops it, and its optimizer freezes only the stem and the
    frozen stages, so a later stage's BN scale still updates; mmdet
    freezes it. The port trains it too, as JAX."""
    from dynamask_tpu.engine.optimizer import build_optimizer as jopt
    from dynamask_tpu.models.builder import build_backbone as jbuild
    from dynamask_torch.apis import init_detector
    jb = jbuild(VARIANTS['caffe'] | dict(frozen_stages=1))
    assert not hasattr(jb, 'requires_grad')
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))['params']
    params = {'backbone': jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype), shapes)}
    tx = jopt(params, 0.01, weight_decay=0.0,
              frozen_backbone_prefixes=jb.frozen_param_paths())
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    upd, _ = tx.update(grads, tx.init(params), params)
    assert np.any(np.asarray(upd['backbone']['layer2_block0']['bn1']['scale']))
    assert not np.any(np.asarray(upd['backbone']['bn1']['scale']))
    model = init_detector(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'configs/mask_rcnn/mask_rcnn_r50_caffe_fpn_1x_coco.py'),
        device='meta')
    bb = model.backbone
    assert bb.layer2[0].bn1.weight.requires_grad
    assert not bb.bn1.weight.requires_grad


def test_jax_ws_conv_biased_std_and_plain_projections():
    """JAX's ``WSConv`` standardises with the biased deviation where mmcv's
    ``ConvWS2d`` takes ``Tensor.std`` (unbiased), and JAX leaves the stem
    and the projections plain where mmdet builds them from ``conv_cfg``;
    the port matches JAX on both."""
    from dynamask_tpu.models.layers import WSConv
    from dynamask_torch.models.builder import build_backbone
    from dynamask_torch.models.layers import ConvWS2d
    w = np.random.RandomState(1).randn(3, 3, 4, 8).astype(np.float32)
    x = np.random.RandomState(2).randn(1, 9, 9, 4).astype(np.float32)
    conv = WSConv(8, (3, 3), padding=1)
    ref = np.asarray(conv.apply({'params': {'kernel': jnp.asarray(w)}},
                                jnp.asarray(x)))
    port = ConvWS2d(4, 8, 3, padding=1, bias=False)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = port(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    wt = port.weight.detach().reshape(8, -1)
    unbiased = (wt - wt.mean(1, keepdim=True)) / (wt.std(1, keepdim=True)
                                                   + 1e-5)
    biased = (wt - wt.mean(1, keepdim=True)) / (
        wt.std(1, unbiased=False, keepdim=True) + 1e-5)
    assert (unbiased - biased).abs().max() > 1e-3
    with torch.device('meta'):
        bb = build_backbone(VARIANTS['gn_ws'])
    assert type(bb.layer1[0].conv2) is ConvWS2d
    assert type(bb.conv1) is torch.nn.Conv2d
    assert type(bb.layer1[0].downsample[0]) is torch.nn.Conv2d
