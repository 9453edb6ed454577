"""The two-stage family's option modules on the CPU: the PyTorch port's
against the JAX package's (``dynamask_tpu/models/bbox_head.py``,
``fpn.py``, ``fcn_mask_head.py``, ``carafe.py``, ``double_head.py``), on
the same seeded inputs, with the JAX weights carried across by
``dynamask_torch.engine.convert``.

- Modules: ``Shared4Conv1FCBBoxHead`` with GN and ``ConvFCBBoxHead``, the
  FPN with GN (with and without ``no_norm_on_lateral``), the FCN mask
  head with GN and with CARAFE, ``FPN_CARAFE``, ``DoubleConvFCBBoxHead``
  in eval and in training mode.
- ``FPN_CARAFE``'s extra lateral reads the P5 lateral (3y).

The other JAX faults of the slice and the phase-13 config files are
``tests/test_torch_port_two_stage_faults.py``'s. Modules (fp32 sums in other orders through a few convs) ``rtol=1e-4,
atol=1e-4``; the toys themselves are ``tests/test_torch_port_two_stage_
twins.py``'s.
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

from test_torch_port_cascade import (_close, _load, _nchw,  # noqa: E402
                                     _wrap)
from test_torch_port_modules import fast_jit, randomize_variables  # noqa: E402
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- modules ------------------------------------------------------------------

def _rng_nhwc(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('kind', ['shared4conv1fc_gn', 'convfc'])
def test_convfc_bbox_head(kind):
    """Four shared 3x3 convs with GN and one fc (GN configs), or the plain
    ``ConvFCBBoxHead`` (two fcs): logits and deltas."""
    from dynamask_tpu.models import bbox_head as jb
    from dynamask_torch.models import bbox_head as tb
    x = _rng_nhwc(0, 6, 7, 7, 16)
    kw = dict(num_classes=5, in_channels=16, fc_out_channels=32)
    if kind == 'convfc':
        jm, port = jb.ConvFCBBoxHead(**kw), tb.ConvFCBBoxHead(**kw)
    else:
        jm = jb.Shared4Conv1FCBBoxHead(norm='gn', gn_groups=4, **kw)
        port = tb.Shared4Conv1FCBBoxHead(norm='gn', gn_groups=4, **kw)
    v = randomize_variables(fast_jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    _load(_wrap(**{'roi_head.bbox_head': port}), ['roi_head', 'bbox_head'],
          v['params'])
    ref = fast_jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    keys = set(port.state_dict())
    if kind == 'convfc':
        assert keys == {f'{m}.{p}' for m in ('shared_fcs.0', 'shared_fcs.1',
                                             'fc_cls', 'fc_reg')
                        for p in ('weight', 'bias')}
    else:
        assert 'shared_convs.3.gn.weight' in keys
        assert 'shared_convs.0.conv.bias' not in keys
        assert 'shared_fcs.1.weight' not in keys
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize('no_norm_on_lateral', [False, True],
                         ids=['gn', 'gn_no_norm_on_lateral'])
def test_fpn_gn(no_norm_on_lateral):
    """GN after each lateral (unless ``no_norm_on_lateral``) and output
    conv, no biases, the top-down adds on the normalised laterals; odd
    level sizes."""
    from dynamask_tpu.models.fpn import FPN as J
    from dynamask_torch.models.fpn import FPN
    ins = (8, 16, 32, 64)
    feats = [_rng_nhwc(i, 2, 33 // 2 ** i + 1, 41 // 2 ** i + 1, c)
             for i, c in enumerate(ins)]
    jm = J(in_channels=ins, out_channels=16, num_outs=5, norm='gn',
           gn_groups=4, no_norm_on_lateral=no_norm_on_lateral)
    v = randomize_variables(fast_jit(jm.init)(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]))
    port = FPN(ins, 16, 5, norm='gn', gn_groups=4,
               no_norm_on_lateral=no_norm_on_lateral)
    _load(_wrap(neck=port), ['neck'], v['params'])
    ref = fast_jit(jm.apply)(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    assert len(got) == 5
    for a, b in zip(got, ref):
        _close(a.permute(0, 2, 3, 1), b)
    assert not any(k.endswith('conv.bias') for k in port.state_dict())
    assert ('lateral_convs.0.gn.weight' in port.state_dict()) != \
        no_norm_on_lateral


@pytest.mark.parametrize('kind', ['gn', 'carafe'])
def test_fcn_mask_head(kind):
    """The mask head with GN on its convs, or with CARAFE in place of the
    deconv: 28x28 logits."""
    from dynamask_tpu.models.fcn_mask_head import FCNMaskHead as J
    from dynamask_torch.models.fcn_mask_head import FCNMaskHead
    x = _rng_nhwc(1, 5, 14, 14, 16)
    kw = dict(num_convs=2, in_channels=16, conv_out_channels=16,
              num_classes=6)
    if kind == 'gn':
        jm, port = (J(norm='gn', gn_groups=4, **kw),
                    FCNMaskHead(norm='gn', gn_groups=4, **kw))
    else:
        jm, port = (J(upsample_type='carafe', **kw),
                    FCNMaskHead(upsample_type='carafe', **kw))
    v = randomize_variables(fast_jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    if kind == 'carafe':     # kernels far from uniform
        enc = v['params']['upsample']['content_encoder']
        enc['kernel'] = np.asarray(enc['kernel']) * 50
    _load(_wrap(**{'roi_head.mask_head': port}), ['roi_head', 'mask_head'],
          v['params'])
    ref = fast_jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (5, 6, 28, 28)
    _close(got.permute(0, 2, 3, 1), ref)


def test_fpn_carafe():
    """``FPN_CARAFE``: laterals, a stride-2 lateral for P6 from the P5
    lateral (3y), CARAFE top-down adds cropped to odd sizes, output convs."""
    from dynamask_tpu.models.carafe import FPN_CARAFE as J
    from dynamask_torch.models.carafe import FPN_CARAFE
    ins = (8, 16, 32, 64)
    feats = [_rng_nhwc(i, 1, 33 // 2 ** i + 1, 41 // 2 ** i + 1, c)
             for i, c in enumerate(ins)]
    jm = J(in_channels=ins, out_channels=16, num_outs=5,
           compressed_channels=8)
    v = randomize_variables(fast_jit(jm.init)(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]))
    port = FPN_CARAFE(ins, 16, 5, compressed_channels=8)
    _load(_wrap(neck=port), ['neck'], v['params'])
    ref = fast_jit(jm.apply)(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    assert [tuple(g.shape[2:]) for g in got] == [(34, 42), (17, 21), (9, 11),
                                                 (5, 6), (3, 3)]
    assert port.lateral_convs[4].conv.in_channels == 16
    for a, b in zip(got, ref):
        _close(a.permute(0, 2, 3, 1), b)


def test_double_conv_fc_bbox_head_and_3v():
    """``DoubleConvFCBBoxHead``: the fc branch on the cls crop, the
    residual tower on the reg crop, eval and training mode both on the
    BatchNorms' running statistics, as JAX's (3v); mmdet's batch
    statistics give other deltas. ``conv_identity`` has a bias (3v)."""
    from dynamask_tpu.models.double_head import DoubleConvFCBBoxHead as J
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models.double_head import DoubleConvFCBBoxHead
    xc, xr = _rng_nhwc(2, 6, 7, 7, 16), _rng_nhwc(3, 6, 7, 7, 16)
    kw = dict(num_classes=5, in_channels=16, num_convs=2,
              conv_out_channels=32, fc_out_channels=32)
    jm = J(**kw)
    v = randomize_variables(fast_jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(xc), jnp.asarray(xr)))
    port = DoubleConvFCBBoxHead(**kw)
    load_jax_variables(_wrap(**{'roi_head.bbox_head': port}), {
        'params': {'roi_head': {'bbox_head': v['params']}},
        'batch_stats': {'roi_head': {'bbox_head': v['batch_stats']}}})
    assert 'res_block.conv_identity.conv.bias' in port.state_dict()
    ref, _ = jm.apply(v, jnp.asarray(xc), jnp.asarray(xr), train=True,
                      mutable=['batch_stats'])
    for mode in (False, True):
        port.train(mode)
        with torch.no_grad():
            got = port(torch.from_numpy(xc), torch.from_numpy(xr))
        for a, b in zip(got, ref):
            _close(a, b)
    for m in port.modules():             # mmdet's training BatchNorms
        if isinstance(m, torch.nn.BatchNorm2d):
            m.train()
    with torch.no_grad():
        mmdet = port(torch.from_numpy(xc), torch.from_numpy(xr))
    assert rel_l2(mmdet[1].numpy(), np.asarray(ref[1])) > 1e-2
