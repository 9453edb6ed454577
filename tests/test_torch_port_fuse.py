"""Conv+BN folding on the CPU: the port's ``engine.fuse_conv_bn`` against
the JAX package's ``engine/fuse.py``.

- The pairs folded equal JAX's in number on the flagship at full width
  and on the R50, X101, caffe, ResNetV1d (the R50 file with its backbone
  swapped: no file names it), HRNet, RegNet, Res2Net and C4 files. JAX's
  count is its own ``fuse_conv_bn`` on zero arrays of the shapes
  ``jax.eval_shape(det.init)`` gives (a trace, no compile), the port's
  from the model built on the ``meta`` device. ResNetV1d's and Res2Net's
  deep stems are the pairs JAX misses (3cf).
- On the toy DynaMask (the JAX twins' weights, non-trivial BatchNorm
  statistics): the folded port model's tensors are JAX's folded
  variables bit for bit, in fp32 and cast to bf16 after the fold; its
  ``simple_test`` against JAX's folded model's and against the port's
  unfolded model's (rtol / atol 2e-4, JAX's ``tests/test_fuse.py``
  tolerance); a folded ``state_dict`` loads into the unfolded model;
  ``tools.fuse_conv_bn`` writes one.
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

from test_torch_port_modules import fast_jit, randomize_variables  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSE_TOL = 2e-4
FAMILIES = {
    'flagship': 'dynamask/coco/r50_dynamask_1x.py',
    'r50': 'mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py',
    'x101': 'mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py',
    'caffe': 'mask_rcnn/mask_rcnn_r50_caffe_fpn_1x_coco.py',
    'v1d': 'mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py',
    'hrnet': 'hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py',
    'regnet': 'regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py',
    'res2net': 'res2net/mask_rcnn_r2_101_fpn_2x_coco.py',
    'c4': 'mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py',
}
# the pairs of each family, JAX's count, and the deep-stem pairs JAX's
# naming rule misses (mmdet's fuse_module folds them)
PAIRS = {'flagship': 55, 'r50': 53, 'x101': 104, 'caffe': 53, 'v1d': 52,
         'hrnet': 305, 'regnet': 80, 'res2net': 169, 'c4': 53}
MISSED = {'v1d': 3, 'res2net': 3}


def _demo():
    from test_models import demo_batch
    return {k: np.array(v) for k, v in
            demo_batch(0, b=1, h=64, w=64, g=3, s=16).items()}


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_pair_count_matches_jax(family):
    from dynamask_tpu.engine.fuse import fuse_conv_bn as jax_fuse
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_tpu.utils.config import Config as JConfig
    from dynamask_torch.engine import conv_bn_pairs
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    rel = os.path.join(ROOT, 'configs', FAMILIES[family])
    jcfg, cfg = JConfig.fromfile(rel), Config.fromfile(rel)
    jmodel, model = copy.deepcopy(jcfg.model), copy.deepcopy(cfg.model)
    if family == 'v1d':
        jmodel['backbone']['type'] = model['backbone']['type'] = 'ResNetV1d'
    det = jax_build(jmodel, jcfg.get('train_cfg'), jcfg.get('test_cfg'))
    shapes = jax.eval_shape(det.init, {'params': jax.random.PRNGKey(0)},
                            {k: jnp.asarray(v) for k, v in _demo().items()})
    _, n_jax = jax_fuse(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = build_detector(model, cfg.get('train_cfg'), cfg.get('test_cfg'),
                          device='meta')
    pairs = conv_bn_pairs(port)
    assert len(pairs) == n_jax == PAIRS[family]
    paired = {bn for _, bn in pairs}
    unpaired = [n for n, m in port.named_modules()
                if isinstance(m, torch.nn.BatchNorm2d) and n not in paired]
    assert len(unpaired) == MISSED.get(family, 0)
    assert all(n.startswith('backbone.stem.') for n in unpaired)


@functools.lru_cache(maxsize=None)
def toy():
    """(JAX toy DynaMask, its randomised variables, the port loaded from
    them, the model config): the twins' weights, BatchNorm means
    N(0, 0.1), variances and scales U(0.5, 1.5)."""
    from test_dynamask import dynamask_toy_cfg
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = dynamask_toy_cfg()
    det = jax_build(*copy.deepcopy(cfg))
    variables = randomize_variables(fast_jit(det.init)(
        {'params': jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in _demo().items()}))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port, cfg


@pytest.mark.parametrize('bf16', [False, True])
def test_folded_tensors_are_jaxs(bf16):
    """Every tensor of the folded port model is the JAX fold's, carried
    across by the key map, exactly; under bf16 the fold is in fp32 and the
    cast after it, as JAX's CLI folds before ``to_bf16``."""
    from dynamask_tpu.core.fp16 import to_bf16 as jax_to_bf16
    from dynamask_tpu.engine.fuse import fuse_conv_bn as jax_fuse
    from dynamask_torch.core.fp16 import to_bf16
    from dynamask_torch.engine import fuse_conv_bn, load_jax_variables
    from dynamask_torch.models import build_detector
    det, variables, port, cfg = toy()
    fused, n = fuse_conv_bn(port)
    jfused, n_jax = jax_fuse(variables)
    assert n == n_jax > 10
    ref = load_jax_variables(build_detector(*cfg, device='cpu'), jfused)
    if bf16:
        fused = to_bf16(fused)
        ref = to_bf16(ref)
        # JAX's cast of its folded tree is the same rounding
        jb = jax_to_bf16(jfused)['params']['backbone']['conv1']['kernel']
        np.testing.assert_array_equal(
            np.asarray(jb, np.float32).transpose(3, 2, 0, 1),
            fused.backbone.conv1.weight.float().numpy())
    got, want = fused.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    # the folded BatchNorms are JAX's neutral ones
    bn = fused.backbone.bn1
    assert torch.all(bn.running_mean == 0) and torch.all(bn.weight == 1)
    assert torch.equal(bn.running_var,
                       torch.full_like(bn.running_var, 1 - 1e-5))


@functools.lru_cache(maxsize=None)
def toy_outputs():
    """``simple_test`` of JAX's folded toy, of the port's folded and
    unfolded toys, on two images at a scale factor of 0.8."""
    from dynamask_tpu.engine.fuse import fuse_conv_bn as jax_fuse
    from dynamask_torch.engine import fuse_conv_bn
    from test_models import demo_batch
    det, variables, port, _ = toy()
    demo = demo_batch(1, b=2, h=64, w=64, g=3, s=16)
    batch = {k: np.array(demo[k]) for k in ('image', 'img_shape',
                                            'ori_shape', 'scale_factor')}
    batch['scale_factor'][1:] = 0.8
    jfused, _ = jax_fuse(variables)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: det.apply(v, b, method='simple_test'))(
            jfused, {k: jnp.asarray(v) for k, v in batch.items()}))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    fused, _ = fuse_conv_bn(port)
    with torch.no_grad():
        return ref, fused.simple_test(t), port.eval().simple_test(t)


@pytest.mark.parametrize('against', ['jax_fused', 'port_unfused'])
def test_folded_toy_outputs(against):
    ref, fused, unfused = toy_outputs()
    want = ref if against == 'jax_fused' else {
        k: v.numpy() for k, v in unfused.items()}
    valid = np.asarray(want['det_valid']).astype(bool)
    assert valid.sum() >= 4
    np.testing.assert_array_equal(fused['det_valid'].numpy(),
                                  want['det_valid'])
    np.testing.assert_array_equal(fused['labels'].numpy(), want['labels'])
    for k in ('dets', 'mask_probs'):
        np.testing.assert_allclose(fused[k].numpy(), want[k], rtol=FUSE_TOL,
                                   atol=FUSE_TOL, err_msg=k)


def test_folded_state_dict_loads_into_unfolded_model(tmp_path):
    """A folded ``state_dict`` (``tools.fuse_conv_bn``'s file) loads,
    strict, into the unfolded model, which then computes the folded
    model's function exactly; the tool prints JAX's count."""
    from dynamask_torch.engine import fuse_conv_bn
    from dynamask_torch.models import build_detector
    from dynamask_torch.tools.fuse_conv_bn import main
    from test_torch_port_eval_slice import _write_cfg
    _, _, port, (model, train_cfg, test_cfg) = toy()
    ckpt, out = str(tmp_path / 'toy.pth'), str(tmp_path / 'fused.pth')
    torch.save(port.state_dict(), ckpt)
    cfg = _write_cfg(tmp_path / 'toy_cfg.py', dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg))
    assert main([cfg, ckpt, out]) == 0
    fused, n = fuse_conv_bn(port)
    plain = build_detector(model, train_cfg, test_cfg, device='cpu', seed=1)
    plain.load_state_dict(torch.load(out)['state_dict'])
    batch = {k: torch.from_numpy(v) for k, v in _demo().items()
             if k in ('image', 'img_shape', 'ori_shape', 'scale_factor')}
    with torch.no_grad():
        got, want = plain.eval().simple_test(batch), fused.simple_test(batch)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert torch.load(out)['meta']['fused_conv_bn']
