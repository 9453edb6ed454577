"""The RefineMask family on the CPU: the PyTorch port's modules against the
JAX package's (``dynamask_tpu/models/refine_mask_head.py``), on the same
seeded inputs with the JAX weights carried across by
``dynamask_torch.engine.convert``.

- Components: ``MultiBranchFusion`` (summed, and with the spatial mean),
  ``RefineSFMStage`` (logits and semantic mask raw or through a sigmoid),
  ``SimpleSFMStage``, both heads at 32 channels over 8 classes and in
  LVIS's form (a class-agnostic last stage), ``ClassSelectConv1x1``
  against the full conv and a class select (values and gradients), the
  BAR loss (``refine_cross_entropy_loss``) with padded slots, value and
  gradient, the same stage logits given to both sides.
- Data: ``gt_semantic`` of ``format_sample(with_semantic=True)`` and of a
  ``CocoDataset(with_semantic=True)`` (the flagship's train pipeline:
  resize, flips, an RLE mask that adds nothing) bit-identical to JAX's.
- The toy detectors of ``tests/test_refinemask.py`` (ResNet-18,
  32-channel FPN, 8 classes, 64x64): ``simple_test`` + paste slot for
  slot, one training step's losses and per-leaf gradients with the draws
  injected; the test loops on a seeded COCO set; ``train_steps`` from a
  loader batch and ``train_detector`` on the CPU.
- The six ``configs/refinemask/`` files build on the CPU; every key maps
  through the port's key map; the keys the JAX importer skips (a JAX
  fault: a reference RefineMask checkpoint leaves the JAX mask head at its
  init) are listed and shown left at init; ``apis.config_shapes`` and the
  canvases and names of each config's test set; the seeded init of every
  new leaf drawn from JAX's initialiser.

Tolerances as ``tests/test_torch_port_configs.py``: dets ``rtol=1e-5,
atol=1e-4``; mask probabilities ``atol=2e-4``, pixels within 1e-3 of the
threshold left out of binary compares; losses 1e-4 relative; gradients
1e-3 relative L2. Module outputs (fp32 sums in other orders through a few
convs) ``rtol=1e-4``, ``atol=1e-4``.
"""

import copy
import functools
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import fast_jit  # noqa: E402
from test_torch_port_configs import _wrap  # noqa: E402
from test_torch_port_modules import nchw, randomize_variables  # noqa: E402
from test_torch_port_train_slice import jax_draws, rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'r50_1x': 'configs/refinemask/coco/r50_refinemask_1x.py',
    'r50_2x': 'configs/refinemask/coco/r50_refinemask_2x.py',
    'r101_1x': 'configs/refinemask/coco/r101_refinemask_1x.py',
    'r101_2x': 'configs/refinemask/coco/r101_refinemask_2x.py',
    'lvis': 'configs/refinemask/lvis/r50_refinemask_lvis_1x.py',
    'cityscapes': 'configs/refinemask/cityscapes/r50_refinemask_1x.py',
}
ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
MASK_ATOL = 2e-4
# the port keys of RefineMask leaves the JAX importer (``_mmdet_key``,
# dynamask_tpu/engine/pretrained.py:120-215) has no rule for
JAX_SKIPPED = re.compile(
    r'^roi_head\.mask_head\.(semantic_convs\.\d+\.conv|semantic_logits|'
    r'stages\.\d+\.semantic_transform_out|'
    r'stages\.\d+\.fuse_conv\.1\.(dilation_conv_\d+|merge_conv)\.conv|'
    r'stage_instance_logits\.\d+)\.(weight|bias)$')


def _close(got, ref, atol=ATOL, msg=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4,
                               atol=atol, err_msg=msg)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(port, path, params):
    """Load the JAX ``params`` of a module that sits at the dotted JAX
    ``path`` into ``port``."""
    from dynamask_torch.engine import load_jax_variables
    tree = params
    for p in reversed(path):
        tree = {p: tree}
    load_jax_variables(port, {'params': tree})
    return port


def _at(module, path):
    for p in path.split('.'):
        module = getattr(module, p)
    return module


def _rois(rng, n, size=64.0):
    xy = rng.uniform(-4, size - 12, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# -- components ---------------------------------------------------------------

@pytest.mark.parametrize('with_avg', [False, True])
def test_multi_branch_fusion(with_avg):
    from dynamask_tpu.models.refine_mask_head import MultiBranchFusion as J
    from dynamask_torch.models.refine_mask_head import MultiBranchFusion
    x = np.random.RandomState(1).randn(3, 14, 14, 16).astype(np.float32)
    jm = J(16, (1, 3, 5), with_avg=with_avg)
    v = randomize_variables(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                            seed=2)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = _load(_wrap(**{'roi_head.mask_head.stages.0.fuse_conv.1':
                          MultiBranchFusion(16, (1, 3, 5), with_avg)}),
                 ['roi_head', 'mask_head', 'stage_0', 'fuse_conv_1'],
                 v['params'])
    with torch.no_grad():
        got = _at(port, 'roi_head.mask_head.stages.0.fuse_conv.1')(nchw(x))
    _close(_nhwc(got), ref)
    # the mean term is there only in the Avg form
    plain = np.asarray(J(16, (1, 3, 5)).apply(v, jnp.asarray(x)))
    assert (np.abs(plain - ref).max() > 1e-3) == with_avg


def _stage_inputs(seed=3, n=6, s=14, c=32, cs=32, b=2):
    rng = np.random.RandomState(seed)
    return dict(
        inst=rng.randn(n, s, s, c).astype(np.float32),
        sem=rng.randn(b, 16, 16, cs).astype(np.float32),
        sem_pred=rng.randn(b, 16, 16, 1).astype(np.float32),
        rois=_rois(rng, n), batch=(np.arange(n) % b).astype(np.int32),
        labels=rng.randint(0, 8, n).astype(np.int32))


@pytest.mark.parametrize('mask_use_sigmoid', [False, True])
def test_refine_sfm_stage(mask_use_sigmoid):
    """The stage's class-selected logits (N, 14, 14, 1) and its fused
    features at 28x28 (30 channels + the logits + the semantic mask)."""
    from dynamask_tpu.models.refine_mask_head import RefineSFMStage as J
    from dynamask_torch.models.refine_mask_head import RefineSFMStage
    a = _stage_inputs()
    jm = J(semantic_out_channel=32, instance_in_channel=32,
           instance_out_channel=16, out_size=14, num_classes=8,
           mask_use_sigmoid=mask_use_sigmoid)
    args = [jnp.asarray(a[k]) for k in ('inst', 'sem', 'sem_pred', 'rois',
                                         'batch', 'labels')]
    v = randomize_variables(jm.init(jax.random.PRNGKey(0), *args), seed=4)
    ref_p, ref_f = (np.asarray(t) for t in jm.apply(v, *args))
    port = _load(_wrap(**{'roi_head.mask_head.stages.0': RefineSFMStage(
        32, 32, 32, 16, 14, 8, mask_use_sigmoid=mask_use_sigmoid)}),
        ['roi_head', 'mask_head', 'stage_0'], v['params'])
    with torch.no_grad():
        got_p, got_f = _at(port, 'roi_head.mask_head.stages.0')(
            nchw(a['inst']), nchw(a['sem']), nchw(a['sem_pred']),
            torch.from_numpy(a['rois']), torch.from_numpy(a['batch']),
            torch.from_numpy(a['labels']))
    assert ref_p.shape == (6, 14, 14, 1) and ref_f.shape == (6, 28, 28, 16)
    _close(_nhwc(got_p), ref_p)
    _close(_nhwc(got_f), ref_f)


@pytest.mark.parametrize('upsample', [True, False])
def test_simple_sfm_stage(upsample):
    from dynamask_tpu.models.refine_mask_head import SimpleSFMStage as J
    from dynamask_torch.models.refine_mask_head import SimpleSFMStage
    a = _stage_inputs(seed=5)
    logits = np.random.RandomState(6).randn(6, 14, 14, 1).astype(np.float32)
    jm = J(semantic_out_channel=32, instance_in_channel=32,
           instance_out_channel=16, out_size=14)
    args = [jnp.asarray(x) for x in (a['inst'], logits, a['sem'], a['rois'],
                                     a['batch'])]
    v = randomize_variables(jm.init(jax.random.PRNGKey(0), *args), seed=7)
    ref = np.asarray(jm.apply(v, *args, upsample))
    port = _load(_wrap(**{'roi_head.mask_head.stages.0': SimpleSFMStage(
        32, 32, 32, 16, 14)}), ['roi_head', 'mask_head', 'stage_0'],
        v['params'])
    with torch.no_grad():
        got = _at(port, 'roi_head.mask_head.stages.0')(
            nchw(a['inst']), nchw(logits), nchw(a['sem']),
            torch.from_numpy(a['rois']), torch.from_numpy(a['batch']),
            upsample)
    assert ref.shape == (6, 28 if upsample else 14, 28 if upsample else 14,
                         16)
    _close(_nhwc(got), ref)


HEAD_KW = dict(num_convs_instance=2, num_convs_semantic=2,
               conv_out_channels_instance=32, conv_out_channels_semantic=32)


@pytest.mark.parametrize('simple', [False, True], ids=['refine', 'simple'])
@pytest.mark.parametrize('classes', [(8, 8, 8, 8), (8, 8, 8, 1)],
                         ids=['8', 'lvis_form'])
def test_mask_head(simple, classes):
    """Every stage's logits (14, 28, 56, 112) and, for ``RefineMaskHead``,
    the semantic logits of P2, at 32 channels."""
    from dynamask_tpu.models import refine_mask_head as J
    from dynamask_torch.models import refine_mask_head as P
    rng = np.random.RandomState(8)
    n, b = 5, 2
    inst = rng.randn(n, 14, 14, 32).astype(np.float32)
    p2 = rng.randn(b, 16, 16, 32).astype(np.float32)
    rois = _rois(rng, n)
    batch = (np.arange(n) % b).astype(np.int32)
    labels = rng.randint(0, 8, n).astype(np.int32)
    kw = dict(HEAD_KW, stage_num_classes=classes)
    if simple:
        jm, head = J.SimpleRefineMaskHead(**kw), P.SimpleRefineMaskHead(
            conv_in_channels_instance=32, conv_in_channels_semantic=32, **kw)
    else:
        jm = J.RefineMaskHead(mask_use_sigmoid=True, **kw)
        head = P.RefineMaskHead(conv_in_channels_instance=32,
                                conv_in_channels_semantic=32,
                                mask_use_sigmoid=True, **kw)
    args = [jnp.asarray(x) for x in (inst, p2, rois, batch, labels)]
    v = randomize_variables(jm.init(jax.random.PRNGKey(0), *args), seed=9)
    ref_preds, ref_sem = jm.apply(v, *args)
    port = _load(_wrap(**{'roi_head.mask_head': head}),
                 ['roi_head', 'mask_head'], v['params'])
    with torch.no_grad():
        preds, sem = port.roi_head.mask_head(
            nchw(inst), nchw(p2), *(torch.from_numpy(x) for x in
                                    (rois, batch, labels)))
    assert [p.shape[-1] for p in preds] == [14, 28, 56, 112]
    for i, (g, r) in enumerate(zip(preds, ref_preds)):
        r = np.asarray(r)
        _close(_nhwc(g), r, atol=ATOL * max(1.0, np.abs(r).max()),
               msg=f'stage {i}')
    if simple:
        assert sem is None and ref_sem is None
    else:
        assert sem.shape == (b, 1, 16, 16)
        _close(_nhwc(sem), np.asarray(ref_sem))


@pytest.mark.parametrize('s', [14, 28, 56])
def test_fuse_pair_against_jax(s):
    """``core.boundary.fuse_pair``, the test-time boundary fusion that
    RefineMask and DynaMask share, against the JAX head's ``_fuse_pair``
    at each step of the cascade; pixels whose upsampled boundary flag lies
    within 1e-3 of its 0.5 threshold are left out."""
    import types
    from dynamask_tpu.models.dynamask_roi_head import DynaMaskRoIHead as J
    from dynamask_torch.core.boundary import (
        TEST_BOUNDARY_WIDTH, fuse_pair, generate_block_target,
        interpolate_bilinear)
    rng = np.random.RandomState(s)
    cur = (3 * rng.randn(6, s, s)).astype(np.float32)
    nxt = (3 * rng.randn(6, 2 * s, 2 * s)).astype(np.float32)
    got = fuse_pair(torch.from_numpy(cur), torch.from_numpy(nxt)).numpy()
    ref = np.asarray(J._fuse_pair(
        types.SimpleNamespace(test_boundary_width=TEST_BOUNDARY_WIDTH),
        jnp.asarray(cur), jnp.asarray(nxt)))
    nb = (generate_block_target((torch.from_numpy(cur) >= 0).float(),
                                TEST_BOUNDARY_WIDTH) != 1).float()
    flag = interpolate_bilinear(nb, 2 * s, 2 * s).numpy()
    keep = np.abs(flag - 0.5) >= 1e-3
    assert keep.mean() > 0.9
    # both sources of each output pixel are taken
    assert ((got == nxt) & keep).any() and ((got != nxt) & keep).any()
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-5, atol=1e-5)


def test_class_select_conv_against_full_conv():
    """``ClassSelectConv1x1`` against the full per-class conv and a select
    of each RoI's class, values and gradients (input, weight, bias), with
    labels past the classes clamped as the JAX select clamps them; and
    against the JAX ``nn.Conv`` + ``_select_class``."""
    import flax.linen as fnn
    import torch.nn.functional as F
    from dynamask_tpu.models.dynamask_head import _select_class
    from dynamask_torch.models.dynamask_head import ClassSelectConv1x1
    rng = np.random.RandomState(10)
    x = rng.randn(7, 16, 9, 9).astype(np.float32)
    labels = np.array([0, 3, 12, 5, 11, -1, 2])
    g_out = rng.randn(7, 1, 9, 9).astype(np.float32)
    m = ClassSelectConv1x1(16, 12)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.randn(12, 16, 1, 1)
                                        .astype(np.float32)))
        m.bias.copy_(torch.from_numpy(rng.randn(12).astype(np.float32)))
    w = m.weight.detach().clone().requires_grad_()
    b = m.bias.detach().clone().requires_grad_()
    xs = [torch.from_numpy(x).requires_grad_() for _ in range(2)]
    got = m(xs[0], torch.from_numpy(labels))
    full = F.conv2d(xs[1], w, b)
    safe = torch.from_numpy(labels).clamp(0, 11)
    ref = full[torch.arange(7), safe][:, None]
    _close(got.detach(), ref.detach(), atol=1e-5)
    got.backward(torch.from_numpy(g_out))
    ref.backward(torch.from_numpy(g_out))
    for a, r in ((xs[0].grad, xs[1].grad), (m.weight.grad, w.grad),
                 (m.bias.grad, b.grad)):
        assert rel_l2(a.numpy(), r.numpy()) < 1e-6
    # the JAX form: the full conv's NHWC logits and the class select
    kernel = m.weight.detach().numpy().transpose(2, 3, 1, 0)
    jref = _select_class(fnn.Conv(12, (1, 1)).apply(
        {'params': {'kernel': kernel, 'bias': m.bias.detach().numpy()}},
        jnp.asarray(x.transpose(0, 2, 3, 1))), jnp.asarray(labels))
    _close(_nhwc(got), np.asarray(jref), atol=1e-5)


@pytest.mark.parametrize('boundary_width,start_stage', [(2, 1), (1, 0)])
def test_refine_loss_and_grad(boundary_width, start_stage):
    """The BAR loss and its gradient in every stage's logits, the same
    logits and targets on both sides, three of eight slots padded."""
    from dynamask_tpu.models.refine_mask_head import \
        refine_cross_entropy_loss as jloss
    from dynamask_torch.models.refine_mask_head import \
        refine_cross_entropy_loss
    rng = np.random.RandomState(11)
    sizes, r = (14, 28, 56, 112), 8
    preds = [(rng.randn(r, s, s, 1) * 2).astype(np.float32) for s in sizes]
    targets = [(rng.uniform(size=(r, s, s)) > 0.5).astype(np.float32)
               for s in sizes]
    valid = np.array([1, 1, 0, 1, 1, 0, 1, 0], bool)
    weights = (0.25, 0.5, 0.75, 1.0)
    # no logit where a sigmoid >= 0.5 decision could part
    for p in preds:
        p[np.abs(p) < 1e-3] = 1e-2
    ref, ref_g = jax.jit(jax.value_and_grad(lambda ps: jloss(
        ps, [jnp.asarray(t) for t in targets], jnp.asarray(valid), weights,
        boundary_width, start_stage)))([jnp.asarray(p) for p in preds])
    ts = [torch.from_numpy(p).permute(0, 3, 1, 2).requires_grad_()
          for p in preds]
    got = refine_cross_entropy_loss(
        ts, [torch.from_numpy(t) for t in targets], torch.from_numpy(valid),
        weights, boundary_width, start_stage)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_RTOL)
    for i, (t, g) in enumerate(zip(ts, ref_g)):
        g = np.asarray(g)
        assert not g[~valid].any() and not t.grad[~valid].any()
        assert np.abs(g).max() > 0
        assert rel_l2(_nhwc(t.grad), g) < GRAD_RL2, i



# -- K2 and K4 at RefineMask's crops -------------------------------------------

# (n, P, s, C): the P2 crops of the three stages, the semantic features
# (C = 256, 128, 64) and the one-channel semantic mask, at ratio 2, for the
# training step's 512 slots and an image's 100 (LVIS: 300) dets
REFINE_SHAPES = [(n, p, 2, c) for n in (512, 100, 300)
                 for p, c in ((14, 256), (28, 128), (56, 64), (14, 1),
                              (28, 1), (56, 1))]


@pytest.mark.parametrize('kernel', ['k2', 'k4'])
@pytest.mark.parametrize('shape', REFINE_SHAPES,
                         ids=lambda s: 'n{}_P{}_s{}_C{}'.format(*s))
def test_launch_config_at_refinemask_crops(shape, kernel):
    """The K2/K4 launch rules of ``test_torch_port_roi_bands.py`` at
    RefineMask's crops; at C = 1 the scalar instance, one lane an entry,
    and in K2 one band per RoI where the RoIs alone give ``MIN_BLOCKS``
    blocks."""
    from dynamask_torch.ops import roi_align as ra
    import test_torch_port_roi_bands as bands
    bands.test_launch_config(shape, kernel)
    n, p, s, c = shape
    cfg = ra.roi_align_launch_config(kernel, n, p, s, c)
    if c == 1:
        assert (cfg['vec'], cfg['lanes_log2']) == (1, 0)
        assert kernel == 'k4' or (cfg['n_bands'] == 1) == (
            n >= ra.MIN_BLOCKS)
    else:
        assert cfg['vec'] == 4


@pytest.mark.parametrize('p', [14, 28])
def test_one_channel_replays(p):
    """K2's table form and K4's gather, band by band at their launch
    configuration, on a one-channel plane (the semantic mask's crop at
    stride 4, ratio 2), equal the plain versions and the JAX package's
    crop and its ``jax.grad``."""
    import importlib
    import test_torch_port_roi_bands as bands
    from dynamask_torch.ops import roi_align as ra
    jra = importlib.import_module('dynamask_tpu.ops.roi_align')
    rng = np.random.RandomState(p)
    feats, rois, batch = bands._single(rng, 12, 2, 18, 22, 1, 0.25)
    args = bands._single_args(feats, rois, batch, 0.25)
    n = len(rois)

    def jfwd(f):
        return jra.roi_align(f, jnp.asarray(rois),
                             jnp.asarray(batch, jnp.int32), p, 0.25,
                             sampling_ratio=2)
    band = ra.roi_align_launch_config('k2', n, p, 2, 1)['band_rows']
    got = bands._k2_by_bands(args, p, 2, band)
    np.testing.assert_allclose(got.numpy(), ra.roi_align_fwd_plain(
        *args, p, 2).numpy(), rtol=0, atol=bands.TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfwd(jnp.asarray(
        feats))), rtol=0, atol=bands.TOL)
    d_out = torch.from_numpy(rng.randn(n, p, p, 1).astype(np.float32))
    band = ra.roi_align_launch_config('k4', n, p, 2, 1)['band_rows']
    rows = args[0].shape[0]
    got = bands._k4_gather_by_bands(d_out, rows, args, p, 2, band)
    plain = ra.roi_align_bwd_plain(d_out, rows, *args[1:], p, 2)
    scale = float(plain.abs().max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=bands.TOL * scale)
    ref = jax.grad(lambda f: jnp.sum(jfwd(f) * jnp.asarray(d_out.numpy())))(
        jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(-1, 1),
                               rtol=0, atol=bands.TOL * scale)
    assert (got != 0).any()

# -- data -----------------------------------------------------------------------

def _results(flip):
    """A pipeline output with polygon GTs (one of two parts), an RLE GT and
    one GT past ``max_gts``, on an 800x1216 image of a 800x1344 canvas."""
    from dynamask_tpu.data import mask_codec as jc
    rng = np.random.RandomState(12)
    polys, boxes = [], []
    for k in range(5):
        x, y = rng.uniform(0, 1100), rng.uniform(0, 700)
        w, h = rng.uniform(20, 200, 2)
        poly = [x, y, x + w, y + 0.3 * h, x + 0.6 * w, y + h, x - 5, y + h]
        polys.append([poly] if k != 2 else
                     [poly, [x + 30, y + 30, x + 60, y + 30, x + 40, y + 70]])
        boxes.append([x - 5, y, x + w, y + h])
    m = np.zeros((640, 960), np.uint8)
    m[100:300, 200:500] = 1
    rle = dict(jc.encode_mask(m), _flip=flip)
    return {'img': rng.randn(800, 1216, 3).astype(np.float32),
            'img_shape': (800, 1216, 3), 'ori_shape': (640, 960, 3),
            'scale_factor': np.array([1.2667, 1.25, 1.2667, 1.25],
                                     np.float32),
            'flip': flip, 'gt_bboxes': np.array(boxes[:4] + [[200, 100, 500,
                                                                300]],
                                                np.float32),
            'gt_labels': np.arange(5), 'gt_masks': polys[:3] + [rle] +
            polys[3:4]}


@pytest.mark.parametrize('flip', [False, True])
def test_format_sample_semantic(flip):
    """``gt_semantic`` (the canvas at stride 4) equal to JAX's bit for
    bit: polygons filled, the RLE GT skipped, GTs past ``max_gts``
    left out."""
    from dynamask_tpu.data.formatting import format_sample as jfmt
    from dynamask_torch.data import format_sample
    res = _results(flip)
    canvases = [(800, 1344), (1344, 800)]
    for max_gts in (5, 2):
        ref = jfmt(copy.deepcopy(res), canvases, max_gts=max_gts,
                   crop_size=32, with_semantic=True)
        got = format_sample(copy.deepcopy(res), canvases, max_gts=max_gts,
                            crop_size=32, with_semantic=True)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got['gt_semantic'].shape == (200, 336)
        assert got['gt_semantic'].dtype == np.uint8
        assert 0 < got['gt_semantic'].sum() < got['gt_semantic'].size
    assert 'gt_semantic' not in format_sample(res, canvases, crop_size=32)


def test_dataset_semantic_bit_identical(tmp_path):
    """``CocoDataset(with_semantic=True)`` through the flagship's train
    pipeline (resize to 1333x800, random flips, an RLE-segmented GT) and
    the loader's collate: every array equal to the JAX dataset's."""
    from test_data import make_synthetic_coco
    from test_torch_port_data import _pair, _with_crowd_and_rle
    from dynamask_tpu.data import collate as jax_collate
    from dynamask_torch.data import build_dataloader, collate
    ann_file, img_dir = make_synthetic_coco(tmp_path)
    _with_crowd_and_rle(ann_file)
    ref_ds, ds = _pair((ann_file, img_dir), 'train', with_semantic=True)
    assert ds.with_semantic
    flipped = 0
    for i in range(len(ds)):
        ref, got = ref_ds[i], ds[i]
        assert 'gt_semantic' in got and sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        flipped += bool(got['flip'])
        assert got['gt_semantic'].shape == tuple(
            s // 4 for s in got['image'].shape[:2])
    assert 0 < flipped < len(ds)
    # a batch of two same-canvas samples, collated on both sides, and the
    # loader's batch carrying it as uint8
    i, j = np.nonzero(ds.flags == ds.flags[0])[0][:2]
    got = collate([ds[i], ds[j]])
    ref = jax_collate([ref_ds[i], ref_ds[j]])
    assert got['gt_semantic'].dtype == torch.uint8
    np.testing.assert_array_equal(got['gt_semantic'].numpy(),
                                  ref['gt_semantic'])
    batch = next(iter(build_dataloader(ds, 2, workers_per_gpu=0)))
    assert batch['gt_semantic'].dtype == torch.uint8
    assert batch['gt_semantic'].shape[1:] == tuple(
        s // 4 for s in batch['image'].shape[1:3])



@pytest.mark.parametrize('which', ['lvis', 'cityscapes'])
def test_lvis_and_cityscapes_train_sets_with_semantic(tmp_path, which):
    """The RefineMask LVIS and Cityscapes configs' train sets, through
    their own pipelines on seeded sets in each format (LVIS inside its
    ``ClassBalancedDataset``, which passes ``with_semantic`` to the inner
    set): every array, ``gt_semantic`` among them, equal to JAX's."""
    import test_torch_port_lvis_cityscapes as lc
    from test_torch_port_data import _seeded
    make = lc.make_lvis_set if which == 'lvis' else lc.make_cityscapes_set
    ref_ds, ds = lc._pair(os.path.join(ROOT, CONFIGS[which]), 'train',
                          *make(tmp_path))
    for d in (lc._inner(ref_ds), lc._inner(ds)):
        _seeded(d)
    assert lc._inner(ds).with_semantic
    assert type(ds).__name__ == ('ClassBalancedDataset' if which == 'lvis'
                                 else 'CityscapesDataset')
    got = lc._assert_samples_equal(ref_ds, ds)
    assert got['gt_semantic'].shape == tuple(
        s // 4 for s in got['image'].shape[:2])
    assert got['gt_semantic'].any()

# -- the toy detectors ---------------------------------------------------------

def toy_cfg(kind):
    from test_refinemask import refinemask_toy_cfg, simple_refinemask_toy_cfg
    return (simple_refinemask_toy_cfg if kind == 'simple'
            else refinemask_toy_cfg)()


def _demo(b=1):
    from test_models import demo_batch
    batch = {k: np.array(v) for k, v in
             demo_batch(0, b=b, h=64, w=64, g=3, s=16).items()}
    rng = np.random.RandomState(13)
    batch['gt_semantic'] = (rng.uniform(size=(b, 16, 16)) > 0.6).astype(
        np.uint8)
    return batch


@functools.lru_cache(maxsize=None)
def refine_pair(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them, the model config)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    model, train_cfg, test_cfg = toy_cfg(kind)
    det = jax_build(model, train_cfg, test_cfg)
    batch = {k: jnp.asarray(v) for k, v in _demo().items()}
    variables = randomize_variables(
        fast_jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    if kind == 'simple':
        # these draws put its stage logits at -48 +- 17 (28x28) and every
        # mask probability under 1e-7; a twentieth of each logit kernel
        # keeps them in sigmoid's range, so that the compare of the
        # probabilities has teeth
        head = variables['params']['roi_head']['mask_head']
        for i in range(4):
            leaf = head[f'stage_instance_logits_{i}']
            head[f'stage_instance_logits_{i}'] = dict(
                leaf, kernel=np.asarray(leaf['kernel']) * 0.05)
    port = build_detector(model, train_cfg, test_cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port, (model, train_cfg, test_cfg)


KINDS = ['refine', 'simple']


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test_and_paste(kind):
    """Dets, labels, validity, 112x112 mask probabilities and the pasted
    masks slot for slot, two images with a non-unit scale factor, through
    ``inference_detector`` on a batch (``make_test_fn`` + paste)."""
    from dynamask_tpu.apis.test import _paste_epilogue
    from dynamask_torch.apis import inference_detector
    from dynamask_torch.models.refine_mask_head import RefineRoIHead
    det, variables, port, _ = refine_pair(kind)
    assert isinstance(port.roi_head, RefineRoIHead)
    assert port.roi_head.with_semantic == (kind == 'refine')
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch_np = {k: _demo(2)[k] for k in keys}
    batch_np['scale_factor'][1:] = 0.8
    ref, ref_epi = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: (lambda o: (o, _paste_epilogue(o, 64, 64, 0.5)))(
            det.apply(v, b, method='simple_test')))(
        variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    batch_t = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    got = inference_detector(port, batch_t)
    with torch.no_grad():
        out = port.simple_test(batch_t)
    for i in range(2):
        assert ref['det_valid'][i].sum() >= 4
    np.testing.assert_array_equal(got['valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    probs = out['mask_probs'].numpy()
    assert probs.shape == (2, 8, 112, 112)
    assert probs.std() > 1e-2          # not saturated: the compare has teeth
    np.testing.assert_allclose(probs, ref['mask_probs'], atol=MASK_ATOL)
    from dynamask_torch.ops.paste import paste_masks
    pasted = paste_masks(out['mask_probs'].reshape(16, 112, 112),
                         out['dets'][..., :4].reshape(16, 4), 64,
                         64).numpy().reshape(2, 8, 64, 64)
    clear = np.abs(pasted - 0.5) > 1e-3
    np.testing.assert_array_equal(got['masks'].numpy()[clear],
                                  ref_epi['masks'][clear])


def _port_grads(port):
    """{port key: gradient} of every parameter (zeros where none)."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().numpy().copy() for k, p in port.named_parameters()}


@functools.lru_cache(maxsize=None)
def refine_step(kind):
    """One training step's logs and gradients on both sides, from the same
    variables and draws; the JAX gradients in the port's layout, key by
    key, through the port's own key map (the JAX importer skips the
    RefineMask leaves)."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port, _ = refine_pair(kind)
    port = copy.deepcopy(port).train()
    batch = _demo()
    rng = np.random.RandomState(14)
    n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = {'rpn': rng.uniform(size=(1, n_anchors)).astype(np.float32),
             'rcnn': rng.uniform(size=(1, 3 + 32)).astype(np.float32),
             'gumbel': np.zeros((8, 4), np.float32)}   # no MSM: unread

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax_draws(noise):
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables['batch_stats'],
            {k: jnp.asarray(x) for k, x in batch.items()})
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()},
        {k: torch.from_numpy(x) for k, x in noise.items()}))
    total.backward()
    got = _port_grads(port)
    jax_grads = jax.device_get(jax_grads)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k)) for k in got}
    return ({k: v.detach().numpy() for k, v in log.items()},
            jax.device_get(jax_log), got, ref)


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    port_log, jax_log, _, _ = refine_step(kind)
    keys = {k for k in jax_log if 'loss' in k or k == 'acc'}
    want = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox', 'acc',
            'loss_instance', 'loss'}
    assert keys == (want | {'loss_semantic'} if kind == 'refine' else want)
    assert keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert jax_log['loss_instance'] > 0


@pytest.mark.parametrize('kind', KINDS)
def test_per_leaf_gradients(kind):
    """Every parameter: the frozen stem gets none on either side; every
    mask-head leaf, the ones the JAX importer skips among them, gets
    some."""
    _, _, got, ref = refine_step(kind)
    compared = 0
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        d = rel_l2(got[k], ref[k])
        compared += 1
        assert d < GRAD_RL2, f'{k}: rel-L2 {d:.2e}'
    head = [k for k in ref if k.startswith('roi_head.mask_head.')]
    assert all(ref[k].any() for k in head), [k for k in head
                                             if not ref[k].any()]
    assert sum(bool(JAX_SKIPPED.match(k)) for k in head) >= 10
    assert compared >= 80, compared


# -- the entry points on a seeded COCO set ---------------------------------------

@pytest.fixture(scope='module')
def coco_set(tmp_path_factory):
    from test_torch_port_eval_slice import make_set
    return make_set(tmp_path_factory.mktemp('coco_refine'))


def test_single_device_test_equal(coco_set):
    """The RefineMask toy through both test loops, image by image: dets,
    labels and validity, the masks pasted on the dataset's canvas outside
    the threshold band, and the metrics."""
    from test_torch_port_eval_slice import TEST_PIPELINE, data_cfg
    from dynamask_tpu.apis.test import single_device_test as jax_test
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.apis import dataset_mask_canvas, single_device_test
    from dynamask_torch.data import build_dataset
    from dynamask_torch.ops.paste import paste_masks
    det, variables, port, _ = refine_pair('refine')
    cfg = data_cfg(*coco_set, TEST_PIPELINE)
    jds = jax_build(cfg, dict(test_mode=True))
    pds = build_dataset(cfg, dict(test_mode=True))
    ref = jax_test(det, variables, jds, progress=False)
    got = single_device_test(port, pds, workers_per_gpu=0, progress=False)
    ch, cw = dataset_mask_canvas(pds)
    assert [r['img_id'] for r in got] == [r['img_id'] for r in ref]
    ids = [pds.sample_id(k) for k in range(len(pds))]
    for r, g in zip(ref, got):
        s = pds[ids.index(g['img_id'])]
        with torch.no_grad():
            out = port.simple_test({k: torch.from_numpy(s[k])[None] for k in
                                    ('image', 'img_shape', 'ori_shape',
                                     'scale_factor')})
        oh, ow = s['ori_shape'].astype(int)
        probs = paste_masks(out['mask_probs'][0], out['dets'][0, :, :4], ch,
                            cw)[:, :oh, :ow].numpy()
        assert r['valid'].sum() >= 4
        np.testing.assert_array_equal(g['valid'], r['valid'])
        np.testing.assert_array_equal(g['labels'], r['labels'])
        np.testing.assert_allclose(g['dets'], r['dets'], rtol=1e-5,
                                   atol=1e-4)
        for d in range(len(r['masks'])):
            clear = np.abs(probs[d] - 0.5) > 1e-3
            np.testing.assert_array_equal(g['masks'][d][clear],
                                          r['masks'][d][clear])
    metric = ['bbox', 'segm']
    want = jds.evaluate(ref, metric=metric)
    have = pds.evaluate(got, metric=metric)
    for k in want:
        assert have[k] == pytest.approx(want[k], abs=1e-6, rel=0), k


def _toy_run_cfg(coco_set, kind):
    from test_torch_port_eval_slice import (TEST_PIPELINE, TRAIN_PIPELINE,
                                            data_cfg)
    from dynamask_torch.utils import Config
    model, train_cfg, test_cfg = toy_cfg(kind)
    return Config(dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        optimizer=dict(type='SGD', lr=0.002, momentum=0.9,
                       weight_decay=1e-4),
        optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=5,
                       warmup_ratio=0.001, step=[8, 11]),
        total_epochs=1, log_config=dict(interval=1),
        evaluation=dict(interval=1, metric=['bbox', 'segm']),
        data=dict(samples_per_gpu=2, workers_per_gpu=0, max_gts=8,
                  mask_crop_size=32,
                  train=dict(data_cfg(*coco_set, TRAIN_PIPELINE),
                             with_semantic=True),
                  val=data_cfg(*coco_set, TEST_PIPELINE),
                  test=data_cfg(*coco_set, TEST_PIPELINE))))


@pytest.mark.parametrize('kind', KINDS)
def test_train_and_eval_entry_points(coco_set, kind, tmp_path):
    """``train_steps`` on a loader batch of the ``with_semantic`` train set,
    ``train_detector`` for one epoch with validation, then the saved
    checkpoint through ``init_detector`` (every key, strictly),
    ``inference_detector`` on an image file and ``run_eval``, on the
    CPU."""
    from dynamask_torch.apis import (inference_detector, init_detector,
                                     init_trainer, run_eval, train_detector,
                                     train_steps)
    from dynamask_torch.data import build_dataloader, build_dataset
    cfg = _toy_run_cfg(coco_set, kind)
    ds = build_dataset(cfg.data['train'],
                       default_args=dict(max_gts=8, mask_crop_size=32))
    batch = next(iter(build_dataloader(ds, 2, workers_per_gpu=0)))
    assert batch['gt_semantic'].dtype == torch.uint8
    assert batch['gt_semantic'].sum() > 0
    net, opt = init_trainer(cfg, steps_per_epoch=2, device='cpu')
    log, = train_steps(net, opt, [batch],
                       generator=torch.Generator().manual_seed(0))
    assert ('loss_semantic' in log) == (kind == 'refine')
    assert all(torch.isfinite(v).all() for v in log.values())

    work = str(tmp_path / 'work')
    train_detector(cfg, work_dir=work, max_steps_per_epoch=1, device='cpu')
    from test_torch_port_train_loop import rows
    train = [r for r in rows(work) if r['mode'] == 'train']
    val = [r for r in rows(work) if r['mode'] == 'val']
    assert len(train) == 1 and len(val) == 1
    assert ('loss_semantic' in train[0]) == (kind == 'refine')
    assert np.isfinite(val[0]['segm_mAP'])
    model = init_detector(cfg, checkpoint=work, device='cpu')
    saved = torch.load(os.path.join(work, 'epoch_1.pth'),
                       weights_only=True)['state_dict']
    assert saved.keys() == model.state_dict().keys()
    assert any(JAX_SKIPPED.match(k) for k in saved)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    img = os.path.join(coco_set[1], '0000.jpg')
    bbox, segm = inference_detector(model, img)
    assert len(bbox) == len(segm) == 8
    assert sum(len(b) for b in bbox) == sum(len(s) for s in segm) > 0
    metrics = run_eval(cfg, work, metrics=('bbox', 'segm'), device='cpu')
    assert np.isfinite(metrics['segm_mAP'])


# -- the six config files -------------------------------------------------------

@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_config_builds_and_keys_map(name):
    """The config file, unchanged, builds on the CPU at full width; every
    state-dict key maps through the port's key map; the JAX importer gives
    the same JAX path for every other key and skips exactly the RefineMask
    leaves it has no rule for."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.apis import init_detector
    from dynamask_torch.engine.convert import mmdet_key
    from dynamask_torch.models.refine_mask_head import (RefineMaskHead,
                                                        RefineRoIHead)
    model = init_detector(os.path.join(ROOT, CONFIGS[name]), device='cpu')
    head = model.roi_head
    assert type(head) is RefineRoIHead and head.with_semantic
    mh = head.mask_head
    assert type(mh) is RefineMaskHead
    keys = [k for k in model.state_dict()
            if not k.endswith('num_batches_tracked')]
    skipped = []
    for k in keys:
        path, leaf, _ = mmdet_key(k)
        ref = _mmdet_key(k)
        if ref is None:
            skipped.append(k)
            continue
        assert (ref[0], ref[1]) == (path, leaf), k
    assert skipped and all(JAX_SKIPPED.match(k) for k in skipped), skipped
    assert not [k for k in keys if JAX_SKIPPED.match(k)
                and k not in skipped]
    # 4 semantic convs, the logits, 3 stages x (transform_out, 3 dilated
    # convs, merge conv): each a weight and a bias
    assert len(skipped) == 2 * (4 + 1 + 3 * 5)
    depth = 101 if name.startswith('r101') else 50
    blocks = {50: 6, 101: 23}[depth]
    assert f'backbone.layer3.{blocks - 1}.conv3.weight' in keys
    assert f'backbone.layer3.{blocks}.conv3.weight' not in keys
    classes = {'lvis': 1203, 'cityscapes': 8}.get(name, 80)
    assert head.num_classes == len(model.CLASSES) == classes
    stage_classes = {'lvis': (1203, 1203, 1203, 1)}.get(
        name, (classes,) * 4)
    got_classes = tuple(s.instance_logits.num_classes for s in mh.stages) + \
        (mh.final_instance_logits.num_classes,)
    assert got_classes == stage_classes
    assert [s.mask_use_sigmoid for s in mh.stages] == [True] * 3
    assert [s.out_size for s in mh.stages] == [14, 28, 56]
    assert mh.stages[0].fuse_conv[1].with_avg is False
    assert head.stage_instance_loss_weight == (0.25, 0.5, 0.75, 1.0)
    assert (head.boundary_width, head.start_stage,
            head.semantic_loss_weight) == (2, 1, 1.0)
    assert head.max_per_img == (300 if name == 'lvis' else 100)


def test_jax_importer_leaves_refine_head_at_init():
    """The JAX importer, given a RefineMask state dict (here the port's, in
    the reference's names), reports the semantic tower and logits,
    ``semantic_transform_out`` and the MultiBranchFusion convs skipped and
    leaves those JAX leaves at their init, while the port's loader takes
    every key."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    from dynamask_torch.engine.convert import mmdet_key
    det, variables, port, _ = refine_pair('refine')
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    init = jax.tree_util.tree_map(np.zeros_like, variables['params'])
    params, _, report = convert_torch_weights(
        sd, init, jax.tree_util.tree_map(np.zeros_like,
                                         variables['batch_stats']),
        scope='mmdet')
    skipped = sorted(k for k in report['skipped']
                     if not k.endswith('num_batches_tracked'))
    assert skipped == sorted(k for k in sd if JAX_SKIPPED.match(k))
    assert {re.sub(r'(stages|semantic_convs)\.\d+\.', r'\1.i.', k)
            .rsplit('.', 1)[0] for k in skipped} == {
        'roi_head.mask_head.semantic_convs.i.conv',
        'roi_head.mask_head.semantic_logits',
        'roi_head.mask_head.stages.i.semantic_transform_out',
        'roi_head.mask_head.stages.i.fuse_conv.1.dilation_conv_1.conv',
        'roi_head.mask_head.stages.i.fuse_conv.1.dilation_conv_2.conv',
        'roi_head.mask_head.stages.i.fuse_conv.1.dilation_conv_3.conv',
        'roi_head.mask_head.stages.i.fuse_conv.1.merge_conv.conv'}
    for k in skipped:     # left at the init given (zeros here)
        path, leaf, _ = mmdet_key(k)
        node = params
        for p in path:
            node = node[p]
        assert not np.any(node['kernel' if leaf == 'weight' else 'bias']), k
        assert np.any(sd[k]), k
    assert not report['mismatched']


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_config_shapes(name):
    """``apis.config_shapes`` reads each config's test canvas, batch and
    train canvas (LVIS: the inner set of its ``ClassBalancedDataset``);
    ``init_detector`` takes the test set's canvases and class names."""
    from dynamask_torch.apis import config_shapes, init_detector
    from dynamask_torch.data import CITYSCAPES_CLASSES
    from dynamask_torch.utils.config import Config
    path = os.path.join(ROOT, CONFIGS[name])
    city = name == 'cityscapes'
    shapes = (((1024, 2048), 1, (1024, 2048)) if city else
              ((800, 1344), 4, (800, 1344)))
    assert config_shapes(path) == shapes
    cfg = Config.fromfile(path)
    train = cfg.data.train
    assert (train.dataset if name == 'lvis' else train)['with_semantic']
    model, train_cfg, test_cfg = toy_cfg('refine')
    det = init_detector(Config(dict(cfg.to_dict(), model=model,
                                    train_cfg=train_cfg,
                                    test_cfg=test_cfg)), device='cpu')
    assert det.canvases[0] == shapes[0]
    assert len(det.canvases) == (2 if city else 3)
    assert det.CLASSES == (CITYSCAPES_CLASSES if city else
                           tuple(f'class_{i}' for i in range(8)))


@pytest.mark.parametrize('kind', KINDS)
def test_init_draws_from_the_jax_initialisers(kind):
    """The port's seeded init draws every tensor of the RefineMask toy from
    the JAX package's initialiser (the rule of
    ``test_torch_port_train_loop.py``'s test of this name): constant
    tensors equal, random ones of 1000 entries or more with the JAX
    draw's spread (std within 10%) and mean (within 0.1 std). The
    MultiBranchFusion convs take flax's default (LeCun normal over fan-in,
    truncated), which their JAX module leaves in place; He over fan-out
    there would be 1.41 times as wide."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    model, train_cfg, test_cfg = toy_cfg(kind)
    det = jax_build(model, train_cfg, test_cfg)
    ref = build_detector(model, train_cfg, test_cfg, device='cpu', seed=1)
    load_jax_variables(ref, jax.device_get(fast_jit(det.init)(
        {'params': jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in _demo().items()})))
    want = ref.state_dict()
    got = build_detector(model, train_cfg, test_cfg, device='cpu',
                         seed=0).state_dict()
    checked = []
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        if (w == w.flatten()[0]).all():          # a constant tensor
            assert torch.equal(g, w), k
            continue
        if w.numel() < 1000:
            continue
        assert abs(g.std() / w.std() - 1) < 0.1, k
        assert abs(g.mean() - w.mean()) < 0.1 * w.std(), k
        checked.append(k)
    head = [k for k in checked if k.startswith('roi_head.mask_head.')]
    fusion = [k for k in head if 'dilation_conv_' in k or 'merge_conv' in k]
    # those of 1000 entries or more: stage 0's four (32 channels), stage
    # 1's dilated three (16)
    assert len(fusion) == 7 and len(head) >= 12, (fusion, head)


def test_train_and_eval_clis(coco_set, tmp_path, capsys):
    """``python -m dynamask_torch.tools.train`` (its ``main``) on the toy
    RefineMask over the ``with_semantic`` set for one step, then
    ``python -m dynamask_torch.tools.test`` on the work dir it wrote."""
    from test_torch_port_eval_slice import _write_cfg
    from test_torch_port_train_loop import rows
    from dynamask_torch.tools.test import main as test_main
    from dynamask_torch.tools.train import main as train_main
    cfg = _write_cfg(tmp_path / 'cfg.py',
                     _toy_run_cfg(coco_set, 'refine').to_dict())
    work = str(tmp_path / 'work')
    assert train_main([cfg, '--work-dir', work, '--device', 'cpu',
                       '--max-steps-per-epoch', '1', '--no-validate']) == 0
    train = [r for r in rows(work) if r['mode'] == 'train']
    assert len(train) == 1 and np.isfinite(train[0]['loss_semantic'])
    assert test_main([cfg, work, '--device', 'cpu', '--eval', 'bbox',
                      'segm']) == 0
    printed = capsys.readouterr().out
    assert 'bbox_mAP:' in printed and 'segm_mAP:' in printed
