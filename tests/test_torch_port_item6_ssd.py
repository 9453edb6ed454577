"""SSD on the CPU: the PyTorch port (``dynamask_torch/models/ssd.py``,
``core/anchors.py``) against the JAX package on the same seeded inputs,
the JAX weights carried across by ``dynamask_torch.engine.convert``.

- The SSD anchors of both generators, both ratio ranges: exact.
- ``L2Norm`` (fp32, 1e-6 relative) and the full-width ``SSDVGG`` at 300x300
  (one JAX compile for the module, forward only): every level within 1e-4
  relative L2 (``VGG_RL2``).
- Toy SSDs from their unchanged config files (``configs/ssd/ssd300_coco.py``,
  the legacy v1 file, PISA-SSD's), 8 classes, at SSD's 300x300 canvas (its
  extra layers need 257 pixels or more) over a narrow VGG: every stage 8 or 16
  channels, patched into both packages' width tables while a toy is built
  and traced (``narrow_vgg``; fc6 / fc7 keep their 1024). ``simple_test``
  of two images (one at a scale factor of 0.8 and an extent short of the
  canvas): labels and validity exact, dets within 1e-4 of the largest
  coordinate. One ``forward_train`` in fp32 on both sides: each loss
  within 1e-5 relative, each gradient within 1e-4 relative L2. The step
  is fp32 because JAX computes SSD's losses in fp32 whatever its inputs
  (``ssd.py:266-267`` casts the head's outputs), so a float64 run rounds
  there too.
- Hard-negative mining with ties: the toy's class convs zeroed, so every
  negative of a level and anchor slot has the same cross entropy; the
  kept set (the lower anchor index first among equals) shows in the
  class convs' gradient, held to the same 1e-4 of JAX's.
- The JAX faults of ROADMAP.md queue 3: SSD512 (3bi) refused by name; the
  assigner's ``gt_max_assign_all=False`` computed as JAX drops it (3bm);
  the JAX importer's gaps on SSD (3bl).
"""

import contextlib
import copy
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402
from test_torch_port_modules import fast_jit  # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'ssd': 'configs/ssd/ssd300_coco.py',
    'legacy': 'configs/legacy_1.x/ssd300_coco_v1.py',
    'pisa_ssd': 'configs/pisa/pisa_ssd300_coco.py',
}
# a VGG of 8 and 16 channels a stage and its extra layers (fc6 / fc7 keep
# 1024): the levels' widths
TOY_VGG = ((8, 2), (8, 2), (16, 3), (16, 3), (16, 3))
TOY_EXTRA = (16, 'S', 16, 8, 'S', 16, 8, 16, 8, 16)
TOY_WIDTHS = (16, 1024, 16, 16, 16, 16)
SIDE = 300
DET_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
VGG_RL2 = 1e-4
SIZES300 = ((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1))
RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
STRIDES = (8, 16, 32, 64, 100, 300)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@contextlib.contextmanager
def narrow_vgg():
    """While active, both packages build SSD's VGG at ``TOY_VGG`` /
    ``TOY_EXTRA``'s widths."""
    import dynamask_tpu.models.ssd as jssd
    import dynamask_torch.models.ssd as pssd
    saved = (jssd._VGG16, jssd.SSDVGG.extra_setting, pssd.VGG16,
             pssd.EXTRA_SETTING)
    jssd._VGG16, pssd.VGG16 = TOY_VGG, TOY_VGG
    jssd.SSDVGG.extra_setting = pssd.EXTRA_SETTING = {SIDE: TOY_EXTRA}
    try:
        yield
    finally:
        (jssd._VGG16, jssd.SSDVGG.extra_setting, pssd.VGG16,
         pssd.EXTRA_SETTING) = saved


def toy_cfg(kind, num_classes=8):
    """(model, train_cfg, test_cfg) of ``kind``'s config file over the
    narrow VGG; ``nms_pre`` 50 (the top-k cut on the first two levels) and
    20 dets an image."""
    from dynamask_torch.utils.config import Config
    cfg = copy.deepcopy(Config.fromfile(os.path.join(
        ROOT, CONFIGS[kind])).to_dict())
    m = cfg['model']
    m.pop('pretrained', None)
    m['bbox_head'].update(num_classes=num_classes, in_channels=TOY_WIDTHS)
    cfg['test_cfg'].update(nms_pre=50, max_per_img=20)
    return m, cfg['train_cfg'], cfg['test_cfg']


def demo(b=1):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(
        0, b=b, h=SIDE, w=SIDE, g=3, s=16).items()}


def draw_variables(det, batch, seed=0):
    """The JAX detector's variables drawn from ``seed`` on the tree of
    ``jax.eval_shape(det.init)`` (no compiled init): kernels N(0, 1 /
    fan-in), biases and BN means N(0, 0.1), norm scales and variances
    U(0.5, 1.5), the L2Norm scales U(10, 30) (its init is 20)."""
    shapes = jax.eval_shape(det.init, {'params': jax.random.PRNGKey(0)},
                            {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(seed)

    def fill(path, x):
        if len(x.shape) >= 2:
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, x.shape).astype(np.float32)
        name = path[-1].key
        if name == 'weight':
            return rng.uniform(10, 30, x.shape).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0, 0.1, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def twin(kind, zero_cls=False):
    """(JAX toy detector, its drawn variables, the port loaded from them);
    ``zero_cls``: the class convs' kernels zeroed on both sides."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    with narrow_vgg():
        det = jax_build(*copy.deepcopy(cfg))
        variables = draw_variables(det, demo())
        if zero_cls:
            head = variables['params']['bbox_head']
            for name in head:
                if name.startswith('cls_conv'):
                    head[name]['kernel'] = np.zeros_like(
                        head[name]['kernel'])
        port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor')


def infer_batch():
    batch = {k: demo(2)[k] for k in TEST_KEYS}
    batch['scale_factor'][1:] = 0.8
    batch['img_shape'][1] = [280, 260]
    return batch


def check_simple_test(kind):
    """Dets, labels and validity slot for slot, two images."""
    det, variables, port = twin(kind)
    batch = infer_batch()
    with narrow_vgg():
        ref = jax.device_get(jax.jit(lambda v, b: det.apply(
            v, b, method='simple_test'))(
                variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = port.simple_test({k: torch.from_numpy(v)
                            for k, v in batch.items()})
    assert (ref['det_valid'].sum(1) >= 4).all()
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    scale = np.abs(ref['dets'][..., :4]).max()
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=0,
                               atol=DET_RTOL * scale)


@functools.lru_cache(maxsize=None)
def train_step(kind, zero_cls=False):
    """One ``forward_train`` on both sides from the same variables: (port
    losses, JAX losses, port gradients, JAX gradients in the port's
    layout)."""
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    det, variables, port = twin(kind, zero_cls)
    port = copy.deepcopy(port).train()
    batch = demo(2)
    batch['img_shape'][1] = [280, 260]

    def loss_fn(params, b):
        losses = det.apply({'params': params}, b, method='forward_train')
        return sum(losses.values()), losses

    with narrow_vgg():
        (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables['params'], {k: jnp.asarray(v) for k, v in batch.items()})
    losses = port.forward_train({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    sum(losses.values()).backward()
    hints = key_hints(port)
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    grads = jax.device_get(grads)
    ref_g = {k: _torch_layout(grads, {}, *mmdet_key(k, **hints))
             for k in got}
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: float(v) for k, v in jax.device_get(ref).items()}, got, ref_g)


def check_train_step(kind, zero_cls=False):
    got, ref, grads, ref_grads = train_step(kind, zero_cls)
    assert set(got) == set(ref) and {'loss_cls', 'loss_bbox'} <= set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), (k, got[k],
                                                                 ref[k])
        assert ref[k] > 0, k
    worst = max((rel_l2(grads[k], r), k) for k, r in ref_grads.items()
                if np.linalg.norm(r) > 0)
    assert worst[0] < GRAD_RL2, worst
    zero = [k for k, r in ref_grads.items() if np.linalg.norm(r) == 0]
    assert all(np.abs(grads[k]).max() == 0 for k in zero), zero


# -- anchors -----------------------------------------------------------------

@pytest.mark.parametrize('legacy', [False, True], ids=['ssd', 'legacy'])
@pytest.mark.parametrize('ratio_range', [(0.15, 0.9), (0.2, 0.9)],
                         ids=['coco', 'voc'])
def test_ssd_anchors_exact(legacy, ratio_range):
    """Each level's anchors bit for bit, in JAX's order ((scale 1, ratio
    1), (sqrt scale, ratio 1), the other ratios), and the per-level anchor
    counts 2 + 2 * len(ratios); the grid is kept on its device."""
    import dynamask_tpu.core.anchors as ja
    import dynamask_torch.core.anchors as pa
    name = 'LegacySSDAnchorGenerator' if legacy else 'SSDAnchorGenerator'
    ref = getattr(ja, name)(STRIDES, RATIOS, ratio_range, 300)
    gen = getattr(pa, name)(STRIDES, RATIOS, ratio_range, 300)
    got = gen.grid_anchors(SIZES300, 'cpu')
    for r, g in zip(ref.grid_anchors(SIZES300), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert gen.num_base_anchors == [4, 6, 6, 6, 4, 4]
    assert gen.grid_anchors(SIZES300, 'cpu') is got


def test_ssd_valid_flags():
    """Anchor validity from each image's un-padded extent, per level's
    anchor count, against JAX's."""
    from dynamask_tpu.core.anchors import SSDAnchorGenerator as J
    from dynamask_torch.core.anchors import SSDAnchorGenerator as P
    shapes = np.array([[300, 300], [180, 250]], np.float32)
    ref = J(STRIDES, RATIOS)
    got = P(STRIDES, RATIOS).valid_flags(SIZES300, torch.from_numpy(shapes))
    for i, sh in enumerate(shapes):
        for g, r in zip(got, ref.valid_flags(SIZES300, jnp.asarray(sh))):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))


# -- modules ------------------------------------------------------------------

def test_l2norm():
    from dynamask_tpu.models.ssd import L2Norm as JL2
    from dynamask_torch.models.ssd import L2Norm
    rng = np.random.RandomState(0)
    x = rng.normal(0, 3, (2, 5, 7, 16)).astype(np.float32)
    w = rng.uniform(10, 30, 16).astype(np.float32)
    ref = JL2().apply({'params': {'weight': w}}, jnp.asarray(x))
    m = L2Norm(16)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_ssdvgg_full_width_300():
    """The full-width VGG at 300x300, batch 1: the six levels (38, 19, 10,
    5, 3, 1) within 1e-4 relative L2 of JAX's, the weights through the
    port's key map."""
    from dynamask_tpu.models.ssd import SSDVGG as JVGG
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    from dynamask_torch.models.ssd import SSDVGG
    x = np.random.RandomState(1).normal(0, 1, (1, SIDE, SIDE, 3)).astype(
        np.float32)
    jvgg = JVGG()
    shapes = jax.eval_shape(jvgg.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(2)

    def fill(path, s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, (2 / fan_in) ** 0.5, s.shape).astype(
                np.float32)
        if path[-1].key == 'weight':
            return rng.uniform(10, 30, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    ref = jax.device_get(fast_jit(jvgg.apply)(variables, jnp.asarray(x)))
    port = SSDVGG(SIDE)
    with torch.no_grad():
        for k, t in port.state_dict().items():
            path, leaf, hints = mmdet_key('backbone.' + k, backbone='SSDVGG')
            t.copy_(torch.from_numpy(_torch_layout(
                {'backbone': variables['params']}, {}, path, leaf, hints)))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [o.shape[-2:] for o in got] == [torch.Size(s) for s in SIZES300]
    assert port.out_channels == (512, 1024, 512, 256, 256, 256)
    for g, r in zip(got, ref):
        assert rel_l2(g.permute(0, 2, 3, 1).numpy(), r) < VGG_RL2
        assert np.abs(r).max() > 0


# -- toy detectors ------------------------------------------------------------

@pytest.mark.parametrize('kind', ['ssd', 'legacy'])
def test_simple_test(kind):
    check_simple_test(kind)


@pytest.mark.parametrize('kind', ['ssd', 'legacy'])
def test_train_step(kind):
    check_train_step(kind)


def test_hard_negative_mining_ties():
    """With the class convs zeroed every negative of a level's anchor slot
    has one cross entropy: the mined set is decided by the tie order (the
    lower anchor index first, ``argsort(stable=True)`` as ``jnp.argsort``)
    and shows in the class convs' gradient."""
    check_train_step('ssd', zero_cls=True)
    _, _, port = twin('ssd', zero_cls=True)
    batch = {k: torch.from_numpy(v) for k, v in demo(1).items()}
    with torch.no_grad():
        flat_cls, _, _, (labels, pos, keep, _, _, ce) = port.targets(batch)
    neg = (labels == 8) & ~pos
    kept = keep[0].nonzero()[:, 0]
    # ties: many negatives share the kept ones' cross entropy, and the kept
    # ones are the lowest indices among each tied value's negatives
    assert 0 < len(kept) < int(neg.sum())
    split = 0
    for v in ce[0][kept].unique():
        tied = (neg[0] & (ce[0] == v)).nonzero()[:, 0]
        chosen = kept[ce[0][kept] == v]
        assert torch.equal(chosen, tied[:len(chosen)])
        split += len(tied) > len(chosen)
    assert split == 1     # the rank cut falls inside one tied value


def test_pisa_ssd():
    """PISA-SSD (``configs/pisa/pisa_ssd300_coco.py``): its
    ``simple_test`` is SSD's; one step with ISR-P on the positives (the
    negatives mined on the unweighted cross entropy) and CARL at beta 1,
    within the SSD toys' tolerances."""
    check_simple_test('pisa_ssd')
    check_train_step('pisa_ssd')
    assert set(train_step('pisa_ssd')[1]) == {'loss_cls', 'loss_bbox',
                                              'loss_carl'}


# -- config files and faults -------------------------------------------------

SSD_FILES = ('ssd/ssd300_coco.py', 'legacy_1.x/ssd300_coco_v1.py',
             'pascal_voc/ssd300_voc0712.py', 'wider_face/ssd300_wider_face.py',
             'pisa/pisa_ssd300_coco.py')
SSD512_FILES = ('ssd/ssd512_coco.py', 'pascal_voc/ssd512_voc0712.py',
                'pisa/pisa_ssd512_coco.py')


def _build(rel, device='meta'):
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', rel))
    return build_detector(cfg.model, cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device=device)


@pytest.mark.parametrize('rel', SSD_FILES)
def test_ssd300_files_build(rel):
    """Every SSD300 file builds at full width (no neck), with the VGG's
    widths, 2 + 2 * len(ratios) anchors a level and its config's classes;
    VOC's 0.2 ratio range and the legacy file's generator."""
    model = _build(rel)
    head = model.bbox_head
    classes = {'pascal_voc': 20, 'wider_face': 1}.get(rel.split('/')[0], 80)
    assert model.num_classes == classes
    assert [c.out_channels for c in head.cls_convs] == [
        a * (classes + 1) for a in (4, 6, 6, 6, 4, 4)]
    gen = model.anchor_generator
    assert type(gen).__name__ == ('LegacySSDAnchorGenerator' if 'legacy'
                                  in rel else 'SSDAnchorGenerator')
    first = gen.base_anchors[0][0]
    side = (30 if 'voc' in rel else 21) - ('legacy' in rel)   # the -1 rule
    assert first[2] - first[0] == pytest.approx(side)
    assert type(model).__name__ == ('PISASSD' if 'pisa' in rel else 'SSD')


@pytest.mark.parametrize('rel', SSD512_FILES)
def test_ssd512_refused_3bi(rel):
    """3bi: JAX's SSDVGG builds 6 levels on a 512 canvas and drops its last
    extra conv, while the file names 7 anchor levels; JAX raises at the
    anchors. The port refuses the three files by name."""
    with pytest.raises(NotImplementedError, match='3bi'):
        _build(rel)


def test_ssd512_jax_raises_3bi():
    """The JAX fault itself: ``simple_test`` of ``configs/ssd/ssd512_coco.py``
    asserts at the anchor generator (6 feature maps, 7 strides)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_tpu.models.ssd import SSDVGG as JVGG
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', SSD512_FILES[0]))
    det = jax_build(cfg.model, cfg.train_cfg, cfg.test_cfg)
    gen = det._anchor_generator()
    assert len(gen.strides) == 7
    x = jnp.zeros((1, 512, 512, 3))
    outs = jax.eval_shape(lambda v, a: JVGG(input_size=512).apply(v, a),
                          jax.eval_shape(JVGG(input_size=512).init,
                                         jax.random.PRNGKey(0), x), x)
    assert len(outs) == 6
    with pytest.raises(AssertionError):
        gen.grid_anchors([tuple(o.shape[1:3]) for o in outs])


def test_gt_max_assign_all_false_as_jax_3bm():
    """3bm: the SSD files' assigner says ``gt_max_assign_all=False``, which
    JAX's ``build_ssd`` drops: every anchor tying a GT's best IoU is
    claimed. On a GT centred between two equal anchors both are positive
    in the port, as in JAX's default form, where the False form claims
    one."""
    from dynamask_tpu.core.assigners import MaxIoUAssigner as JA
    model = _build('ssd/ssd300_coco.py', 'cpu')
    anchors = torch.tensor([[0., 0., 10., 10.], [20., 0., 30., 10.],
                            [40., 40., 60., 60.]])
    gt = torch.tensor([[5., 0., 25., 10.]])
    args = (anchors, torch.ones(3, dtype=torch.bool), gt,
            torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.long))
    got = model.assigner(*args).gt_inds.numpy()
    jargs = [jnp.asarray(a.numpy()) for a in args]
    ref = JA(0.5, 0.5, 0.0).__call__(*jargs).gt_inds
    one = JA(0.5, 0.5, 0.0, gt_max_assign_all=False)(*jargs).gt_inds
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert list(got[:2]) == [1, 1] and list(np.asarray(one)[:2]) == [1, 0]


def test_jax_importer_skips_ssd_3bl():
    """3bl: the JAX importer (``pretrained.py:convert_torch_weights``) reads
    a full SSD state dict as an mmdet detector's and skips every key of
    it: the VGG's ``backbone.features.{i}`` go through its ResNet rules;
    its bare-VGG scope maps conv1_1-conv5_3 (``features.0-28``) but not
    fc6 / fc7 (``features.31`` / ``.33``). The port's key map carries
    every one of them both ways."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    det, variables, port = twin('ssd')
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _, _, report = convert_torch_weights(sd, variables['params'], {})
    assert not report['loaded'] and sorted(report['skipped']) == sorted(sd)
    vgg = {k[len('backbone.'):]: v for k, v in sd.items()
           if k.startswith('backbone.features.')}
    _, _, report = convert_torch_weights(
        vgg, variables['params'], {}, scope='vgg')
    assert sorted(report['skipped']) == [
        'features.31.bias', 'features.31.weight', 'features.33.bias',
        'features.33.weight']
    hints = key_hints(port)
    assert all(mmdet_key(k, **hints) is not None for k in sd)


def test_wider_face_dataset():
    """``WIDERFaceDataset``: the XML set of one class, ``face``, as JAX's;
    the WIDER FACE SSD file's test set builds over it."""
    from dynamask_tpu.data.voc import WIDERFaceDataset as J
    from dynamask_torch.core.class_names import get_classes
    from dynamask_torch.data import WIDERFaceDataset
    assert WIDERFaceDataset.CLASSES == J.CLASSES == ('face',)
    assert tuple(get_classes('WIDERFaceDataset')) == ('face',)
