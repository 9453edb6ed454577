"""The configurations of ``BASELINE.json`` beside the flagship, on the CPU:
the PyTorch port's modules for them against the JAX package's.

- ResNet-34/101/152: every stage output at a 64x64 input with the JAX
  weights carried across, and the same ``zero_init_residual`` BNs.
- ``FCNMaskHead`` with random, not spatially symmetric deconv weights
  carried across by the key map (the deconv kernel is transposed AND
  flipped; a transpose alone disagrees), and the key map round trip
  through the JAX importer; ``fcn_mask_loss`` and its gradient.
- The toy Mask R-CNN (``tests/test_models.py:mini_mask_rcnn_cfg``:
  ResNet-18, 32-channel FPN, FCN mask head, 8 classes, 64x64):
  ``simple_test`` + paste slot for slot, and one training step's losses
  and per-leaf gradients, the random draws injected into both sides.
- The four config files build on the CPU, and every key of each
  ``state_dict`` maps through the JAX importer's key map to the JAX tree
  path the port's own map gives; ``apis.config_shapes`` and the canvases
  and class names ``init_detector`` takes from each config's test set.
- ``core.get_classes`` equal to the JAX package's for every alias.

Tolerances are those of ``tests/test_torch_port_slice.py`` and
``test_torch_port_train_slice.py``: dets ``rtol=1e-5, atol=1e-4``, mask
probabilities ``atol=2e-4``, pixels within 1e-3 of the threshold left out
of the binary compare; losses 1e-4 relative, gradients 1e-3 relative L2.
"""

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import fast_jit  # noqa: E402
from test_torch_port_modules import nchw, randomize_variables  # noqa: E402
from test_torch_port_train_slice import (leaves, rel_l2,  # noqa: E402
                                         jax_draws)
from dynamask_torch.core.class_names import dataset_aliases  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'mask_rcnn': 'configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py',
    'r101': 'configs/dynamask/coco/r101_dynamask_3x.py',
    'lvis': 'configs/dynamask/lvis/r50_dynamask_lvis_1x.py',
    'cityscapes': 'configs/dynamask/cityscapes/r50_dynamask_cityscapes_1x.py',
}
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3


def _wrap(**modules):
    """An ``nn.Module`` holding ``modules`` under their dotted names, so
    their state-dict keys read as in the detector."""
    root = torch.nn.Module()
    for path, m in modules.items():
        node = root
        *parents, leaf = path.split('.')
        for p in parents:
            if not hasattr(node, p):
                setattr(node, p, torch.nn.Module())
            node = getattr(node, p)
        setattr(node, leaf, m)
    return root


# -- ResNet depths ------------------------------------------------------------

def _zero_bn_paths(tree, path=()):
    """JAX paths of the BatchNorms whose scale starts at zero."""
    if isinstance(tree, dict) or hasattr(tree, 'items'):
        if 'scale' in tree and not np.any(np.asarray(tree['scale'])):
            yield path
        for k, v in tree.items():
            if k != 'scale' and hasattr(v, 'items'):
                yield from _zero_bn_paths(v, path + (k,))


@pytest.mark.parametrize('depth', [34, 101, 152])
def test_resnet_depths(depth):
    """Stage outputs (strides 4-32) with the JAX weights carried across,
    and the init's zero-scale BNs (each residual block's last) on the same
    modules on both sides."""
    from dynamask_tpu.models import ResNet as JResNet
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.engine.convert import mmdet_key
    from dynamask_torch.models import ResNet
    from dynamask_torch.models.layers import init_weights

    x = np.random.RandomState(depth).randn(1, 64, 64, 3).astype(np.float32)
    jb = JResNet(depth=depth, frozen_stages=1)
    init = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = _wrap(backbone=ResNet(depth=depth, frozen_stages=1))
    init_weights(port, torch.Generator().manual_seed(0))
    zero_port = {tuple(mmdet_key(f'{n}.weight')[0])
                 for n, m in port.named_modules()
                 if isinstance(m, torch.nn.BatchNorm2d)
                 and not m.weight.any()}
    zero_jax = {('backbone',) + p
                for p in _zero_bn_paths(init['params'])}
    blocks = {34: 16, 101: 33, 152: 50}[depth]
    assert len(zero_port) == blocks and zero_port == zero_jax

    v = randomize_variables(init, seed=depth)
    ref = jb.apply(v, jnp.asarray(x))
    port.eval().to(memory_format=torch.channels_last)
    load_jax_variables(port, {'params': {'backbone': v['params']},
                              'batch_stats': {'backbone': v['batch_stats']}})
    with torch.no_grad():
        got = port.backbone(nchw(x))
    assert len(got) == len(ref) == 4
    for i, (a, b) in enumerate(zip(ref, got)):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.permute(0, 2, 3, 1).numpy(), a, rtol=1e-4,
            atol=1e-5 * float(np.abs(a).max()) + 1e-4, err_msg=f'C{i + 2}')


# -- the FCN mask head --------------------------------------------------------

def _fcn_pair(class_agnostic=False, num_classes=5, c=16):
    from dynamask_tpu.models.fcn_mask_head import FCNMaskHead as JHead
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models.fcn_mask_head import FCNMaskHead
    x = np.random.RandomState(3).randn(6, 14, 14, c).astype(np.float32)
    jh = JHead(num_convs=4, in_channels=c, conv_out_channels=c,
               num_classes=num_classes, class_agnostic=class_agnostic)
    v = randomize_variables(jh.init(jax.random.PRNGKey(1), jnp.asarray(x)),
                            seed=4)
    port = _wrap(**{'roi_head.mask_head': FCNMaskHead(
        num_convs=4, in_channels=c, conv_out_channels=c,
        num_classes=num_classes, class_agnostic=class_agnostic)})
    load_jax_variables(port, {'params': {'roi_head': {'mask_head':
                                                      v['params']}}})
    return jh, v, port, x


@pytest.mark.parametrize('class_agnostic', [False, True])
def test_fcn_mask_head_forward(class_agnostic):
    jh, v, port, x = _fcn_pair(class_agnostic)
    kernel = np.asarray(v['params']['upsample']['kernel'])
    assert np.abs(kernel - kernel[::-1, ::-1]).max() > 0.1   # not symmetric
    ref = np.asarray(jh.apply(v, jnp.asarray(x)))
    head = port.roi_head.mask_head
    with torch.no_grad():
        got = head(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (6, 28, 28, 1 if class_agnostic else 5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # the trap: a map that transposes the deconv kernel without the flip
    with torch.no_grad():
        head.upsample.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        wrong = head(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert np.abs(wrong - ref).max() > 1e-2


def test_fcn_key_map_round_trip():
    """The port's FCN head state dict through the JAX importer gives back
    the JAX parameters exactly (the deconv flipped back)."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    _, v, port, _ = _fcn_pair()
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    assert 'roi_head.mask_head.upsample.weight' in sd
    zeros = jax.tree_util.tree_map(np.zeros_like, v['params'])
    params, _, report = convert_torch_weights(
        sd, {'roi_head': {'mask_head': zeros}}, {}, scope='mmdet')
    assert not report['skipped'] and not report['mismatched']
    assert len(report['loaded']) == len(sd) == 12
    got = leaves(params['roi_head']['mask_head'])
    ref = leaves(v['params'])
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize('channels', [5, 1])
def test_fcn_mask_loss_and_grad(channels):
    """The loss and its gradient in the logits, invalid RoIs and
    out-of-range labels included (the class channel clamps)."""
    from dynamask_tpu.models.fcn_mask_head import fcn_mask_loss as jloss
    from dynamask_torch.models.fcn_mask_head import fcn_mask_loss
    rng = np.random.RandomState(channels)
    logits = rng.randn(9, 28, 28, channels).astype(np.float32) * 3
    targets = (rng.uniform(size=(9, 28, 28)) > 0.5).astype(np.float32)
    labels = rng.randint(-1, 6, 9).astype(np.int64)
    valid = rng.uniform(size=9) > 0.3
    ref, ref_g = jax.value_and_grad(
        lambda lg: jloss(lg, jnp.asarray(targets), jnp.asarray(labels),
                         jnp.asarray(valid), 1.5))(jnp.asarray(logits))
    t = torch.from_numpy(logits).permute(0, 3, 1, 2).requires_grad_()
    got = fcn_mask_loss(t, torch.from_numpy(targets),
                        torch.from_numpy(labels), torch.from_numpy(valid),
                        1.5)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_g), rtol=1e-5, atol=1e-9)


# -- the toy Mask R-CNN -------------------------------------------------------

def mask_rcnn_pair():
    """(JAX toy Mask R-CNN, its randomised variables, the port loaded from
    them, the model config)."""
    from test_models import demo_batch, mini_mask_rcnn_cfg
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    model, train_cfg, test_cfg = mini_mask_rcnn_cfg()
    det = jax_build(model, train_cfg, test_cfg)
    batch = demo_batch(0, b=1, h=64, w=64, g=3, s=16)
    variables = randomize_variables(
        fast_jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    port = build_detector(model, train_cfg, test_cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port, (model, train_cfg, test_cfg)


@pytest.fixture(scope='module')
def mrcnn():
    return mask_rcnn_pair()


@pytest.mark.parametrize('b', [1, 2])
def test_mask_rcnn_simple_test_and_paste(mrcnn, b):
    """Dets, labels, validity, 28x28 mask probabilities and the pasted
    masks, slot for slot; two images with a non-unit scale factor."""
    from test_models import demo_batch
    from dynamask_tpu.apis.test import _paste_epilogue
    from dynamask_tpu.ops.paste import paste_masks as jpaste
    from dynamask_torch.apis import inference_detector
    from dynamask_torch.models.roi_head import StandardRoIHead
    from dynamask_torch.ops.paste import paste_masks

    det, variables, port, _ = mrcnn
    assert type(port.roi_head) is StandardRoIHead
    demo = demo_batch(0, b=b, h=64, w=64, g=3, s=16)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch_np = {k: np.array(demo[k]) for k in keys}
    batch_np['scale_factor'][1:] = 0.8

    def flat(out):
        return (out['mask_probs'].reshape(-1, 28, 28),
                out['dets'][..., :4].reshape(-1, 4))

    @jax.jit
    def jax_fn(v, batch):
        out = det.apply(v, batch, method='simple_test')
        return out, jpaste(*flat(out), 64, 64), _paste_epilogue(out, 64, 64,
                                                                 0.5)

    ref, ref_pasted, ref_epi = jax.tree_util.tree_map(
        np.asarray, jax_fn(variables,
                           {k: jnp.asarray(v) for k, v in batch_np.items()}))
    batch_t = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    got = inference_detector(port, batch_t)
    with torch.no_grad():
        out = port.simple_test(batch_t)
        pasted = paste_masks(*flat(out), 64, 64).numpy()

    for i in range(b):
        valid = ref['det_valid'][i].astype(bool)
        assert valid.sum() >= 4
        scores = np.sort(ref['dets'][i, valid, 4])
        assert np.min(np.diff(scores)) > 1e-4, 'score margins too small'
    np.testing.assert_array_equal(got['valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    assert out['mask_probs'].shape == (b, 8, 28, 28)
    np.testing.assert_allclose(out['mask_probs'].numpy(), ref['mask_probs'],
                               atol=2e-4)
    np.testing.assert_allclose(pasted, ref_pasted, atol=2e-4)
    clear = np.abs(ref_pasted - 0.5) > 1e-3
    masks = got['masks'].numpy()
    assert masks.shape == (b, 8, 64, 64)
    np.testing.assert_array_equal(masks.reshape(pasted.shape)[clear],
                                  ref_epi['masks'].reshape(pasted.shape)[clear])


def test_mask_rcnn_single_device_test(mrcnn, tmp_path):
    """The toy Mask R-CNN through both test loops on the seeded COCO set
    of ``test_torch_port_eval_slice.py``: 28x28 masks pasted on the
    dataset's canvas in original-image coordinates, image by image, and
    the metrics."""
    from test_torch_port_eval_slice import TEST_PIPELINE, data_cfg, make_set
    from dynamask_tpu.apis.test import single_device_test as jax_test
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.apis import dataset_mask_canvas, single_device_test
    from dynamask_torch.data import build_dataset
    from dynamask_torch.ops.paste import paste_masks
    det, variables, port, _ = mrcnn
    cfg = data_cfg(*make_set(tmp_path), TEST_PIPELINE)
    jds = jax_build(cfg, dict(test_mode=True))
    pds = build_dataset(cfg, dict(test_mode=True))
    ref = jax_test(det, variables, jds, progress=False)
    got = single_device_test(port, pds, workers_per_gpu=0, progress=False)
    ch, cw = dataset_mask_canvas(pds)
    assert [r['img_id'] for r in got] == [r['img_id'] for r in ref]
    for i, (r, g) in enumerate(zip(ref, got)):
        s = pds[[pds.sample_id(k) for k in range(len(pds))].index(
            g['img_id'])]
        with torch.no_grad():
            out = port.simple_test({k: torch.from_numpy(s[k])[None] for k in
                                    ('image', 'img_shape', 'ori_shape',
                                     'scale_factor')})
        oh, ow = s['ori_shape'].astype(int)
        probs = paste_masks(out['mask_probs'][0], out['dets'][0, :, :4], ch,
                            cw)[:, :oh, :ow].numpy()
        valid = r['valid'].astype(bool)
        assert valid.sum() >= 4
        np.testing.assert_array_equal(g['valid'], r['valid'])
        np.testing.assert_array_equal(g['labels'], r['labels'])
        np.testing.assert_allclose(g['dets'], r['dets'], rtol=1e-5,
                                   atol=1e-4)
        for d in range(len(r['masks'])):
            clear = np.abs(probs[d] - 0.5) > 1e-3
            assert g['masks'][d].shape == r['masks'][d].shape == (oh, ow)
            np.testing.assert_array_equal(g['masks'][d][clear],
                                          r['masks'][d][clear])
    metric = ['bbox', 'segm']
    want = jds.evaluate(ref, metric=metric)
    assert pds.evaluate(ref, metric=metric) == want
    have = pds.evaluate(got, metric=metric)
    for k in want:
        assert have[k] == pytest.approx(want[k], abs=1e-6, rel=0), k


@pytest.fixture(scope='module')
def mrcnn_step(mrcnn):
    """One training step's logs and gradients on both sides, from the same
    variables and draws (as ``test_torch_port_train_slice.py``)."""
    from test_models import demo_batch
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.models.detectors import parse_losses

    det, variables, port, _ = mrcnn
    port = copy.deepcopy(port).train()   # its own copy: this one trains
    demo = demo_batch(0, b=1, h=64, w=64, g=3, s=16)
    batch = {k: np.array(v) for k, v in demo.items()}
    rng = np.random.RandomState(12)
    n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = {'rpn': rng.uniform(size=(1, n_anchors)).astype(np.float32),
             'rcnn': rng.uniform(size=(1, 3 + 32)).astype(np.float32),
             'gumbel': np.zeros((8, 4), np.float32)}   # no MSM: unread

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        total, log = jparse(losses)
        return total, log

    with jax_draws(noise):
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables['batch_stats'],
            {k: jnp.asarray(x) for k, x in batch.items()})
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()},
        {k: torch.from_numpy(x) for k, x in noise.items()}))
    total.backward()
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          .detach().numpy().copy() for k, p in port.named_parameters()}
    zeros = jax.tree_util.tree_map(np.zeros_like, variables['params'])
    port_grads, _, report = convert_torch_weights(
        sd, zeros, variables['batch_stats'], scope='mmdet')
    assert not report['mismatched'] and not report['skipped']
    return ({k: v.detach().numpy() for k, v in log.items()},
            jax.device_get(jax_log), port_grads, jax.device_get(jax_grads))


def test_mask_rcnn_train_losses(mrcnn_step):
    port_log, jax_log, _, _ = mrcnn_step
    keys = {k for k in jax_log if 'loss' in k or k == 'acc'}
    assert keys == {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                    'loss_bbox', 'acc', 'loss_mask', 'loss'}
    assert keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert jax_log['loss_mask'] > 0 and jax_log['loss_bbox'] > 0


def test_mask_rcnn_per_leaf_gradients(mrcnn_step):
    """Every leaf; the frozen stem and stage 1 get none on either side,
    the FCN head's deconv (through the importer's flip) gets some."""
    _, _, port_grads, jax_grads = mrcnn_step
    got, ref = leaves(port_grads), leaves(jax_grads)
    assert got.keys() == ref.keys()
    compared = 0
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        d = rel_l2(got[k], ref[k])
        compared += 1
        assert d < GRAD_RL2, f'{k}: rel-L2 {d:.2e}'
    deconv = "['roi_head']['mask_head']['upsample']['kernel']"
    assert np.abs(ref[deconv]).max() > 0
    assert compared >= 60, compared


# -- the four config files ----------------------------------------------------

@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_config_builds_and_keys_map(name):
    """The config file, unchanged, builds on the CPU; each state-dict key
    maps through the JAX importer (``_mmdet_key``) to the JAX tree path and
    leaf that the port's own key map gives, none skipped."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.apis import init_detector
    from dynamask_torch.engine.convert import mmdet_key
    from dynamask_torch.models.dynamask_roi_head import (DynaMaskRoIHead,
                                                         stage_capacities)
    from dynamask_torch.data import CITYSCAPES_CLASSES, COCO_CLASSES
    from dynamask_torch.models.fcn_mask_head import FCNMaskHead

    model = init_detector(os.path.join(ROOT, CONFIGS[name]), device='cpu')
    head = model.roi_head
    keys = [k for k in model.state_dict()
            if not k.endswith('num_batches_tracked')]
    for k in keys:
        ref = _mmdet_key(k)
        assert ref is not None, f'the JAX importer skips {k}'
        path, leaf, _ = mmdet_key(k)
        assert (ref[0], ref[1]) == (path, leaf), k
    blocks = {'r101': 23}.get(name, 6)
    assert f'backbone.layer3.{blocks - 1}.conv3.weight' in keys
    assert f'backbone.layer3.{blocks}.conv3.weight' not in keys
    classes = {'lvis': 1203, 'cityscapes': 8}.get(name, 80)
    assert head.num_classes == len(model.CLASSES) == classes
    lvis = tuple(f'class_{i}' for i in range(1203))
    assert model.CLASSES == {'lvis': lvis, 'cityscapes':
                             CITYSCAPES_CLASSES}.get(name, COCO_CLASSES)
    assert head.bbox_head.fc_cls.out_features == classes + 1
    if name == 'mask_rcnn':
        assert type(head.mask_head) is FCNMaskHead
        assert head.mask_head.conv_logits.out_channels == 80
        assert len(head.mask_head.convs) == 4 and head.loss_mask_weight == 1
        assert head.mask_roi_out == 14 and head.max_per_img == 100
    else:
        assert isinstance(head, DynaMaskRoIHead)
        slots = 300 if name == 'lvis' else 100
        assert head.max_per_img == slots
        assert stage_capacities(slots, head.dynamic_capacity) == \
            (slots, slots, slots, 3 if name == 'lvis' else 1)
        assert head.score_thr == (1e-4 if name == 'lvis' else 0.05)


@pytest.mark.parametrize('name,shapes', [
    ('flagship', ((800, 1344), 4, (800, 1344))),
    ('mask_rcnn', ((800, 1344), 4, (800, 1344))),
    ('r101', ((800, 1344), 4, (800, 1344))),
    ('lvis', ((800, 1344), 4, (800, 1344))),
    ('cityscapes', ((1024, 2048), 1, (1024, 2048)))])
def test_config_shapes(name, shapes):
    """``apis.config_shapes`` reads what each config states: the first
    canvas of its test set, ``data.samples_per_gpu`` and the first canvas
    of its train set (the inner set of LVIS's ``ClassBalancedDataset``);
    ``init_detector`` takes the test set's canvases and class names."""
    from dynamask_torch.apis import config_shapes, init_detector
    from dynamask_torch.data import CITYSCAPES_CLASSES
    from dynamask_torch.utils.config import Config
    path = os.path.join(ROOT, CONFIGS.get(
        name, 'configs/dynamask/coco/r50_dynamask_1x.py'))
    assert config_shapes(path) == shapes
    # the toy DynaMask at 8 classes in place of the config's model: the
    # names are the test set's where there are 8 of them (Cityscapes),
    # else class_{i}
    from test_dynamask import dynamask_toy_cfg
    model, train_cfg, test_cfg = dynamask_toy_cfg()
    det = init_detector(Config(dict(
        Config.fromfile(path).to_dict(), model=model, train_cfg=train_cfg,
        test_cfg=test_cfg)), device='cpu')
    city = name == 'cityscapes'
    assert det.canvases[0] == shapes[0]
    assert len(det.canvases) == (2 if city else 3)
    assert det.CLASSES == (CITYSCAPES_CLASSES if city else
                           tuple(f'class_{i}' for i in range(8)))


@pytest.mark.parametrize('alias', [a for aliases in dataset_aliases.values()
                                   for a in aliases])
def test_get_classes_equal(alias):
    """``core.get_classes`` gives the JAX package's list for every alias."""
    from dynamask_tpu.core.class_names import get_classes as jax_classes
    from dynamask_torch.core.class_names import get_classes
    assert list(get_classes(alias)) == list(jax_classes(alias))
