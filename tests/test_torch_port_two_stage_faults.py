"""The JAX faults that the two-stage family's options reproduce on the CPU
(ROADMAP.md queue 3, 3s-3z), each shown against the JAX package, and the
phase-13 config files built from their unchanged files as JAX builds
them (on the ``meta`` device).
"""

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

from test_torch_port_cascade import _demo  # noqa: E402
from test_torch_port_train_slice import rel_l2  # noqa: E402
from test_torch_port_two_stage_twins import (G, N_ANCHORS, P,  # noqa: E402
                                             toy_cfg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng_nhwc(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the JAX faults the port reproduces ---------------------------------------

def test_ohem_config_samples_at_random_3s():
    """3s: the OHEM config's JAX RoI head holds an ``OHEMSampler``; the
    port's holds the random sampler with the config's ``num`` /
    ``pos_fraction``, and its step's losses equal the random sampler's
    step on the same draws: no hard-example ranking."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.core.samplers import RandomSampler
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py'))
    d = cfg.to_dict()
    assert type(jax_build(d['model'], d['train_cfg'], d['test_cfg'])
                .roi_head.sampler_obj).__name__ == 'OHEMSampler'
    port = build_detector(*toy_cfg('ohem'), device='cpu', seed=3).train()
    plain = build_detector(*_plain_faster(), device='cpu', seed=3).train()
    assert type(port.roi_head.sampler) is RandomSampler
    assert (port.roi_head.sampler.num, port.roi_head.sampler.pos_fraction) \
        == (32, 0.25)
    batch = {k: torch.from_numpy(v) for k, v in _demo().items()}
    rng = np.random.RandomState(2)
    noise = {'rpn': torch.from_numpy(rng.uniform(size=(1, N_ANCHORS)).astype(
        np.float32)), 'rcnn': torch.from_numpy(rng.uniform(
            size=(1, G + P)).astype(np.float32))}
    a = port.forward_train(batch, noise)
    b = plain.forward_train(batch, noise)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _plain_faster():
    model, train_cfg, test_cfg = toy_cfg('ohem')
    train_cfg['rcnn']['sampler']['type'] = 'RandomSampler'
    return model, train_cfg, test_cfg


JAX_SKIPPED = re.compile(
    r'^(neck\.(lateral_convs|fpn_convs)\.\d+\.gn\.|'
    r'neck\.upsample_modules\.|roi_head\.bbox_head\.shared_convs\.|'
    r'roi_head\.mask_head\.convs\.\d+\.gn\.|roi_head\.mask_head\.upsample\.'
    r'(channel_compressor|content_encoder)|'
    r'roi_head\.bbox_head\.(res_block|conv_branch|fc_branch)\.)')
PHASE13 = {
    'gn_ws': 'configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py',
    'gn_ws_x101': 'configs/gn+ws/mask_rcnn_x101_32x4d_fpn_gn_ws-all_2x_coco.py',
    'groie': 'configs/groie/mask_rcnn_r50_fpn_groie_1x_coco.py',
    'dh': 'configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py',
    'carafe': 'configs/carafe/mask_rcnn_r50_fpn_carafe_1x_coco.py',
    'giou': 'configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py',
    'ohem': 'configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py',
    'soft_nms': 'configs/faster_rcnn/faster_rcnn_r50_fpn_soft_nms_1x_coco.py',
}


@pytest.mark.parametrize('name', ['gn_ws', 'carafe', 'dh'])
def test_jax_importer_leaves_the_options_at_init_3t(name):
    """3t: the JAX importer (``_mmdet_key``) has no rule for the FPN's and
    the heads' GroupNorms, the shared convs, CARAFE's encoders or
    Double-Head's branches: those keys of the config's model are skipped
    (their JAX leaves keep their init), every other key maps where the
    port's key map puts it; the port's key map takes them all."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    from dynamask_torch.apis import init_detector
    from dynamask_torch.engine.convert import mmdet_key
    model = init_detector(os.path.join(ROOT, PHASE13[name]), device='meta')
    keys = [k for k in model.state_dict()
            if not k.endswith('num_batches_tracked')]
    skipped = [k for k in keys if _mmdet_key(k) is None and
               not k.startswith('backbone.')]      # the backbone's GN: 3i
    assert skipped and all(JAX_SKIPPED.match(k) for k in skipped), [
        k for k in skipped if not JAX_SKIPPED.match(k)]
    for k in keys:
        assert mmdet_key(k) is not None, k
        if _mmdet_key(k) is not None and not k.startswith('backbone.'):
            assert tuple(_mmdet_key(k)[:2]) == tuple(mmdet_key(k)[:2]), k
    want = {'gn_ws': 2 * (4 + 4) + 4 + 4 * 2 + 4 * 2,
            'carafe': 4 * 4 + 4,
            'dh': None}[name]
    if want is not None:
        assert len(skipped) == want, len(skipped)


def test_double_head_routes_the_enlarged_rois_3u():
    """3u: a RoI of sqrt(wh) = 100 routes to P2; enlarged 1.3x (130 >
    112 = 2 * finest_scale) it routes to P3 in JAX, where mmdet routes the
    original RoI (P2) and rescales it. The port's regression crop is the
    P3 one, as JAX's; the P2 crop of the same box differs."""
    from dynamask_tpu.models.double_head import scale_rois as jscale
    from dynamask_tpu.ops.roi_align import map_roi_levels as jmap
    from dynamask_torch.models.double_head import scale_rois
    from dynamask_torch.ops.roi_align import roi_align
    from dynamask_torch.models import build_detector
    port = build_detector(*toy_cfg('dh'), device='cpu')
    rois = np.array([[10., 12., 110., 112.]], np.float32)
    assert int(jmap(jnp.asarray(rois), 4)[0]) == 0
    assert int(jmap(jscale(jnp.asarray(rois), 1.3), 4)[0]) == 1
    feats = [torch.from_numpy(_rng_nhwc(5 + i, 1, 32, 32, 32)).permute(
        0, 3, 1, 2) for i in range(2)] + [torch.zeros(1, 32, 8, 8),
                                          torch.zeros(1, 32, 4, 4)]
    feats[1] = torch.nn.functional.avg_pool2d(feats[1], 2)
    seen = []
    head = port.roi_head
    with torch.no_grad():
        saved = head.bbox_head.forward
        head.bbox_head.forward = lambda c, r: seen.append(r) or saved(c, r)
        try:
            head._bbox_forward(feats, torch.from_numpy(rois),
                               torch.zeros(1, dtype=torch.long))
        finally:
            del head.bbox_head.forward
        big = scale_rois(torch.from_numpy(rois), 1.3)
        p3 = roi_align(feats[1].permute(0, 2, 3, 1).contiguous(), big,
                       torch.zeros(1, dtype=torch.long), 7, 1 / 8)
        p2 = roi_align(feats[0].permute(0, 2, 3, 1).contiguous(), big,
                       torch.zeros(1, dtype=torch.long), 7, 1 / 4)
    assert torch.equal(seen[0], p3)
    assert rel_l2(p2.numpy(), p3.numpy()) > 0.1


def test_conv_out_channels_and_dropped_keys_refused_3w():
    """3w: JAX builds the GN box head's shared convs with ``in_channels``
    outputs whatever ``conv_out_channels`` says, and reads none of the
    IoU losses' options: the port refuses another value; the configs'
    values build."""
    from dynamask_tpu.models.builder import build_bbox_head as jbuild
    from dynamask_torch.models import build_detector
    head = dict(type='Shared4Conv1FCBBoxHead', in_channels=32,
                conv_out_channels=64, fc_out_channels=64, num_classes=8)
    jhead = jbuild(dict(head))[0]
    x = jnp.zeros((2, 7, 7, 32))
    v = jhead.init(jax.random.PRNGKey(0), x)
    assert v['params']['shared_conv_3']['kernel'].shape[-1] == 32
    model, train_cfg, test_cfg = toy_cfg('gn')
    model['roi_head']['bbox_head']['conv_out_channels'] = 64
    with pytest.raises(NotImplementedError, match='3w'):
        build_detector(model, train_cfg, test_cfg, device='meta')
    model, train_cfg, test_cfg = toy_cfg('giou')
    model['roi_head']['bbox_head']['loss_bbox']['eps'] = 1e-6
    with pytest.raises(NotImplementedError, match='3w'):
        build_detector(model, train_cfg, test_cfg, device='meta')
    model, train_cfg, test_cfg = toy_cfg('soft_nms')
    test_cfg['rcnn']['nms']['method'] = 'gaussian'
    with pytest.raises(NotImplementedError, match='3w'):
        build_detector(model, train_cfg, test_cfg, device='meta')


def test_scratch_decays_the_gn_scales_3x():
    """3x: the scratch configs' ``paramwise_cfg.norm_decay_mult=0`` is read
    by neither package: one step of the config's optimizer on zero
    gradients decays a GroupNorm scale by lr x weight_decay on both
    sides."""
    import optax
    from dynamask_tpu.engine import build_optimizer as jbuild_opt
    from dynamask_tpu.engine.optimizer import step_lr_schedule
    from dynamask_torch.engine import build_optimizer
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/scratch/mask_rcnn_r50_fpn_gn-all_scratch_6x_coco.py'))
    assert cfg.optimizer['paramwise_cfg'] == {'norm_decay_mult': 0}
    lr, wd = cfg.optimizer['lr'], cfg.optimizer['weight_decay']
    from dynamask_torch.models import build_detector
    port = build_detector(*toy_cfg('gn'), device='cpu')
    opt = build_optimizer(port, cfg.optimizer, cfg.optimizer_config,
                          dict(cfg.lr_config, warmup_iters=0),
                          steps_per_epoch=10)
    gn = port.neck.fpn_convs[0].gn.weight
    before = gn.detach().clone()
    opt.step()
    np.testing.assert_allclose(gn.detach().numpy(),
                               (before * (1 - lr * wd)).numpy(), rtol=1e-6)
    scale = {'scale': jnp.asarray(before.numpy())}
    tx = jbuild_opt(scale, lr, 0.9, wd, None, step_lr_schedule(lr, 10,
                                                               warmup_iters=0))
    upd, _ = tx.update({'scale': jnp.zeros_like(scale['scale'])},
                       tx.init(scale), scale)
    after = optax.apply_updates(scale, upd)['scale']
    np.testing.assert_allclose(np.asarray(after), gn.detach().numpy(),
                               rtol=1e-6)


def test_mask_extractor_follows_the_box_extractor_3z():
    """3z: JAX takes ``roi_extract_mode`` from the box extractor alone and
    applies it to the mask extract (``builder.py:334-338``): the GRoIE toy
    built with a single-level mask extractor pools its masks from every
    level in JAX; the port refuses that config."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.models import build_detector
    model, train_cfg, test_cfg = toy_cfg('groie')
    model['roi_head']['mask_roi_extractor']['type'] = 'SingleRoIExtractor'
    model['roi_head']['mask_roi_extractor'].pop('aggregation')
    assert jax_build(model, train_cfg, test_cfg).roi_head.roi_extract_mode \
        == 'generic_sum'
    with pytest.raises(NotImplementedError, match='3z'):
        build_detector(model, train_cfg, test_cfg, device='meta')


# -- the phase-13 configs -----------------------------------------------------

@pytest.mark.parametrize('name', sorted(PHASE13))
def test_phase13_config_builds(name):
    """The config file, unchanged, builds (``meta``) as JAX builds it: the
    box head, the FPN's norm, the extract mode, the regression loss, the
    test NMS and the sampler."""
    from dynamask_torch.apis import init_detector
    model = init_detector(os.path.join(ROOT, PHASE13[name]), device='meta')
    rh = model.roi_head
    want_head = {'gn_ws': 'Shared4Conv1FCBBoxHead',
                 'gn_ws_x101': 'Shared4Conv1FCBBoxHead',
                 'dh': 'DoubleConvFCBBoxHead'}.get(name, 'Shared2FCBBoxHead')
    assert type(rh.bbox_head).__name__ == want_head
    assert type(model).__name__ == ('MaskRCNN' if name in (
        'gn_ws', 'gn_ws_x101', 'groie', 'carafe') else 'FasterRCNN')
    assert hasattr(model.neck.fpn_convs[0], 'gn') == name.startswith('gn')
    assert type(model.neck).__name__ == ('FPN_CARAFE' if name == 'carafe'
                                         else 'FPN')
    assert rh.roi_extract_mode == ('generic_sum' if name == 'groie'
                                   else 'single')
    assert (rh.reg_loss_type, rh.reg_decoded_bbox) == (
        ('giou', True) if name == 'giou' else (None, False))
    assert rh.nms_cfg == ({'nms_type': 'soft_nms', 'sigma': 0.5,
                           'min_score': 1e-3} if name == 'soft_nms' else {})
    assert type(rh.sampler).__name__ == 'RandomSampler'
    assert (rh.sampler.num, rh.sampler.pos_fraction) == (512, 0.25)
    if name == 'dh':
        assert rh.reg_roi_scale_factor == 1.3
        assert (rh.loss_cls_weight, rh.loss_bbox_weight) == (2.0, 2.0)
