"""Item 9's two-stage detectors as toys on the CPU: the port against the
JAX package on the same seeded inputs, the JAX weights carried across by
``dynamask_torch.engine.convert``; where JAX reaches RoIAlign it runs its
XLA form.

- The toys (ResNet-18, 32-channel FPN, 8 classes, 64x64: the mini Mask
  R-CNN of ``tests/test_models.py`` and the heads of the JAX package's own
  tests): PointRefine (the config's sigmoid detail maps and class-agnostic
  last stage), PointRend (3 subdivision steps), Mask Scoring R-CNN, Grid
  R-CNN, Grid R-CNN under GRoIE's box extractor and Dynamic R-CNN.
- ``simple_test`` slot for slot: dets within 1.5e-5 (``rtol=1e-5``),
  labels and validity exact, the mask probabilities within 2e-4, Mask
  Scoring R-CNN's ``segm_scores`` and Grid R-CNN's refined boxes.
- One ``forward_train`` with every draw injected on both sides: the RPN's
  and the RoI sampler's priorities (Grid R-CNN's second sampling draws the
  same table, as JAX's patched sampler does), PointRend's two uniform
  point sets and Grid R-CNN's jitter: every loss within 1e-4 relative,
  every parameter's gradient within 1e-3 relative L2.
- The key map both ways for each new head; the config files of
  ``chip_smoke.py`` phase 18 built on the CPU through it; the JAX faults
  3ay-3bd (ROADMAP.md queue 3) and the keys the builders refuse.
"""

import contextlib
import copy
import functools
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_cascade import _demo, _port_grads  # noqa: E402
from test_torch_port_item9_heads import dynamic_toy_cfg  # noqa: E402
from test_torch_port_modules import fast_jit, randomize_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ANCHORS = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
G = 3                        # the demo batch's GTs
LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
MASK_ATOL = 2e-4
KINDS = ('point_refine', 'point_rend', 'ms_rcnn', 'grid', 'grid_groie',
         'dynamic')
# each toy's RoI head in the port, its mask probabilities' side (None: no
# masks)
HEADS = {'point_refine': ('PointRefineRoIHead', 112),
         'point_rend': ('PointRendRoIHead', 56),
         'ms_rcnn': ('MaskScoringRoIHead', 28), 'grid': ('GridRoIHead', None),
         'grid_groie': ('GridRoIHead', None),
         'dynamic': ('DynamicRoIHead', None)}
POINT_REND_SIMPLE = dict(type='GenericRoIExtractor', aggregation='concat',
                         roi_layer=dict(type='SimpleRoIAlign', output_size=14),
                         out_channels=32, featmap_strides=[4])


def toy_cfg(kind):
    """(model, train_cfg, test_cfg) of the toy ``kind``."""
    from test_grid_rcnn import grid_toy_cfg
    from test_point_refine import point_refine_toy_cfg
    from test_point_rend import point_rend_toy_cfg
    if kind == 'dynamic':
        return dynamic_toy_cfg(interval=2)
    if kind.startswith('grid'):
        model, train_cfg, test_cfg = copy.deepcopy(grid_toy_cfg())
        if kind == 'grid_groie':
            model['roi_head']['bbox_roi_extractor'].update(
                type='GenericRoIExtractor', aggregation='sum')
        return model, train_cfg, test_cfg
    if kind == 'point_refine':
        model, train_cfg, test_cfg = copy.deepcopy(point_refine_toy_cfg())
        model['roi_head']['mask_head'].update(stage_num_classes=[8, 8, 8, 1],
                                              mask_use_sigmoid=True)
        return model, train_cfg, test_cfg
    if kind == 'point_rend':
        model, train_cfg, test_cfg = copy.deepcopy(point_rend_toy_cfg())
        model['roi_head']['mask_roi_extractor'] = dict(POINT_REND_SIMPLE)
        return model, train_cfg, test_cfg
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    model['type'] = 'MaskScoringRCNN'
    model['roi_head'].update(type='MaskScoringRoIHead', mask_iou_head=dict(
        type='MaskIoUHead', num_convs=4, num_fcs=2, roi_feat_size=14,
        in_channels=32, conv_out_channels=256, fc_out_channels=1024,
        num_classes=8, loss_iou=dict(type='MSELoss', loss_weight=0.5)))
    return model, train_cfg, test_cfg


def _batch(b=1, semantic=False):
    batch = _demo(b)
    if semantic:         # PointRefine's semantic target at 1/4 of the canvas
        rng = np.random.RandomState(15)
        batch['gt_semantic'] = (rng.uniform(size=(b, 16, 16)) > 0.6).astype(
            np.uint8)
    return batch


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them). Grid R-CNN's deconv kernels are widened from their N(0, 0.001)
    init, so each heatmap's maximum stands clear of the others; the MaskIoU
    head's bias is 0.5, so its IoUs are not all clipped."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    det = jax_build(*cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(
        semantic=kind == 'point_refine').items()}
    variables = randomize_variables(
        fast_jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    rh = variables['params']['roi_head']
    if kind.startswith('grid'):
        rng = np.random.RandomState(16)
        for k in ('deconv1_kernel', 'deconv2_kernel'):
            rh['grid_head_module'][k] = rng.normal(
                0, 0.2, np.shape(rh['grid_head_module'][k])).astype(
                    np.float32)
    if kind == 'ms_rcnn':       # IoUs inside (0, 1), not clipped to 0
        rh['mask_iou_head']['fc_mask_iou']['bias'] = np.full(
            (8,), 0.5, np.float32)
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


@functools.lru_cache(maxsize=None)
def outputs(kind):
    """The batch of two images (the second at a scale factor of 0.8), and
    JAX's and the port's ``simple_test`` of it."""
    det, variables, port = twin(kind)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch_np = {k: _demo(2)[k] for k in keys}
    batch_np['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch_np.items()})
    return batch_np, ref, got


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    """Dets, labels and validity slot for slot; the mask probabilities of
    the valid slots; Mask Scoring R-CNN's ``segm_scores``; Grid R-CNN's
    dets are its refined boxes, not the box branch's."""
    from dynamask_torch.models.roi_head import StandardRoIHead
    det, variables, port = twin(kind)
    assert type(port.roi_head).__name__ == HEADS[kind][0]
    batch_np, ref, got = outputs(kind)
    for i in range(2):
        assert ref['det_valid'][i].sum() >= 3
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1.5e-5)
    side = HEADS[kind][1]
    assert ('mask_probs' in got) == ('mask_probs' in ref) == bool(side)
    if side:
        valid = ref['det_valid'].astype(bool)
        probs = got['mask_probs'].numpy()
        assert probs.shape == (2, 8, side, side)
        assert probs[valid].std() > 1e-2
        np.testing.assert_allclose(probs[valid], ref['mask_probs'][valid],
                                   atol=MASK_ATOL)
    assert ('segm_scores' in got) == ('segm_scores' in ref) == (
        kind == 'ms_rcnn')
    if kind == 'ms_rcnn':
        np.testing.assert_allclose(got['segm_scores'].numpy(),
                                   ref['segm_scores'], rtol=1e-5, atol=1e-6)
        s = got['segm_scores'].numpy()
        assert (s <= got['dets'][..., 4].numpy() + 1e-6).all() and s.any()
    if kind.startswith('grid'):
        b = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        with torch.no_grad():
            feats = port.extract_feat(port.images(b))
            props = port.rpn_proposals(feats, b)
            box = StandardRoIHead.simple_test(port.roi_head, feats,
                                              props.boxes, props.valid, b)
        v = got['det_valid'].numpy().astype(bool)
        assert np.abs(box['dets'].numpy()[v] -
                      got['dets'].numpy()[v]).max() > 1.0


def _uniform_tables(shapes):
    """A seeded uniform draw of each of ``shapes``."""
    rng = np.random.RandomState(17)
    return {s: rng.uniform(size=s).astype(np.float32) for s in shapes}


@contextlib.contextmanager
def jax_draws(module, tables, key=lambda shape: shape):
    """While active, ``jax.random.uniform`` in the JAX package's ``module``
    returns ``tables[key(shape)]`` (its bounds ignored: the table is the
    draw)."""
    saved = module.jax

    class _Proxy(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jax, name)

    proxy = _Proxy('jax')
    proxy.random = types.SimpleNamespace(
        uniform=lambda k, shape, *a, **kw: jnp.asarray(tables[key(
            tuple(shape))]),
        split=jax.random.split, fold_in=jax.random.fold_in,
        PRNGKey=jax.random.PRNGKey)
    module.jax = proxy
    try:
        yield
    finally:
        module.jax = saved


def _draws(kind, port):
    """(JAX patches, the port's noise) of the step's draws beside the
    samplers': PointRend's point sets, Grid R-CNN's jitter."""
    import dynamask_tpu.models.grid_rcnn as jgrid
    import dynamask_tpu.models.point_rend as jrend
    r = port.roi_head.max_pos         # one image's positive slots
    if kind == 'point_rend':
        rh = port.roi_head
        n_over = int(rh.num_points * rh.oversample_ratio)
        n_rand = rh.num_points - int(rh.importance_sample_ratio *
                                     rh.num_points)
        t = _uniform_tables([(r, n_over, 2), (r, n_rand, 2)])
        return (jax_draws(jrend, t), {
            'point_over': torch.from_numpy(t[(r, n_over, 2)]),
            'point_rand': torch.from_numpy(t[(r, n_rand, 2)])})
    if kind.startswith('grid'):
        from dynamask_torch.models.grid_rcnn import JITTER
        jit = (_uniform_tables([(r, 4)])[(r, 4)] * 2 - 1) * JITTER
        return jax_draws(jgrid, {(r, 4): jit}), {
            'grid_jitter': torch.from_numpy(jit.astype(np.float32))}
    return contextlib.nullcontext(), {}


@functools.lru_cache(maxsize=None)
def train_step(kind):
    """One training step's logs and gradients on both sides, from the same
    variables and draws; the JAX gradients in the port's layout through
    the port's key map."""
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import _torch_layout, mmdet_key
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(kind)
    port = copy.deepcopy(port).train()
    batch = _batch(semantic=kind == 'point_refine')
    p = toy_cfg(kind)[1]['rpn_proposal']['max_num']
    rng = np.random.RandomState(14)
    tables = {n: rng.uniform(size=n).astype(np.float32)
              for n in (N_ANCHORS, G + p)}
    patch, noise = _draws(kind, port)

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax_sampler_priorities(tables), patch:
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables.get('batch_stats', {}),
            {k: jnp.asarray(x) for k, x in batch.items()})
    noise.update(rpn=torch.from_numpy(tables[N_ANCHORS][None]),
                 rcnn=torch.from_numpy(tables[G + p][None]),
                 rcnn_grid=torch.from_numpy(tables[G + p][None]))
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()}, noise))
    total.backward()
    got = _port_grads(port)
    jax_grads = jax.device_get(jax_grads)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k)) for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax.device_get(jax_log).items()},
            got, ref)


# the loss keys of each toy's step beside the RPN's and the total
LOSSES = {'point_refine': {'loss_cls', 'loss_bbox', 'acc', 'loss_instance',
                           'loss_semantic'},
          'point_rend': {'loss_cls', 'loss_bbox', 'acc', 'loss_mask',
                         'loss_point'},
          'ms_rcnn': {'loss_cls', 'loss_bbox', 'acc', 'loss_mask',
                      'loss_mask_iou'},
          'grid': {'loss_cls', 'loss_bbox', 'acc', 'loss_grid'},
          'grid_groie': {'loss_cls', 'loss_bbox', 'acc', 'loss_grid'},
          'dynamic': {'loss_cls', 'loss_bbox', 'acc'}}


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    """Every loss of the step within 1e-4 of JAX's, the draws injected;
    each head's own losses non-zero (Grid R-CNN's box loss is 0: its box
    head does not regress)."""
    port_log, jax_log, _, _ = train_step(kind)
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    assert keys == LOSSES[kind] | {'loss_rpn_cls', 'loss_rpn_bbox', 'loss'}
    assert keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    for k in LOSSES[kind] - {'acc', 'loss_bbox'}:
        assert jax_log[k] > 0, k
    assert (jax_log['loss_bbox'] == 0) == kind.startswith('grid')


@pytest.mark.parametrize('kind', KINDS)
def test_per_leaf_gradients(kind):
    """Every parameter within 1e-3 relative L2 of JAX's gradient; a leaf
    JAX leaves without one has none in the port; each new head's modules
    get one."""
    _, _, got, ref = train_step(kind)
    compared = 0
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
        compared += 1
    new = {'point_refine': 'roi_head.mask_head.stages.',
           'point_rend': 'roi_head.point_head.',
           'ms_rcnn': 'roi_head.mask_iou_head.',
           'grid': 'roi_head.grid_head.', 'grid_groie': 'roi_head.grid_head.',
           'dynamic': 'roi_head.bbox_head.fc_reg'}[kind]
    heads = [k for k in ref if k.startswith(new)]
    assert heads and all(ref[k].any() for k in heads), [
        k for k in heads if not ref[k].any()]
    assert compared >= 40, compared


@pytest.mark.parametrize('kind', KINDS)
def test_key_map_both_ways(kind):
    """Every port tensor of the RoI head has one JAX leaf, and every JAX
    leaf of the RoI head (Dynamic R-CNN's state among them) is reached."""
    from dynamask_torch.engine.convert import mmdet_key
    det, variables, port = twin(kind)

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,)

    reached = set()
    for k in port.state_dict():
        if not k.startswith('roi_head.') or 'num_batches' in k:
            continue
        path, leaf, hints = mmdet_key(k)
        if leaf == 'state':
            got = ('batch_stats',) + tuple(path) + (hints['stat'],)
        elif 'flax_leaf' in hints:
            got = ('params',) + tuple(path) + (hints['flax_leaf'],)
        elif leaf == 'weight':
            node = variables['params']
            for p in path:
                node = node[p]
            got = ('params',) + tuple(path) + (
                'scale' if 'scale' in node else 'kernel',)
        else:
            got = ('params',) + tuple(path) + (leaf,)
        assert got not in reached, k
        reached.add(got)
    want = {('params',) + p for p in flat(variables['params'])} | {
        ('batch_stats',) + p for p in flat(variables.get('batch_stats', {}))}
    want = {p for p in want if p[1] == 'roi_head'}
    assert reached == want, (sorted(want - reached)[:5],
                             sorted(reached - want)[:5])


# -- the configs, the refusals and the JAX package's faults -------------------

PHASE18 = {'point_refine/r50_point_refine_1x.py': 'PointRefineRoIHead',
           'point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py':
               'PointRendRoIHead',
           'ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py': 'MaskScoringRoIHead',
           'grid_rcnn/grid_rcnn_r50_fpn_gn-head_1x_coco.py': 'GridRoIHead',
           'groie/grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py': 'GridRoIHead',
           'dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py': 'DynamicRoIHead'}


def _config(rel):
    from dynamask_torch.utils.config import Config
    return Config.fromfile(os.path.join(ROOT, 'configs', rel))


def _meta(cfg):
    from dynamask_torch.models import build_detector
    return build_detector(cfg['model'], cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')


@pytest.mark.parametrize('rel', sorted(PHASE18))
def test_phase18_configs_as_jax_builds_them(rel):
    """Each config of ``chip_smoke.py`` phase 18 builds as JAX's builder
    reads it: the head's options, the box extract's mode (the grid
    extract's too, 3z), every state-dict key mapped."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine.convert import key_hints, mmdet_key
    cfg = _config(rel)
    port = _meta(cfg)
    rh = port.roi_head
    assert type(rh).__name__ == PHASE18[rel]
    jrh = jax_build(cfg['model'], cfg.get('train_cfg'),
                    cfg.get('test_cfg')).roi_head
    assert rh.roi_extract_mode == jrh.roi_extract_mode
    assert (rh.max_per_img, rh.score_thr, rh.num_classes) == (
        jrh.max_per_img, jrh.score_thr, jrh.num_classes)
    if 'point_rend' in rel:
        assert (rh.num_points, rh.subdivision_steps,
                rh.subdivision_num_points, rh.mask_roi_out) == (
            jrh.num_points, jrh.subdivision_steps,
            jrh.subdivision_num_points, jrh.mask_roi_out)
    if 'grid' in rel:
        assert (rh.grid_roi_out, rh.pos_radius, rh.loss_bbox_weight) == (
            jrh.grid_roi_out, jrh.pos_radius, 0.0)
        assert not hasattr(rh.bbox_head, 'fc_reg')
    if 'dynamic' in rel:
        assert (rh.iou_topk, rh.beta_topk, rh.update_iter_interval) == (
            jrh.iou_topk, jrh.beta_topk, jrh.update_iter_interval)
    if 'point_refine' in rel:
        assert rh.with_semantic and rh.mask_head.stage_num_classes == (
            80, 80, 80, 1)
    hints = key_hints(port)
    keys = [k for k in port.state_dict() if 'num_batches' not in k]
    assert all(mmdet_key(k, **hints) for k in keys)


@pytest.mark.parametrize('rel,edit', [
    ('ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py',
     lambda c: c['model']['roi_head']['mask_iou_head'].update(num_convs=3)),
    ('ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py',
     lambda c: c['train_cfg']['rcnn'].update(mask_thr_binary=0.4)),
    ('point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py',
     lambda c: c['model']['roi_head']['point_head']['loss_point'].update(
         loss_weight=2.0)),
    ('point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py',
     lambda c: c['model']['roi_head']['mask_roi_extractor'].update(
         featmap_strides=[8])),
    ('point_refine/r50_point_refine_1x.py',
     lambda c: c['model']['roi_head']['mask_head']['loss_cfg'].update(
         start_stage=1)),
    ('grid_rcnn/grid_rcnn_r50_fpn_gn-head_1x_coco.py',
     lambda c: c['train_cfg']['rcnn'].update(max_num_grid=100)),
    ('grid_rcnn/grid_rcnn_r50_fpn_gn-head_1x_coco.py',
     lambda c: c['model']['roi_head']['grid_head']['loss_grid'].update(
         loss_weight=10)),
    ('grid_rcnn/grid_rcnn_r50_fpn_gn-head_1x_coco.py',
     lambda c: c['model']['roi_head']['bbox_head'].update(with_reg=True)),
    ('dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py',
     lambda c: c['model']['roi_head']['bbox_head'].update(with_reg=False)),
    ('dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py',
     lambda c: c['model']['roi_head']['bbox_head']['loss_bbox'].update(
         beta=0.5)),
    ('dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py',
     lambda c: c['train_cfg']['rcnn']['assigner'].update(neg_iou_thr=0.3)),
])
def test_dropped_keys_refused_3w(rel, edit):
    """A key JAX drops or fixes, at another value than it computes with,
    is refused (3w); the file as it is builds."""
    cfg = _config(rel)
    _meta(cfg)
    edit(cfg)
    with pytest.raises(NotImplementedError, match='3w'):
        _meta(cfg)


def test_grid_branch_draws_its_own_positives_3ay():
    """3ay: JAX's Grid R-CNN samples the RoIs a second time for its grid
    branch (``grid_rcnn.py:291-298``), so its positives are not the box
    branch's, and it applies no ``max_num_grid`` (every grid file's 192).
    Given two different priority tables for the two draws (the port takes
    them as 'rcnn' and 'rcnn_grid') and a sampler that keeps 2 of the
    positives, the grid loss moves while the box losses stay; JAX's step
    calls its sampler twice."""
    import dynamask_tpu.models.grid_rcnn as jgrid
    from dynamask_torch.core.samplers import RandomSampler
    det, variables, port = twin('grid')
    port = copy.deepcopy(port).train()
    port.roi_head.sampler = RandomSampler(32, 2 / 32)
    batch = {k: torch.from_numpy(x) for k, x in _batch().items()}
    p = toy_cfg('grid')[1]['rpn_proposal']['max_num']
    rng = np.random.RandomState(18)
    a, b = (torch.from_numpy(rng.uniform(size=(1, G + p)).astype(np.float32))
            for _ in range(2))
    jit = torch.zeros(port.roi_head.max_pos, 4)
    rpn = torch.full((1, N_ANCHORS), 0.5)
    with torch.no_grad():
        logs = [port.forward_train(batch, dict(rpn=rpn, rcnn=a, rcnn_grid=g,
                                               grid_jitter=jit))
                for g in (a, b)]
    for k in ('loss_cls', 'loss_rpn_cls'):
        assert float(logs[0][k]) == float(logs[1][k])
    assert float(logs[0]['loss_grid']) != float(logs[1]['loss_grid'])
    calls = []
    orig = jgrid.GridRoIHead._sample_rois
    assert '_sample_rois' not in jgrid.GridRoIHead.__dict__

    def count(self, *args, **kw):
        calls.append(1)
        return orig(self, *args, **kw)

    jgrid.GridRoIHead._sample_rois = count
    try:
        jax.eval_shape(lambda v, bb: det.apply(
            v, bb, method='forward_train', rngs={'sampling':
                                                 jax.random.PRNGKey(0)},
            mutable=['batch_stats']), variables,
            {k: jnp.asarray(x) for k, x in _batch().items()})
    finally:
        del jgrid.GridRoIHead._sample_rois
    assert len(calls) == 2
    assert 'max_num_grid' not in open(jgrid.__file__).read().split(
        'class GridRoIHead')[1]


def test_mask_iou_loss_is_not_mmdets_3az():
    """3az: JAX's IoU loss is ``loss_weight * 0.5 (p - t)²`` averaged over
    every valid positive (``mask_scoring.py:132-134``), where mmdet's
    ``MSELoss`` of weight 0.5 averages ``(p - t)²`` over the positives of
    target > 0: on a positive whose binarised mask misses its GT (target
    0) the two part. The port computes JAX's (its step's losses are held
    above)."""
    pred = torch.tensor([0.8, 0.3, 0.6, 0.1])
    target = torch.tensor([0.7, 0.0, 0.5, 0.0])
    valid = torch.ones(4)
    weight = 0.5
    jax_form = weight * (0.5 * (pred - target) ** 2 * valid).sum() / \
        valid.sum()
    pos = target > 0
    mmdet_form = weight * ((pred[pos] - target[pos]) ** 2).mean()
    assert abs(float(jax_form) - float(mmdet_form)) > 1e-3
    src = open(os.path.join(ROOT, 'dynamask_tpu/models/mask_scoring.py')
               ).read()
    assert '0.5 * (sel - iou_target) ** 2 * w' in src


def _mmcv_simple_roi_align(feat, rois, out, scale):
    """mmcv's ``SimpleRoIAlign`` (aligned): one sample at each bin centre,
    ``point_sample`` with zero padding (grid_sample, corners unaligned)."""
    n, c, h, w = feat.shape
    g = (torch.arange(out, dtype=torch.float32) + 0.5) / out
    x = (rois[:, 0:1] + g[None] * (rois[:, 2:3] - rois[:, 0:1])) * scale
    y = (rois[:, 1:2] + g[None] * (rois[:, 3:4] - rois[:, 1:2])) * scale
    gx = (x / w * 2 - 1)[:, None, :].expand(-1, out, -1)
    gy = (y / h * 2 - 1)[:, :, None].expand(-1, -1, out)
    grid = torch.stack([gx, gy], -1)
    return torch.nn.functional.grid_sample(
        feat.expand(rois.shape[0], -1, -1, -1), grid, align_corners=False)


def test_point_rend_coarse_crop_is_roi_align_3ba():
    """3ba: JAX crops PointRend's coarse features with RoIAlign at ratio 1
    (``point_rend.py:169-176``), whose samples within a pixel outside the
    map clamp to its edge, where mmcv's ``SimpleRoIAlign`` zero-pads: a RoI
    inside the map gives the same crop, one over its border another. The
    port crops as JAX (K2)."""
    from dynamask_tpu.ops.roi_align import simple_roi_align as jsra
    from dynamask_torch.ops.roi_align import simple_roi_align
    rng = np.random.RandomState(19)
    feat = rng.randn(1, 16, 20, 3).astype(np.float32)
    rois = np.array([[10., 8., 50., 40.], [-6., -5., 30., 30.]], np.float32)
    b = np.zeros(2, np.int32)
    ref = np.asarray(jsra(jnp.asarray(feat), jnp.asarray(rois),
                          jnp.asarray(b), 14, 0.25))
    got = simple_roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                           torch.from_numpy(b).long(), 14, 0.25).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    mmcv = _mmcv_simple_roi_align(torch.from_numpy(feat).permute(0, 3, 1, 2),
                                  torch.from_numpy(rois), 14, 0.25)
    mmcv = mmcv.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(mmcv[0], got[0], atol=1e-5)
    assert np.abs(mmcv[1] - got[1]).max() > 0.1


def test_grid_point_sample_clamps_3bb():
    """3bb: JAX's ``grid_point_sample`` clamps its corner indices and
    weights to the coarse map (``point_rend.py:51-53``), where mmcv's
    ``point_sample`` zero-pads: inside the cells' centres they agree; at
    x = 0.02 of 7 cells (0.36 of a cell before the first centre) JAX
    weighs cells 0 and 1 by 0.36 and 0.64, mmcv cell 0 by 0.64 and zero by
    0.36; past the last centre JAX reads the last cell in full. The port
    clamps as JAX."""
    from dynamask_tpu.models.point_rend import grid_point_sample as jgps
    from dynamask_torch.models.point_rend import grid_point_sample
    maps = np.random.RandomState(20).randn(1, 7, 7, 2).astype(np.float32)
    pts = np.array([[[0.5, 0.5], [0.02, 0.5], [0.99, 0.5]]], np.float32)
    got = grid_point_sample(torch.from_numpy(maps),
                            torch.from_numpy(pts)).numpy()[0]
    np.testing.assert_allclose(got, np.asarray(jgps(
        jnp.asarray(maps), jnp.asarray(pts)))[0], rtol=1e-6)
    mmcv = torch.nn.functional.grid_sample(
        torch.from_numpy(maps).permute(0, 3, 1, 2),
        torch.from_numpy(pts * 2 - 1)[:, :, None], align_corners=False)
    mmcv = mmcv[0, :, :, 0].T.numpy()
    row = maps[0, 3]
    np.testing.assert_allclose(mmcv[0], got[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], 0.36 * row[0] + 0.64 * row[1],
                               rtol=1e-5)
    np.testing.assert_allclose(mmcv[1], 0.64 * row[0], rtol=1e-5)
    np.testing.assert_allclose(got[2], row[6], rtol=1e-5)
    np.testing.assert_allclose(mmcv[2], 0.57 * row[6], rtol=1e-4)


def test_segm_scores_reach_no_result_3bc():
    """3bc: Mask Scoring R-CNN's ``segm_scores`` (``mask_scoring.py:156``)
    are read by nothing under ``dynamask_tpu/apis/``, so its segm results
    keep the box score; the port's test step (``make_test_fn``, which every
    test and inference entry runs) gives the box branch's scores too."""
    from dynamask_torch.apis import make_test_fn
    apis = os.path.join(ROOT, 'dynamask_tpu', 'apis')
    assert not any('segm_scores' in open(os.path.join(apis, f)).read()
                   for f in os.listdir(apis) if f.endswith('.py'))
    _, variables, port = twin('ms_rcnn')
    batch_np, _, got = outputs('ms_rcnn')
    out = make_test_fn(port, (64, 64))({k: torch.from_numpy(v)
                                        for k, v in batch_np.items()})
    assert 'segm_scores' not in out and 'masks' in out
    np.testing.assert_array_equal(out['dets'].numpy(), got['dets'].numpy())
    assert not np.allclose(got['segm_scores'].numpy(),
                           got['dets'][..., 4].numpy())


def test_jax_importer_skips_the_item9_heads_3bd():
    """3bd: the JAX importer (``dynamask_tpu/engine/pretrained.py:120``)
    has no rule for these heads' keys: an mmdet checkpoint leaves the
    MaskIoU head, PointRend's coarse fcs and point head, the grid head and
    PointRefine's stage MLPs at init; the port's key map carries them
    (``test_key_map_both_ways``)."""
    from dynamask_tpu.engine.pretrained import _mmdet_key
    for kind, part in (('ms_rcnn', 'roi_head.mask_iou_head.'),
                       ('point_rend', 'roi_head.point_head.'),
                       ('point_rend', 'roi_head.mask_head.fcs.'),
                       ('grid', 'roi_head.grid_head.'),
                       ('point_refine', 'roi_head.mask_head.stages.0.fcs.')):
        keys = [k for k in twin(kind)[2].state_dict() if k.startswith(part)]
        assert keys and all(_mmdet_key(k) is None for k in keys), kind
