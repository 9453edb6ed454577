"""PISA's toy detectors on the CPU: the PyTorch port against the JAX
package on the same seeded inputs and draws, the JAX weights carried across
by ``dynamask_torch.engine.convert``; the modules are held in
``tests/test_torch_port_item9_pisa.py``.

- PISA Faster and Mask R-CNN (the mini Mask R-CNN of
  ``tests/test_models.py`` with the PISA files' RoI head and Score-HLR
  sampler, 2 images) and PISA RetinaNet (its file at toy width):
  ``simple_test`` slot for slot (dets within 1e-4 of the largest
  coordinate, labels and validity exact) and one ``forward_train`` in
  float64 on both sides (JAX under ``jax_enable_x64``) with the samplers'
  draws injected, each loss and gradient within ``STEP_TOL``: 1e-7
  relative and 1e-5 relative L2 on the two-stage toys, whose proposals
  JAX takes in fp32; 1e-5 and 1e-4 on PISA RetinaNet, whose losses JAX
  computes in fp32 whatever its inputs.
- The K2 / K4 calls a path (``chip_smoke.py`` phase 20): the Score-HLR
  pass over every candidate is one crop forward without a backward.
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

from test_torch_port_cascade import _port_grads, counted_crops  # noqa: E402
from test_torch_port_item6_ssd import draw_variables  # noqa: E402
from test_torch_port_item9_pisa import jax_uniform  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ANCHORS = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
G = 3                        # the demo batch's GTs
P = 32                       # the toy's training proposals an image
DET_RTOL = 1e-4
# one step in float64 on both sides: (losses' relative, gradients' relative
# L2) tolerance. JAX takes the two-stage proposals in fp32 (a float32
# scatter), which rounds the RoI head's losses and gradients to ~1e-8 and
# ~1e-6; PISA RetinaNet casts the head's outputs to fp32
# (``pisa.py:629-632``), so its losses round there
STEP_TOL = {'faster': (1e-7, 1e-5), 'mask': (1e-7, 1e-5),
            'retina': (1e-5, 1e-4)}
GRAD_FLOOR = 1e-9
SCORE_HLR = dict(type='ScoreHLRSampler', num=32, pos_fraction=0.25,
                 neg_pos_ub=-1, add_gt_as_proposals=True, k=0.5, bias=0.)


# -- toy detectors ------------------------------------------------------------

def pisa_two_stage_cfg(mask=True):
    """The mini Mask R-CNN (or Faster R-CNN without ``mask``) with the PISA
    files' RoI head: SmoothL1 at beta 1, Score-HLR sampling, ISR and
    CARL."""
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    rh = model['roi_head']
    rh['type'] = 'PISARoIHead'
    rh['bbox_head']['loss_bbox'] = dict(type='SmoothL1Loss', beta=1.0,
                                        loss_weight=1.0)
    if not mask:
        model['type'] = 'FasterRCNN'
        rh.pop('mask_head')
        rh.pop('mask_roi_extractor')
    train_cfg['rcnn'].update(sampler=dict(SCORE_HLR),
                             isr=dict(k=2, bias=0), carl=dict(k=1, bias=0.2))
    return model, train_cfg, test_cfg


def pisa_retina_cfg():
    from test_torch_port_single_stage import toy_cfg
    from dynamask_torch.utils.config import Config
    model, _, test_cfg = toy_cfg('retina')
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/pisa/pisa_retinanet_r50_fpn_1x_coco.py')).to_dict()
    model['bbox_head'].update(type='PISARetinaHead',
                              loss_bbox=cfg['model']['bbox_head']['loss_bbox'])
    return model, copy.deepcopy(cfg['train_cfg']), test_cfg


def _demo(b=2, side=64):
    from test_models import demo_batch
    return {k: np.array(v) for k, v in demo_batch(
        0, b=b, h=side, w=side, g=G, s=16).items()}


@functools.lru_cache(maxsize=None)
def twin(kind):
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = {'faster': lambda: pisa_two_stage_cfg(False),
           'mask': pisa_two_stage_cfg, 'retina': pisa_retina_cfg}[kind]()
    det = jax_build(*copy.deepcopy(cfg))
    variables = draw_variables(det, _demo(1))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


@pytest.mark.parametrize('kind', ['faster', 'mask', 'retina'])
def test_simple_test(kind):
    det, variables, port = twin(kind)
    assert type(port).__name__ == {'faster': 'FasterRCNN', 'mask': 'MaskRCNN',
                                   'retina': 'PISARetinaNet'}[kind]
    batch = {k: _demo()[k] for k in ('image', 'img_shape', 'ori_shape',
                                     'scale_factor')}
    batch['scale_factor'][1:] = 0.8
    ref = jax.device_get(jax.jit(lambda v, b: det.apply(
        v, b, method='simple_test'))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port.simple_test({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert (ref['det_valid'].sum(1) >= 3).all()
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    scale = np.abs(ref['dets'][..., :4]).max()
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=0,
                               atol=DET_RTOL * scale)
    if kind == 'mask':
        v = ref['det_valid'].astype(bool)
        np.testing.assert_allclose(got['mask_probs'].numpy()[v],
                                   ref['mask_probs'][v], atol=2e-4)


@functools.lru_cache(maxsize=None)
def train_step(kind):
    """One step's logs and gradients on both sides from the same variables
    and draws (the RPN's and the Score-HLR sampler's tables, one for both
    images as JAX's ``vmap`` takes it)."""
    import dynamask_tpu.models.pisa as jpisa
    from dynamask_tpu.models.detectors import parse_losses as jparse
    from dynamask_torch.engine.convert import (_torch_layout, key_hints,
                                               mmdet_key)
    from dynamask_torch.models.detectors import parse_losses
    det, variables, port = twin(kind)
    port = copy.deepcopy(port).double().train()
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in _demo().items()}
    rng = np.random.RandomState(14)
    tables = {n: rng.uniform(size=n).astype(np.float32)
              for n in (N_ANCHORS, G + P)}

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax.enable_x64(True), jax_sampler_priorities(tables), \
            jax_uniform(jpisa, tables):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), variables)
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            v64['params'], v64.get('batch_stats', {}),
            {k: jnp.asarray(x) for k, x in batch.items()})
        jax_log, jax_grads = jax.device_get((jax_log, jax_grads))
    noise = {'rpn': torch.from_numpy(np.tile(tables[N_ANCHORS], (2, 1))),
             'rcnn': torch.from_numpy(np.tile(tables[G + P], (2, 1)))}
    with counted_crops() as crops:
        total, log = parse_losses(port.forward_train(
            {k: torch.from_numpy(x) for k, x in batch.items()}, noise))
        total.backward()
    got = _port_grads(port)
    hints = key_hints(port)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k, **hints))
           for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax_log.items()}, got, ref,
            dict(crops))


LOSSES = {'faster': {'loss_cls', 'loss_bbox', 'loss_carl', 'acc'},
          'mask': {'loss_cls', 'loss_bbox', 'loss_carl', 'acc', 'loss_mask'},
          'retina': {'loss_cls', 'loss_bbox', 'loss_carl'}}


@pytest.mark.parametrize('kind', ['faster', 'mask', 'retina'])
def test_train_step(kind):
    """Every loss and every parameter's gradient within ``STEP_TOL`` of
    JAX's in float64, the draws injected."""
    loss_rtol, grad_rl2 = STEP_TOL[kind]
    got, ref, grads, ref_grads, _ = train_step(kind)
    rpn = set() if kind == 'retina' else {'loss_rpn_cls', 'loss_rpn_bbox'}
    keys = {k for k in ref if 'loss' in k or k.endswith('acc')}
    assert keys == LOSSES[kind] | rpn | {'loss'}
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], ref[k], rtol=loss_rtol,
                                   atol=1e-12, err_msg=k)
    for k in LOSSES[kind] - {'acc'}:
        assert ref[k] > 0, k
    norms = {k: np.linalg.norm(v) for k, v in ref_grads.items()}
    floor = GRAD_FLOOR * max(norms.values())
    worst = max((np.linalg.norm(grads[k] - r) / max(norms[k], floor), k)
                for k, r in ref_grads.items())
    assert worst[0] < grad_rl2, worst


@pytest.mark.parametrize('kind,calls', [('faster', (1, 2, 1)),
                                        ('mask', (2, 3, 2))])
def test_crop_calls_per_path(kind, calls):
    """K2 an image; a step's K2 / K4: the Score-HLR pass over every
    candidate of the batch is one crop forward without a backward (JAX's
    ``stop_gradient``), then the sampled box crop (and the mask crop) with
    theirs."""
    _, _, port = twin(kind)
    infer, k2, k4 = calls
    batch = _demo(1)
    with counted_crops() as counts, torch.no_grad():
        port.simple_test({k: torch.from_numpy(batch[k]) for k in
                          ('image', 'img_shape', 'scale_factor')})
    assert counts == {'fwd': infer, 'bwd': 0}
    assert train_step(kind)[4] == {'fwd': k2, 'bwd': k4}
