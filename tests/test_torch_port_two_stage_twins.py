"""Toy twins of the two-stage family's options on the CPU: the PyTorch
port's detectors against the JAX package's on the same seeded inputs, the
JAX weights carried across by ``dynamask_torch.engine.convert``; where JAX
reaches RoIAlign it runs its XLA form.

- The toys (ResNet-18, 32-channel FPN, 8 classes, 64x64, the mini Mask
  R-CNN of ``tests/test_models.py``): GN+WS Mask R-CNN (GN in the
  backbone, FPN and both heads, ConvWS), GRoIE Mask R-CNN and Double-Head
  Faster R-CNN. ``simple_test`` slot for slot with the 28x28 mask
  probabilities; the GN toy in bf16 against JAX in bf16 (``core/fp16.py``'s
  GroupNorm). Their training steps are ``tests/test_torch_port_two_stage_
  train.py``'s.

Tolerances as the other twins: dets ``rtol=1e-5, atol=1e-4``, labels and
validity exact; mask probabilities ``atol=2e-4``; bf16 stages
``STAGE_RL2`` relative L2 (``tests/test_torch_port_bf16.py``).
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

from test_torch_port_cascade import _demo  # noqa: E402
from test_torch_port_modules import randomize_variables  # noqa: E402

MASK_ATOL = 2e-4
N_ANCHORS = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
G, P = 3, 32                 # GTs and RPN proposals of the toy's step


# -- the toy detectors --------------------------------------------------------

GN = dict(type='GN', num_groups=8, requires_grad=True)


def toy_cfg(kind):
    """(model, train_cfg, test_cfg): the mini Mask R-CNN as ``kind``:
    'gn' (gn+ws-all: GN backbone with ConvWS, GN FPN,
    ``Shared4Conv1FCBBoxHead`` and mask head with GN), 'groie' (both
    extractors ``GenericRoIExtractor`` with ``aggregation='sum'``), 'dh'
    (Double-Head Faster R-CNN, the config's loss weights), and for the
    launch counts 'groie_faster', 'giou', 'soft_nms', 'ohem'."""
    from test_models import mini_mask_rcnn_cfg
    model, train_cfg, test_cfg = copy.deepcopy(mini_mask_rcnn_cfg())
    rh = model['roi_head']
    bbox = rh['bbox_head']
    if kind in ('dh', 'groie_faster', 'giou', 'soft_nms', 'ohem'):
        model['type'] = 'FasterRCNN'
        rh['mask_head'] = rh['mask_roi_extractor'] = None
    if kind == 'gn':
        model['backbone'].update(norm_cfg=GN, conv_cfg=dict(type='ConvWS'))
        model['neck']['norm_cfg'] = GN
        bbox.update(type='Shared4Conv1FCBBoxHead', conv_out_channels=32,
                    norm_cfg=GN)
        rh['mask_head']['norm_cfg'] = GN
    elif kind in ('groie', 'groie_faster'):
        for ext in ('bbox_roi_extractor', 'mask_roi_extractor'):
            if rh[ext]:
                rh[ext].update(type='GenericRoIExtractor', aggregation='sum')
    elif kind == 'dh':
        rh.update(type='DoubleHeadRoIHead', reg_roi_scale_factor=1.3)
        rh['bbox_head'] = dict(
            type='DoubleConvFCBBoxHead', num_convs=2, num_fcs=2,
            in_channels=32, conv_out_channels=64, fc_out_channels=64,
            roi_feat_size=7, num_classes=8, bbox_coder=bbox['bbox_coder'],
            reg_class_agnostic=False,
            loss_cls=dict(type='CrossEntropyLoss', use_sigmoid=False,
                          loss_weight=2.0),
            loss_bbox=dict(type='SmoothL1Loss', beta=1.0, loss_weight=2.0))
    elif kind == 'giou':
        bbox.update(reg_decoded_bbox=True,
                    loss_bbox=dict(type='GIoULoss', loss_weight=10.0))
    elif kind == 'soft_nms':
        test_cfg['rcnn']['nms'] = dict(type='soft_nms', iou_threshold=0.5)
    elif kind == 'ohem':
        train_cfg['rcnn']['sampler']['type'] = 'OHEMSampler'
    return model, train_cfg, test_cfg


@functools.lru_cache(maxsize=None)
def twin(kind):
    """(JAX toy detector, its randomised variables, the port loaded from
    them)."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    det = jax_build(*cfg)
    batch = {k: jnp.asarray(v) for k, v in _demo().items()}
    variables = randomize_variables(
        jax.jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port


KINDS = ['gn', 'groie', 'dh']
MASKED = {'gn', 'groie'}


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    """Dets, labels, validity and (Mask R-CNNs) 28x28 mask probabilities
    slot for slot, two images with a non-unit scale factor."""
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
    for i in range(2):
        assert ref['det_valid'][i].sum() >= 4
        scores = ref['dets'][i, ref['det_valid'][i].astype(bool), 4]
        assert np.min(np.abs(np.diff(np.sort(scores)))) > 1e-6, 'ties'
    np.testing.assert_array_equal(got['det_valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    assert ('mask_probs' in got) == ('mask_probs' in ref) == (kind in MASKED)
    if kind in MASKED:
        probs = got['mask_probs'].numpy()
        assert probs.shape == (2, 8, 28, 28) and probs.std() > 1e-2
        np.testing.assert_allclose(probs, ref['mask_probs'], atol=MASK_ATOL)


def test_gn_toy_in_bf16_matches_jax():
    """The GN toy in bf16 against JAX in bf16 (``core/fp16.py``): the FPN
    levels, RPN maps and the box head on JAX's proposals within
    ``STAGE_RL2``; every GroupNorm normalises in fp32 and rounds once, as
    flax's does under the policy."""
    from test_torch_port_bf16 import STAGE_RL2, _batch, _jax_stages, _rel_l2
    from dynamask_torch.core.fp16 import to_bf16
    det, variables, port = twin('gn')
    image = _batch()['image']
    feats, cls, reg, rois, rb, logits, deltas = _jax_stages(det, variables,
                                                            image)
    p16 = to_bf16(port)
    with torch.no_grad():
        tfeats = p16.extract_feat(p16.images(
            {'image': torch.from_numpy(image).bfloat16()}))
        tcls, treg = p16.rpn_head(tfeats)
        tlog, tdel = p16.roi_head._bbox_forward(
            tfeats, torch.from_numpy(np.array(rois)),
            torch.from_numpy(np.array(rb)).long())
    nhwc = (lambda t: t.permute(0, 2, 3, 1))
    pairs = ([(nhwc(a), b) for a, b in zip(tfeats, feats)] +
             [(nhwc(a), b) for a, b in zip(tcls, cls)] +
             [(nhwc(a), b) for a, b in zip(treg, reg)] +
             [(tlog, logits), (tdel, deltas)])
    for i, (got, ref) in enumerate(pairs):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, i
        assert _rel_l2(got, ref) <= STAGE_RL2, i
    gn = p16.neck.fpn_convs[0].gn
    x = torch.randn(2, 32, 5, 5).bfloat16()
    want = torch.nn.functional.group_norm(
        x.float(), 8, gn.weight.float(), gn.bias.float(), 1e-6).bfloat16()
    assert torch.equal(gn(x), want)
