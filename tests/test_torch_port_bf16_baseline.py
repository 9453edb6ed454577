"""bf16 on the BASELINE.json DynaMask configurations beside the flagship and
on HRNet, the port against the JAX package in bf16 on the CPU, with the
flagship's tolerances and the harness of
``tests/test_torch_port_bf16_families.py``:

- ``configs/dynamask/lvis/r50_dynamask_lvis_1x.py``: the toy DynaMask with
  the LVIS head (``tests/test_torch_port_lvis_cityscapes.py:lvis_toy_cfg``:
  1203 classes, ``score_thr=1e-4``, 300 det slots);
- ``configs/dynamask/cityscapes/r50_dynamask_cityscapes_1x.py``: the
  flagship with 8 classes on a 1:2 canvas and batch 1, as the toy DynaMask
  (8 classes) on a 64x128 image;
- ``configs/hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py``: the toy Mask R-CNN on
  HRNet + HRFPN of ``tests/test_torch_port_item8_detectors.py``, whose
  BatchNorms stay frozen (3aj's ``norm_eval`` default) under the bf16
  cast.

Both DynaMask configurations test in the faithful mode (their test_cfg
sets no ``dynamic_inference``); the flagship's own bf16 tests hold the
routed one. ``configs/dynamask/coco/r101_dynamask_3x.py`` differs from the
flagship only in depth and runs in bf16 on the card alone.
"""

import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_bf16_families import (  # noqa: E402
    BOX_LOSSES, G, P, RPN_LOSSES, check_make_test_fn, check_stages,
    check_step, family_step, jax_bf16, rpn_rcnn_noise,
    sampler_tables, twin_family)
from test_torch_port_modules import randomize_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa

CITY_CANVAS = (64, 128)     # the Cityscapes canvas' 1:2, at toy scale
DYNAMASK_LOSSES = RPN_LOSSES | BOX_LOSSES | {'loss_masks', 'loss_flops'}
# HRFPN's P6 and the RPN's scores and deltas on it, in the flattened
# stages (5 levels, 5 score maps, 5 delta maps, the box head's two): JAX
# averages P6's 16x16 windows in bf16 (3bw), so they are held to JAX's fp32
# stages on the same bf16-rounded image
HRFPN_P6_LEAVES = (4, 9, 14)


def _anchors(h, w):
    return 3 * sum((h // s) * (w // s) for s in (4, 8, 16, 32, 64))


@functools.lru_cache(maxsize=None)
def dynamask_twin(name):
    """(JAX toy, its randomised variables, the port, the batch) of 'lvis'
    or 'cityscapes'."""
    from test_dynamask import dynamask_toy_cfg
    from test_models import demo_batch
    from test_torch_port_lvis_cityscapes import lvis_toy_cfg
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = lvis_toy_cfg() if name == 'lvis' else dynamask_toy_cfg()
    h, w = (64, 64) if name == 'lvis' else CITY_CANVAS
    batch = {k: np.array(v) for k, v in demo_batch(0, b=1, h=h, w=w, g=G,
                                                   s=16).items()}
    det = jax_build(*cfg)
    variables = randomize_variables(jax.jit(det.init)(
        {'params': jax.random.PRNGKey(0)}, batch))
    port = build_detector(*cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port, batch


@functools.lru_cache(maxsize=None)
def family(name):
    """LVIS ('lvis'), Cityscapes ('cityscapes'), HRNet ('hrnet')."""
    if name == 'hrnet':
        from test_torch_port_cascade import _demo
        from test_torch_port_item8_detectors import twin
        tables = sampler_tables()
        return twin_family(*twin('hrnet'), _demo(), _demo(), 'rpn',
                           lambda: jax_sampler_priorities(tables),
                           rpn_rcnn_noise(tables),
                           RPN_LOSSES | BOX_LOSSES | {'loss_mask'},
                           fp32_leaves=HRFPN_P6_LEAVES)
    from test_torch_port_train_slice import jax_draws
    det, variables, port, batch = dynamask_twin(name)
    h, w = batch['image'].shape[1:3]
    rng = np.random.RandomState(12)
    noise = {'rpn': rng.uniform(size=(1, _anchors(h, w))).astype(
                 np.float32),
             'rcnn': rng.uniform(size=(1, G + P)).astype(np.float32),
             'gumbel': rng.uniform(1e-4, 1 - 1e-4, (8, 4)).astype(
                 np.float32)}
    return twin_family(det, variables, port, batch, batch, 'rpn',
                       lambda: jax_draws(noise), noise, DYNAMASK_LOSSES,
                       canvas=(h, w))


@functools.lru_cache(maxsize=None)
def jax_of(name):
    return jax_bf16(family(name))


def outputs_of(name):
    return jax_of(name)[0]


@functools.lru_cache(maxsize=None)
def step_of(name):
    return family_step(family(name), jax_of(name)[1])


FAMILIES = ['lvis', 'cityscapes', 'hrnet']


@pytest.mark.parametrize('name', FAMILIES)
def test_bf16_stages_match_jax(name):
    """The levels (HRFPN's from HRNet's four branches), the RPN maps and
    the box head on JAX's RoIs (LVIS: 1204 logits a RoI over 300 dets),
    port bf16 against JAX bf16, each within STAGE_RL2 relative L2 and of
    JAX's type; HRFPN's P6 and the RPN maps on it against JAX's fp32
    stages on the same bf16-rounded image (3bw)."""
    f = family(name)
    check_stages(f.port, f.test_batch, f.stages, outputs_of(name),
                 f.fp32_leaves)


@pytest.mark.parametrize('name', FAMILIES)
def test_make_test_fn_bf16_matches_jax(name):
    """``make_test_fn(bf16=True)`` on JAX's injected dets (LVIS: 300 slots
    over 1203 classes; Cityscapes: the 64x128 canvas): the mask
    probabilities and the pasted masks against JAX's in bf16."""
    f = family(name)
    if name == 'lvis':
        assert outputs_of(name)[1]['valid'].sum() == 300
    check_make_test_fn(f.port, f.test_batch, outputs_of(name),
                       inject=f.inject, canvas=f.canvas)


@pytest.mark.parametrize('name', FAMILIES)
def test_bf16_step_losses_match_jax(name):
    """The bf16 step against JAX's bf16 step function on JAX's training
    proposals with the same sampler draws and Gumbel uniforms: every loss
    within LOSS_RTOL_JAX, the accuracy equal, fp32 masters and gradients;
    HRNet's frozen BatchNorms (``norm_eval``, 3aj) keep their running
    statistics through the bf16 step, fp32."""
    got, ref, net = step_of(name)
    check_step(got, ref, net, family(name).losses)
    if name == 'hrnet':
        before = family(name).port.state_dict()
        after = net.state_dict()
        stats = [k for k in before if k.startswith('backbone.') and
                 k.endswith(('running_mean', 'running_var'))]
        assert len(stats) > 20
        for k in stats:
            assert after[k].dtype == torch.float32
            assert torch.equal(after[k], before[k]), k


def test_hrfpn_pool_sums_in_bf16_3bw():
    """3bw: JAX's HRFPN pools its pyramid with ``layers.avg_pool`` (flax's
    ``avg_pool``: a ``reduce_window`` sum in the input's type), so in bf16
    each of P6's 16x16-window means is a bf16 running sum of 256 values;
    the port's ``F.avg_pool2d`` sums in fp32 and rounds once. On a bf16
    map, JAX's mean lies several bf16 ulps from the exact mean of the same
    bf16 values, the port's within one."""
    import jax.numpy as jnp
    import torch.nn.functional as F
    from dynamask_tpu.models.layers import avg_pool
    from test_torch_port_bf16 import BF16_ULP, _f32, _rel_err
    rng = np.random.RandomState(21)
    x = jnp.asarray(rng.randn(2, 32, 48, 16).astype(np.float32) + 0.5
                    ).astype(jnp.bfloat16)
    exact = avg_pool(x.astype(jnp.float32), 16, 16)
    ref = avg_pool(x, 16, 16)
    got = F.avg_pool2d(torch.from_numpy(_f32(x).copy()).bfloat16().permute(
        0, 3, 1, 2), 16, 16).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == 'bfloat16'
    assert _rel_err(got, exact) <= BF16_ULP
    assert _rel_err(ref, exact) > 4 * BF16_ULP


def test_dyna_mask_loss_saturates_in_bf16_3by():
    """3by: JAX's ``dyna_mask_loss`` takes the detail loss's
    ``log(max(1 - sigmoid(x), 1e-10))`` in the logits' type. On bf16
    logits the sigmoid is exactly 1 from x ~ 6.25 (XLA's CPU logistic from
    x ~ 5.56), and the term clamps to log(1e-10) = -23 where fp32 gives
    about -x. At a logit spread like full-width random weights' (6 here)
    JAX's bf16 mask loss lies tens of percent from the same loss on the
    same logits cast to fp32. The port keeps JAX's function: its bf16 loss
    is JAX's within LOSS_RTOL_JAX where the two sigmoids saturate alike
    (no logit in the band between the two saturation points), its fp32
    loss JAX's fp32 one."""
    import jax.numpy as jnp
    from dynamask_torch.models.dynamask_roi_head import (
        dyna_mask_loss as port_loss)
    from dynamask_tpu.models.dynamask_roi_head import (
        dyna_mask_loss as jax_loss)
    from test_torch_port_bf16 import LOSS_RTOL_JAX
    rng = np.random.RandomState(22)
    r, sizes = 8, (14, 28, 56, 112)
    full = np.zeros((r, 112, 112), np.float32)
    for i in range(r):
        y0, x0 = rng.randint(0, 56, 2)
        full[i, y0:y0 + rng.randint(20, 56), x0:x0 + rng.randint(20, 56)] = 1
    targets = [full[:, ::112 // s, ::112 // s] for s in sizes]

    def logits(s):
        x = 6 * rng.randn(r, s, s, 1)
        # out of the band where only XLA's sigmoid saturates
        return np.where((x > 5.4) & (x < 6.4), 7.0, x).astype(np.float32)
    inst = [logits(s) for s in sizes]
    det = [logits(s) for s in sizes]
    labels = np.eye(4, dtype=np.float32)[rng.randint(0, 4, r)]
    valid = np.arange(r) < 6
    fuse = np.array([0.6, 0.4], np.float32)

    def run_jax(dtype):
        return float(jax_loss(
            [jnp.asarray(x).astype(jnp.bfloat16).astype(dtype) for x in inst],
            [jnp.asarray(x).astype(jnp.bfloat16).astype(dtype) for x in det],
            [jnp.asarray(t) for t in targets], jnp.asarray(labels),
            jnp.asarray(valid), jnp.asarray(fuse))['loss_masks'])

    def run_port(dtype):
        def nchw(x):
            return torch.from_numpy(x).bfloat16().to(dtype).permute(
                0, 3, 1, 2)
        return float(port_loss(
            [nchw(x) for x in inst], [nchw(x) for x in det],
            [torch.from_numpy(t) for t in targets], torch.from_numpy(labels),
            torch.from_numpy(valid), torch.from_numpy(fuse))['loss_masks'])

    j16, j32 = run_jax(jnp.bfloat16), run_jax(jnp.float32)
    p16, p32 = run_port(torch.bfloat16), run_port(torch.float32)
    assert j16 > 1.2 * j32 > 0, (j16, j32)
    assert abs(p16 - j16) <= LOSS_RTOL_JAX * abs(j16), (p16, j16)
    assert abs(p32 - j32) <= 1e-4 * abs(j32), (p32, j32)
    # the two saturation points
    x = np.arange(5.0, 7.0, 1 / 64, dtype=np.float32)
    jsat = np.asarray(jax.nn.sigmoid(jnp.asarray(x).astype(jnp.bfloat16)
                                     ).astype(jnp.float32)) == 1
    tsat = torch.sigmoid(torch.from_numpy(x).bfloat16()).float().numpy() == 1
    assert 5.4 < x[jsat.argmax()] < x[tsat.argmax()] < 6.4
