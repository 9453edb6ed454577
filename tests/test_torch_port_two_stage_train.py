"""The training step of the two-stage family's toy twins on the CPU
(``tests/test_torch_port_two_stage_twins.py``'s GN+WS Mask R-CNN, GRoIE
Mask R-CNN and Double-Head Faster R-CNN): the port's ``forward_train``
against the JAX package's, from the same variables and batch, with the
sampler draws injected on both sides (``rpn`` the anchors' table,
``rcnn`` the G + P candidates'): every loss, and every parameter's
gradient through the port's key map.

Tolerances as the other twins: losses 1e-4 relative; gradients 1e-3
relative L2.
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

from test_torch_port_cascade import _demo, _port_grads  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa
from test_torch_port_train_slice import rel_l2  # noqa: E402
from test_torch_port_two_stage_twins import (G, KINDS, MASKED,  # noqa: E402
                                             N_ANCHORS, P, twin)

LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3


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
    batch = _demo()
    rng = np.random.RandomState(14)
    tables = {n: rng.uniform(size=n).astype(np.float32)
              for n in (N_ANCHORS, G + P)}

    def loss_fn(params, stats, b):
        losses, _ = det.apply({'params': params, 'batch_stats': stats}, b,
                              method='forward_train',
                              rngs={'sampling': jax.random.PRNGKey(0)},
                              mutable=['batch_stats'])
        return jparse(losses)

    with jax_sampler_priorities(tables):
        (_, jax_log), jax_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            variables['params'], variables.get('batch_stats', {}),
            {k: jnp.asarray(x) for k, x in batch.items()})
    total, log = parse_losses(port.forward_train(
        {k: torch.from_numpy(x) for k, x in batch.items()},
        {'rpn': torch.from_numpy(tables[N_ANCHORS][None]),
         'rcnn': torch.from_numpy(tables[G + P][None])}))
    total.backward()
    got = _port_grads(port)
    jax_grads = jax.device_get(jax_grads)
    ref = {k: _torch_layout(jax_grads, {}, *mmdet_key(k)) for k in got}
    return ({k: float(v.detach()) for k, v in log.items()},
            {k: float(v) for k, v in jax.device_get(jax_log).items()},
            got, ref)


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    """Every loss key of the step within 1e-4 of JAX's, the sampler
    draws injected; the mask and box losses non-zero."""
    port_log, jax_log, _, _ = train_step(kind)
    keys = {k for k in jax_log if 'loss' in k or k.endswith('acc')}
    want = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss', 'loss_cls',
            'loss_bbox', 'acc'} | ({'loss_mask'} if kind in MASKED else set())
    assert keys == want and keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert jax_log['loss_bbox'] > 0 and jax_log.get('loss_mask', 1) > 0


@pytest.mark.parametrize('kind', KINDS)
def test_per_leaf_gradients(kind):
    """Every parameter within 1e-3 relative L2 of JAX's gradient; a leaf
    JAX leaves without one has none in the port; the GroupNorms, the
    shared convs and Double-Head's two branches get some."""
    _, _, got, ref = train_step(kind)
    compared = 0
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
            continue
        assert rel_l2(got[k], ref[k]) < GRAD_RL2, (k, rel_l2(got[k], ref[k]))
        compared += 1
    heads = [k for k in ref if re.match(r'^(neck|roi_head)\.', k)]
    assert all(ref[k].any() for k in heads), [k for k in heads
                                              if not ref[k].any()]
    if kind == 'gn':
        assert sum('.gn.' in k for k in heads) == 2 * (8 + 4 + 2)
    if kind == 'dh':
        assert {k.split('.')[2] for k in heads if 'bbox_head' in k} == {
            'res_block', 'conv_branch', 'fc_branch', 'fc_cls', 'fc_reg'}
    assert compared >= 60, compared
