"""The training slice on the CPU: ``forward_train``, the backward pass and
SGD steps of the PyTorch port against the JAX package's training step, at
the toy DynaMask config (ResNet-18, 32-channel FPN, 8 classes) on
``demo_batch(0, b=1, h=64, w=64, g=3, s=16)``.

Both sides start from the same randomised variables (every zero-initialised
leaf drawn, so the DCN offsets are off the integer grid and carry
gradient), and get the same random draws: the RPN and RoI sampler
priorities and the Gumbel uniforms. On the JAX side the test swaps, for the
call only, the sampler module's ``jax`` name and
``dynamask_tpu.models.dynamask_roi_head.gumbel_softmax`` for ones that
return those draws; the JAX package is not changed. The port's gradients go
through ``dynamask_tpu.engine.pretrained.convert_torch_weights`` (gradients
have the weights' layouts) and are compared leaf by leaf.

Tolerances: the two sides sum in other orders in fp32 through a ResNet, an
FPN, RoIAlign and the DCN cascade; losses agree to ~1e-6 relative (1e-4
allowed) and per-leaf gradients to ~1e-5 relative L2, the DCN offset convs
to ~1.5e-4 (1e-3 allowed). Leaves with no gradient in JAX (the frozen stages)
must have none in the port either; the two MSM conv biases, whose gradient
a batch-statistics BatchNorm cancels, must be cancelled on both sides.
"""

import contextlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import _toy_variables  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa

LOSS_RTOL = 1e-4
GRAD_RL2 = 1e-3
# Two steps: the toy's MSM gradients reach ~1e5, against <= 22 elsewhere (a
# stage that no RoI is routed to divides its detail loss by n_routed + 1e-5,
# and the straight-through one-hot passes that on), so fp32 noise grows
# fast. After two steps the parameters agree to ~4e-5 relative L2; in a third
# step the losses jump on both sides (15.1 -> 9.5) and differ by ~2e-4.
STEPS = 2
LR = 0.01


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@contextlib.contextmanager
def jax_draws(noise):
    """The JAX training step takes ``noise``'s sampler priorities and
    Gumbel uniforms."""
    import dynamask_tpu.models.dynamask_roi_head as jrh
    jg = jrh.gumbel_softmax
    tables = {noise[k].shape[-1]: noise[k][0] for k in ('rpn', 'rcnn')}
    jrh.gumbel_softmax = (lambda rng, logits, temperature=0.5, hard=True:
                          jg(None, logits, temperature, hard,
                             u=jnp.asarray(noise['gumbel'])))
    try:
        with jax_sampler_priorities(tables):
            yield
    finally:
        jrh.gumbel_softmax = jg


class Twins:
    """The JAX detector with its optax state and the port with its
    optimizer, stepped together on one batch with one set of draws."""

    def __init__(self):
        from test_dynamask import dynamask_toy_cfg
        from test_models import demo_batch
        from dynamask_tpu.engine.optimizer import (build_optimizer,
                                                   step_lr_schedule)
        from dynamask_tpu.models import build_detector as jax_build
        from dynamask_tpu.models.detectors import parse_losses as jparse
        from dynamask_torch.engine import (DetectorSGD, load_jax_variables,
                                           make_train_step)
        from dynamask_torch.engine import step_lr_schedule as tsched
        from dynamask_torch.models import build_detector

        model, train_cfg, test_cfg = dynamask_toy_cfg()
        self.det = jax_build(model, train_cfg, test_cfg)
        self.variables = _toy_variables()
        self.port = build_detector(model, train_cfg, test_cfg, device='cpu')
        load_jax_variables(self.port, self.variables)
        self.port.train()
        demo = demo_batch(0, b=1, h=64, w=64, g=3, s=16)
        self.batch = {k: np.array(v) for k, v in demo.items()}  # writable
        rng = np.random.RandomState(12)
        n_anchors = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
        self.noise = {
            'rpn': rng.uniform(size=(1, n_anchors)).astype(np.float32),
            'rcnn': rng.uniform(size=(1, 3 + 32)).astype(np.float32),
            'gumbel': rng.uniform(1e-4, 1 - 1e-4, (8, 4)).astype(np.float32)}

        det = self.det

        def loss_fn(params, stats, batch):
            losses, mut = det.apply(
                {'params': params, 'batch_stats': stats}, batch,
                method='forward_train',
                rngs={'sampling': jax.random.PRNGKey(0)},
                mutable=['batch_stats'])
            total, log = jparse(losses)
            return total, (log, mut['batch_stats'])

        self.jax_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        self.tx = build_optimizer(
            self.variables['params'], LR, 0.9, 1e-4, 35.0,
            step_lr_schedule(LR, 10, warmup_iters=0),
            frozen_backbone_prefixes=det.backbone.frozen_param_paths())
        self.opt_state = self.tx.init(self.variables['params'])
        self.opt = DetectorSGD(self.port, LR, 0.9, 1e-4, 35.0,
                               tsched(LR, 10, warmup_iters=0))
        self.port_step = make_train_step(self.port, self.opt)

    def jax_step(self):
        """(log, grads) of one JAX training step, then its SGD update."""
        import optax
        v = self.variables
        with jax_draws(self.noise):
            (_, (log, stats)), grads = self.jax_grad(
                v['params'], v['batch_stats'],
                {k: jnp.asarray(x) for k, x in self.batch.items()})
        upd, self.opt_state = self.tx.update(grads, self.opt_state,
                                             v['params'])
        self.variables = {'params': optax.apply_updates(v['params'], upd),
                          'batch_stats': stats}
        return jax.device_get(log), jax.device_get(grads)

    def port_forward_backward(self):
        from dynamask_torch.models.detectors import parse_losses
        self.opt.zero_grad()
        total, log = parse_losses(self.port.forward_train(
            {k: torch.from_numpy(x) for k, x in self.batch.items()},
            {k: torch.from_numpy(x) for k, x in self.noise.items()}))
        total.backward()
        return {k: v.detach().numpy() for k, v in log.items()}

    def port_grads_as_jax(self, like):
        """The port's gradients (zero where a trainable leaf got none) in
        the JAX tree, through the production weight importer."""
        from dynamask_tpu.engine.pretrained import convert_torch_weights
        sd = {}
        for k, p in self.port.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            sd[k] = g.detach().numpy().copy()
        zeros = jax.tree_util.tree_map(np.zeros_like, like)
        conv, _, report = convert_torch_weights(
            sd, zeros, self.variables['batch_stats'], scope='mmdet')
        assert not report['mismatched'], report['mismatched']
        return conv

    def port_params_as_jax(self):
        from dynamask_tpu.engine.pretrained import convert_torch_weights
        sd = {k: v.detach().numpy().copy()
              for k, v in self.port.state_dict().items()}
        zeros = jax.tree_util.tree_map(np.zeros_like, self.variables)
        params, stats, report = convert_torch_weights(
            sd, zeros['params'], zeros['batch_stats'], scope='mmdet')
        assert not report['mismatched'], report['mismatched']
        return {'params': params, 'batch_stats': stats}


@pytest.fixture(scope='module')
def step0():
    twins = Twins()
    port_log = twins.port_forward_backward()
    port_grads = twins.port_grads_as_jax(twins.variables['params'])
    jax_log, jax_grads = twins.jax_step()
    return twins, port_log, jax_log, port_grads, jax_grads


def test_forward_train_losses(step0):
    _, port_log, jax_log, _, _ = step0
    keys = {k for k in jax_log if 'loss' in k or k == 'acc'}
    assert keys == {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                    'loss_bbox', 'acc', 'loss_masks', 'loss_flops', 'loss'}
    assert keys <= set(port_log)
    for k in sorted(keys):
        np.testing.assert_allclose(port_log[k], jax_log[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert jax_log['loss_bbox'] > 0 and jax_log['loss_masks'] > 0


def test_per_leaf_gradients(step0):
    """Every leaf of the parameter tree; the frozen stem and stage 1 get
    none, the DCN offsets and the MSM get some."""
    _, _, _, port_grads, jax_grads = step0
    got, ref = leaves(port_grads), leaves(jax_grads)
    assert got.keys() == ref.keys()
    # the MSM's conv biases feed BatchNorms on batch statistics, which
    # remove them: their gradient is 0 in exact arithmetic, and what fp32
    # leaves of it is cancellation residue on both sides
    msm_scale = max(float(np.abs(v).max()) for k, v in ref.items()
                    if 'mask_predictor' in k)
    cancelled = [k for k in ref if "['mask_predictor']['conv" in k and
                 k.endswith("['bias']")]
    assert len(cancelled) == 2
    for k in cancelled:
        assert max(np.abs(got[k]).max(), np.abs(ref[k]).max()) < \
            1e-6 * msm_scale, k
    compared = 0
    for k in ref:
        if k in cancelled:
            continue
        if not ref[k].any():          # frozen, or unused by the loss
            assert not got[k].any(), k
            continue
        d = rel_l2(got[k], ref[k])
        compared += 1
        assert d < GRAD_RL2, f'{k}: rel-L2 {d:.2e}'
    assert compared >= 120, compared
    frozen = [k for k in ref if "['backbone']['layer1_" in k or
              "['backbone']['conv1']" in k or "['backbone']['bn1']" in k]
    assert frozen and all(not ref[k].any() and not got[k].any()
                          for k in frozen)
    offs = [k for k in ref if 'conv_offset' in k]
    msm = [k for k in ref if 'mask_predictor' in k]
    assert all(np.abs(ref[k]).max() > 0 for k in offs + msm)


def test_sgd_steps_and_running_stats(step0):
    """STEPS optimizer steps on both sides (clip at 35, momentum, weight
    decay, frozen stages): losses each step, then every parameter and the
    MSM's running statistics."""
    twins = step0[0]
    twins.opt.step()
    for step in range(1, STEPS):
        port_log = twins.port_forward_backward()
        twins.opt.step()
        jax_log, _ = twins.jax_step()
        np.testing.assert_allclose(port_log['loss'], jax_log['loss'],
                                   rtol=LOSS_RTOL, err_msg=f'step {step}')
    got = leaves(twins.port_params_as_jax())
    ref = leaves(twins.variables)
    assert got.keys() == ref.keys()
    for k in ref:
        if not np.abs(ref[k]).max():
            np.testing.assert_array_equal(got[k], ref[k], k)
            continue
        assert rel_l2(got[k], ref[k]) < 1e-4, k
    moved = [k for k in ref if 'conv_offset' not in k and
             not np.array_equal(ref[k], leaves(_toy_variables())[k])]
    assert len(moved) > 100
