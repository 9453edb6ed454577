"""bf16 on the families whose DCNs run K1/K3 on whole maps and on the
point heads, the port against the JAX package in bf16 on the CPU, with
the flagship's tolerances and the harness of
``tests/test_torch_port_bf16_families.py``: GA-Faster R-CNN and
GA-RetinaNet (``FeatureAdaption``'s windowed DCN on every FPN level in 4
deform groups), the DetectoRS cascade (SAC's deformable convs at dilation
1 and 3 in both backbone passes, from randomised offset convs) and the
reference's own PointRefine, each on its family test's own toy and draws.

The stages (the levels, the RPN or dense head's four maps: scores, deltas,
shapes and locations, each box head on JAX's RoIs), ``make_test_fn(...,
bf16=True)`` with JAX's dets injected (the mask families) and the bf16
step against JAX's bf16 step function on JAX's training proposals (the
GA-RPN's, recorded from inside JAX's step: the location filter's decision
at ``loc_filter_thr`` comes with them), with the shape sampler's draws
given to both sides as ``tests/test_torch_port_guided_anchor.py`` gives
them.

SAC alone (``test_sac_bf16_matches_jax``): one deformable ``SAConv`` in
bf16 on both sides, and from zero offsets its exact-zero offset gradient
in bf16 (3f).
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

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_bf16_families import (  # noqa: E402
    BOX_LOSSES, G, N_ANCHORS, RPN_LOSSES, STAGE_RL2, check_make_test_fn,
    check_stages, check_step, family_step, jax_bf16,
    injected_cascade_dets, rpn_rcnn_noise, sampler_tables, twin_family)
from test_torch_port_bf16 import _f32, _rel_l2  # noqa: E402
from test_torch_port_train_modules import jax_sampler_priorities  # noqa


@functools.lru_cache(maxsize=None)
def family(name):
    """GA-Faster ('ga_faster'), GA-RetinaNet ('ga_retina'), the DetectoRS
    cascade ('sac'), PointRefine ('point_refine')."""
    if name.startswith('ga_'):
        from test_torch_port_guided_anchor import (GA_SAMPLES, P, _demo,
                                                   ga_draws, n_squares, twin)
        kind = 'faster' if name == 'ga_faster' else 'retina'
        det, variables, port = twin(kind)
        det = det.clone(ga_sample_num=GA_SAMPLES)
        port = _with_samples(port, GA_SAMPLES)
        na = n_squares(kind)
        rng = np.random.RandomState(15)
        ga = [np.stack([r, 1 - r]).astype(np.float32)
              for r in (rng.uniform(size=na), rng.uniform(size=na))]
        tables = {n: rng.uniform(size=n).astype(np.float32)
                  for n in (na, G + P)}
        noise = {'ga_pos': ga[0], 'ga_neg': ga[1],
                 'rpn': np.stack([tables[na]] * 2),
                 'rcnn': np.stack([tables[G + P]] * 2)}

        def draws():
            stack = contextlib.ExitStack()
            stack.enter_context(ga_draws(*ga))
            stack.enter_context(jax_sampler_priorities(tables))
            return stack
        losses = ({'loss_cls', 'loss_bbox', 'loss_shape', 'loss_loc'}
                  if kind == 'retina' else
                  RPN_LOSSES | BOX_LOSSES | {'loss_anchor_shape',
                                             'loss_anchor_loc'})
        return twin_family(det, variables, port, _demo(), _demo(2),
                           'dense' if kind == 'retina' else 'rpn', draws,
                           noise, losses)
    if name == 'sac':
        from test_torch_port_cascade import _demo, _tables, port_noise
        from test_torch_port_detectors_rs import twin
        tables = _tables()
        return twin_family(*twin(), _demo(), _demo(), 'cascade',
                           lambda: jax_sampler_priorities(tables),
                           {k: v.numpy() for k, v in
                            port_noise(tables).items()}, None,
                           injected_cascade_dets)
    if name == 'point_refine':
        from test_torch_port_item9_detectors import _batch, toy_cfg, twin
        p = toy_cfg(name)[1]['rpn_proposal']['max_num']
        tables = sampler_tables(counts=(N_ANCHORS, G + p))
        noise = dict(rpn_rcnn_noise(tables, candidates=G + p),
                     rcnn_grid=tables[G + p][None])
        batch = _batch(semantic=True)
        return twin_family(*twin(name), batch, batch, 'rpn',
                           lambda: jax_sampler_priorities(tables), noise,
                           RPN_LOSSES | BOX_LOSSES | {'loss_instance',
                                                      'loss_semantic'})
    raise KeyError(name)


def _with_samples(port, n):
    """A copy of the GA port whose shape sampler keeps ``n`` squares an
    image, as the JAX toy's ``clone(ga_sample_num=n)``."""
    port = copy.deepcopy(port)
    port.ga_sample_num = n
    return port


@functools.lru_cache(maxsize=None)
def jax_of(name):
    return jax_bf16(family(name))


def outputs_of(name):
    return jax_of(name)[0]


@functools.lru_cache(maxsize=None)
def step_of(name):
    return family_step(family(name), jax_of(name)[1])


FAMILIES = ['ga_faster', 'ga_retina', 'sac', 'point_refine']
MASKED = ['sac', 'point_refine']


@pytest.mark.parametrize('name', FAMILIES)
def test_bf16_stages_match_jax(name):
    """The levels (SAC's through both backbone passes and the RFP), the
    RPN's or the dense head's maps (GA: after ``FeatureAdaption``'s DCN in
    4 groups on every level), each box head on JAX's RoIs, port bf16
    against JAX bf16, each within STAGE_RL2 relative L2 and of JAX's
    type."""
    f = family(name)
    check_stages(f.port, f.test_batch, f.stages, outputs_of(name),
                 f.fp32_leaves)


@pytest.mark.parametrize('name', MASKED)
def test_make_test_fn_bf16_matches_jax(name):
    """``make_test_fn(bf16=True)`` on JAX's injected dets: the mask
    probabilities (the DetectoRS cascade's mean of three stages'; the
    PointRefine head's, its top-k points chosen on each side's bf16 detail
    map) and the pasted masks against JAX's in bf16."""
    f = family(name)
    check_make_test_fn(f.port, f.test_batch, outputs_of(name),
                       inject=f.inject)


@pytest.mark.parametrize('name', FAMILIES)
def test_bf16_step_losses_match_jax(name):
    """The bf16 step against JAX's bf16 step function with the family's
    draws (GA's shape sampler's too), on JAX's training proposals where
    the detector has an RPN: every loss within LOSS_RTOL_JAX, the accuracy
    equal, fp32 masters and gradients."""
    got, ref, net = step_of(name)
    check_step(got, ref, net, family(name).losses)


# -- SAC alone ------------------------------------------------------------------

def _jax_sac_params(port):
    """The JAX ``SAConv``'s parameters of the port's module (the inverse
    of ``load_sac``)."""
    from test_torch_port_detectors_rs import SAC_LEAVES

    def hwio(t):
        return t.detach().numpy().transpose(2, 3, 1, 0)

    params = {'weight': hwio(port.weight),
              'weight_diff': hwio(port.weight_diff)}
    for name in SAC_LEAVES:
        conv = getattr(port, name, None)
        if conv is not None:
            params[name] = {'kernel': hwio(conv.weight),
                            'bias': conv.bias.detach().numpy()}
    return params


@functools.lru_cache(maxsize=None)
def _jax_sac_bf16():
    """The JAX stride-1 deformable ``SAConv`` and its jitted bf16 VJP."""
    from dynamask_tpu.models.detectors_resnet import SAConv as JSAC
    from test_torch_port_detectors_rs import SAC_KINDS
    stride, deform, groups = SAC_KINDS['stride1_deform']
    m = JSAC(8, stride=stride, use_deform=deform, groups=groups)

    @jax.jit
    def vjp(params, x, cot):
        out, back = jax.vjp(lambda p, x_: m.apply({'params': p}, x_), params,
                            x)
        return out, back(cot)
    return vjp


@pytest.mark.parametrize('zero_offsets', [False, True])
def test_sac_bf16_matches_jax(zero_offsets):
    """The stride-1 deformable ``SAConv`` (both branches, dilations 1 and
    3) in bf16 on both sides, from the same bf16 parameters and input: the
    output within STAGE_RL2 of JAX's, both bf16, the weight standardisation
    of bf16 weights reduced in the same type on both sides (the outputs
    would part otherwise); the input gradient bf16 and finite. (One SAConv's
    bf16 gradients lie 0.06-0.12 relative L2 from the fp32 gradient of the
    same bf16 inputs on either side, the two roundings independent, so
    they are not held to each other.) From zero offsets (the init) both
    offset convs get exactly zero gradient on both sides in bf16 too
    (3f)."""
    from dynamask_tpu.core.fp16 import to_bf16 as jto
    from dynamask_torch.core.fp16 import to_bf16
    from test_torch_port_detectors_rs import sac_pair
    x, cot, _, _, port = sac_pair('stride1_deform', zero_offsets)
    params = jto(jax.tree_util.tree_map(jnp.asarray, _jax_sac_params(port)))
    jx, jc = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, cot))
    ref, (gp, gx) = _jax_sac_bf16()(params, jx, jc)
    p16 = to_bf16(port)
    xt = torch.from_numpy(_f32(jx).copy()).bfloat16().permute(0, 3, 1, 2)
    xt.requires_grad_()
    out = p16(xt)
    out.backward(torch.from_numpy(_f32(jc).copy()).bfloat16().permute(
        0, 3, 1, 2))
    got = out.permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == 'bfloat16'
    assert _rel_l2(got, ref) <= STAGE_RL2, _rel_l2(got, ref)
    assert xt.grad.dtype == torch.bfloat16 and str(gx.dtype) == 'bfloat16'
    assert torch.isfinite(xt.grad).all()
    for name in ('offset_s', 'offset_l'):
        g = p16.get_submodule(name).weight.grad
        r = _f32(gp[name]['kernel'])
        assert g.dtype == torch.bfloat16
        if zero_offsets:
            assert not _f32(g).any() and not r.any(), name
        else:
            assert np.abs(r).max() > 0 and _f32(g).any(), name
