"""bf16 on the two-stage families that run the hand kernels, the port
against the JAX package in bf16 on the CPU, as
``tests/test_torch_port_bf16.py`` holds the flagship and with its
tolerances (imported, not restated): RefineMask, the C4 Mask R-CNN,
Cascade Mask R-CNN, HTC with its semantic branch, GRoIE and Double-Head,
each on its family test's own toy and draws.

For each family:

- the continuous stages: the FPN (or C4) levels, the RPN maps, each box
  head (each cascade stage's, HTC's semantic branch) on JAX's RoIs (the
  boxes of JAX's bf16 dets), within STAGE_RL2 relative L2, in the type
  JAX computes each in;
- ``make_test_fn(..., bf16=True)`` with JAX's dets injected (the mask
  families): the mask probabilities against JAX's ``simple_test`` in bf16
  (PROB_*) and the pasted masks against JAX's ``make_test_fn(bf16=True)``
  function wherever JAX's pasted probability is MASK_MARGIN clear of 0.5
  (MASK_AGREE); the dets fp32;
- the training step with ``compute_dtype=torch.bfloat16`` against JAX's
  bf16 step function (``make_train_step``'s cast of the parameters and
  the image, ``forward_train``, ``parse_losses``), from the same variables
  and batch with the family's sampler draws, on JAX's own training
  proposals (recorded from inside JAX's step): every loss within
  LOSS_RTOL_JAX, the accuracy equal; fp32 masters and gradients after it.

JAX's discrete decisions are injected into the port where a slot-for-slot
compare needs them (the dets, the training proposals); the port code is
not changed for it. JAX's side of all three is one jit a family
(``jax_bf16``). The helpers here (``jax_bf16``, ``check_stages``,
``check_make_test_fn``, ``check_step``) serve
``tests/test_torch_port_bf16_dcn_families.py`` and
``tests/test_torch_port_bf16_baseline.py`` too.
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

from test_torch_port_bf16 import (FLIP_SHARE, LOSS_RTOL_JAX,  # noqa: E402
                                  MASK_AGREE, MASK_MARGIN, PROB_ATOL,
                                  PROB_MEAN_ATOL, STAGE_RL2, _f32, _rel_l2,
                                  injected_dets)
from test_torch_port_train_modules import jax_sampler_priorities  # noqa

CANVAS = (64, 64)
TEST_KEYS = ('image', 'img_shape', 'ori_shape', 'scale_factor')
LR = 0.01
N_ANCHORS = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))
G, P = 3, 32                 # the demo batch's GTs, the toys' proposals


def nhwc(t):
    return t.permute(0, 2, 3, 1)


# -- the harness --------------------------------------------------------------

def det_rois(out):
    """JAX's dets as (B * D, 4) RoIs at the input's scale and their image
    indices (JAX arrays inside JAX's jit, numpy outside it)."""
    xp = jnp if isinstance(out['dets'], jnp.ndarray) else np
    b, d = out['dets'].shape[:2]
    rois = out['dets'][..., :4].reshape(b * d, 4)
    return rois, xp.repeat(xp.arange(b, dtype=xp.int32), d)


def jax_rpn_stages(m, b, out):
    """The backbone and neck levels, the RPN maps and the box head on
    JAX's dets (a standard RoI head: its extract, shared head and box
    head)."""
    feats = m.extract_feat(b['image'], train=False)
    rois, rb = det_rois(out)
    return (feats, m.rpn_head(feats, train=False),
            m.roi_head._bbox_forward(feats, rois, rb, train=False))


def port_rpn_stages(p16, bt, rois, rb):
    feats = p16.extract_feat(p16.images(bt))
    return ([nhwc(f) for f in feats],
            [[nhwc(x) for x in part] for part in p16.rpn_head(feats)],
            p16.roi_head._bbox_forward(feats, rois, rb))


def jax_cascade_stages(m, b, out):
    """The levels, the RPN maps, HTC's semantic branch (its logits and
    embedding) and every stage's box head on JAX's dets."""
    feats = m.extract_feat(b['image'], train=False)
    rois, rb = det_rois(out)
    rh = m.roi_head
    sem = (rh.semantic_head(feats, train=False)
           if getattr(rh, 'semantic_head', None) is not None else None)
    boxes = []
    for head in rh.bbox_head:
        bf = (rh._bbox_feats(feats, rois, rb, sem[1]) if sem is not None
              else rh._extract(feats, rois, rb, rh.bbox_roi_out))
        boxes.append(head(bf, train=False))
    return feats, m.rpn_head(feats, train=False), sem or (), boxes


def port_cascade_stages(p16, bt, rois, rb):
    feats = p16.extract_feat(p16.images(bt))
    rh = p16.roi_head
    seg, sem = (rh._semantic(feats) if hasattr(rh, '_semantic')
                else (None, None))
    boxes = [head(rh._bbox_feats(feats, rois, rb, sem))
             for head in rh.bbox_head]
    return ([nhwc(f) for f in feats],
            [[nhwc(x) for x in part] for part in p16.rpn_head(feats)],
            (nhwc(seg), sem) if seg is not None else (), boxes)


def jax_dense_stages(m, b, out):
    """A dense detector's levels and its head's maps."""
    feats = m.extract_feat(b['image'], train=False)
    return feats, m.bbox_head(feats, train=False)


def port_dense_stages(p16, bt, rois, rb):
    feats = p16.extract_feat(p16.images(bt))
    return ([nhwc(f) for f in feats],
            [[nhwc(x) for x in part] for part in p16.bbox_head(feats)])


STAGES = {'rpn': (jax_rpn_stages, port_rpn_stages),
          'cascade': (jax_cascade_stages, port_cascade_stages),
          'dense': (jax_dense_stages, port_dense_stages)}


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def check_stages(port, batch, stages, ref, fp32_leaves=()):
    """Every stage of the port's bf16 copy within STAGE_RL2 of JAX's
    (``ref``, the test part of :func:`jax_bf16`), in the type JAX computes
    it in. The leaves ``fp32_leaves`` (indices into the flattened stages),
    where JAX's own bf16 rounding is at fault, are held within STAGE_RL2 of
    JAX's fp32 stages on the same bf16-rounded image instead."""
    from dynamask_torch.core.fp16 import to_bf16
    out, _, ref_stages, ref_fp32 = ref
    rois, rb = (torch.from_numpy(np.array(a)) for a in det_rois(out))
    bt = {k: torch.from_numpy(np.array(batch[k])) for k in TEST_KEYS}
    bt['image'] = bt['image'].bfloat16()
    with torch.no_grad():
        got = _leaves(STAGES[stages][1](to_bf16(port), bt, rois, rb.long()))
    want = _leaves(ref_stages)
    exact = _leaves(ref_fp32) if fp32_leaves else None
    assert len(got) == len(want) and len(got) >= 5
    assert any(str(r.dtype) == 'bfloat16' for r in want)
    for i, (g, r) in enumerate(zip(got, want)):
        assert str(g.dtype).split('.')[-1] == str(r.dtype), (i, g.dtype,
                                                             r.dtype)
        assert tuple(g.shape) == tuple(r.shape), (i, g.shape, r.shape)
        if i in fp32_leaves:
            r = exact[i]
            assert str(r.dtype) == 'float32'
        assert _rel_l2(g, r) <= STAGE_RL2, (i, _rel_l2(g, r))
    return len(got)


@contextlib.contextmanager
def injected_cascade_dets(ref):
    """While active, the cascade's NMS (``cascade_roi_head.multiclass_nms``,
    HTC's too) hands over JAX's dets, labels and valid flags, image after
    image."""
    import dynamask_torch.models.cascade_roi_head as crh
    saved, b = crh.multiclass_nms, ref['dets'].shape[0]
    calls = iter(range(10 ** 6))

    def take(*args, **kwargs):
        i = next(calls) % b
        return tuple(torch.from_numpy(np.array(ref[k][i]))
                     for k in ('dets', 'labels', 'valid'))
    crh.multiclass_nms = take
    try:
        yield
    finally:
        crh.multiclass_nms = saved


@contextlib.contextmanager
def captured_mask_probs(store):
    """While active, ``make_test_fn``'s paste epilogue hands the mask
    probabilities it pastes to ``store``."""
    import dynamask_torch.apis.test as tt
    saved = tt.paste_epilogue

    def take(out, *args, **kwargs):
        store.append(out['mask_probs'])
        return saved(out, *args, **kwargs)
    tt.paste_epilogue = take
    try:
        yield
    finally:
        tt.paste_epilogue = saved


def check_make_test_fn(port, batch, ref, inject=injected_dets,
                       canvas=CANVAS):
    """``make_test_fn(bf16=True)`` with JAX's dets injected: the dets fp32
    and JAX's; the bf16 mask probabilities it pastes within the flagship's
    bounds of JAX's ``simple_test`` in bf16; the pasted masks JAX's
    wherever JAX's pasted probability is MASK_MARGIN clear of 0.5. The fp32
    model given is left as it was."""
    from dynamask_torch.apis import make_test_fn
    out, epi = ref[:2]
    assert epi['valid'].sum() >= 4
    bt = {k: torch.from_numpy(np.array(batch[k])) for k in TEST_KEYS}
    store = []
    with inject(epi), captured_mask_probs(store):
        got = make_test_fn(port, canvas, 0.5, bf16=True)(bt)
    probs, = store
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert got['dets'].dtype == torch.float32
    np.testing.assert_array_equal(got['dets'].numpy(), epi['dets'])
    np.testing.assert_array_equal(got['labels'].numpy(), epi['labels'])
    assert str(probs.dtype).split('.')[-1] == str(out['mask_probs'].dtype)
    assert probs.shape == out['mask_probs'].shape
    assert _f32(probs).std() > 1e-2          # not saturated: the compare bites
    diff = np.abs(_f32(probs) - _f32(out['mask_probs']))
    assert diff.mean() <= PROB_MEAN_ATOL, diff.mean()
    assert (diff > PROB_ATOL).mean() <= FLIP_SHARE, (diff > PROB_ATOL).mean()
    pasted = epi['pasted'].reshape(got['masks'].shape)
    clear = np.abs(pasted - 0.5) > MASK_MARGIN
    assert clear.mean() > 0.5
    masks = got['masks'].numpy()
    assert (masks[clear] == epi['masks'][clear]).mean() >= MASK_AGREE


# -- the training step --------------------------------------------------------

@contextlib.contextmanager
def recorded_proposals(store):
    """While active, every ``rpn_get_proposals`` of the JAX package (the
    two-stage detectors' and guided anchoring's) hands its result to
    ``store`` as numpy (boxes, scores, valid) when the jitted step runs."""
    import dynamask_tpu.models.detectors as jdet
    import dynamask_tpu.models.rpn_head as jrpn
    saved = jrpn.rpn_get_proposals

    def record(*args, **kwargs):
        p = saved(*args, **kwargs)
        jax.debug.callback(lambda *xs: store.append(
            [np.asarray(x) for x in xs]), p.boxes, p.scores, p.valid)
        return p
    jrpn.rpn_get_proposals = jdet.rpn_get_proposals = record
    try:
        yield
    finally:
        jrpn.rpn_get_proposals = jdet.rpn_get_proposals = saved


@contextlib.contextmanager
def injected_train_proposals(props):
    """While active, the port's ``rpn_get_proposals`` (the two-stage
    detectors' and guided anchoring's) hands over ``props``."""
    import dynamask_torch.models.detectors as tdet
    import dynamask_torch.models.guided_anchor as tga
    from dynamask_torch.models.rpn_head import Proposals
    saved = tdet.rpn_get_proposals
    give = (lambda *a, **k: Proposals(
        *(torch.from_numpy(np.array(x)) for x in props)))
    tdet.rpn_get_proposals = tga.rpn_get_proposals = give
    try:
        yield
    finally:
        tdet.rpn_get_proposals = tga.rpn_get_proposals = saved


def jax_bf16(f):
    """JAX in bf16 for family ``f`` (:func:`twin_family`), in one jit:

    - the test part: ``make_test_fn(bf16=True)``'s function (``simple_test``
      on bf16 variables and a bf16 image, then the paste epilogue), the
      pasted probabilities and the stages (``STAGES``) on JAX's dets; with
      ``f.fp32_leaves`` the stages in fp32 too (the fp32 variables on the
      same bf16-rounded image), else None;
    - the bf16 step function (``make_train_step(compute_dtype=
      jnp.bfloat16)``'s cast of the parameters and the image,
      ``forward_train``, ``parse_losses``) under ``f.draws``, the training
      proposals it makes recorded.

    -> ((out, extra, stages, fp32 stages), (the step's log, its training
    proposals or None))."""
    from dynamask_tpu.apis.test import _paste_epilogue
    from dynamask_tpu.core.fp16 import to_bf16
    from dynamask_tpu.engine.train_state import _cast_f32_tree
    from dynamask_tpu.models.detectors import parse_losses
    from dynamask_tpu.ops.paste import paste_masks
    stages = STAGES[f.stages][0]
    canvas = f.canvas
    store = []

    def test(v16, v32, b):
        image = b['image'].astype(jnp.bfloat16)

        def method(m, b):
            out = m.simple_test(b)
            return out, stages(m, b, out)
        out, st = f.det.apply(v16, dict(b, image=image), method=method)
        st32 = None
        if f.fp32_leaves:
            st32 = f.det.apply(v32, dict(b, image=image.astype(jnp.float32)),
                               method=lambda m, b: stages(m, b, out))
        extra = {}
        if 'mask_probs' in out:
            extra = _paste_epilogue(out, *canvas, 0.5)
            n, d = out['dets'].shape[:2]
            probs = out['mask_probs']
            extra['pasted'] = paste_masks(
                probs.reshape(n * d, *probs.shape[2:]),
                out['dets'][..., :4].reshape(n * d, 4), *canvas).astype(
                    jnp.float32)
        return out, extra, st, st32

    def step(v32, b):
        b = dict(b, image=b['image'].astype(jnp.bfloat16))
        with f.draws(), recorded_proposals(store):
            losses, _ = f.det.apply(
                {'params': _cast_f32_tree(v32['params'], jnp.bfloat16),
                 'batch_stats': v32.get('batch_stats', {})}, b,
                method='forward_train',
                rngs={'sampling': jax.random.PRNGKey(0),
                      'sampler': jax.random.PRNGKey(0)},
                mutable=['batch_stats'])
        total, log = parse_losses(losses)
        log['loss'] = total.astype(jnp.float32)
        return log

    def fn(v16, v32, test_batch, train_batch):
        return test(v16, v32, test_batch), step(v32, train_batch)

    ref, log = jax.device_get(jax.jit(fn)(
        to_bf16(f.variables), f.variables,
        {k: jnp.asarray(f.test_batch[k]) for k in TEST_KEYS},
        {k: jnp.asarray(v) for k, v in f.train_batch.items()}))
    jax.effects_barrier()
    return ref, ({k: float(v) for k, v in log.items()},
                 store[-1] if store else None)


def port_step_bf16(port, batch, noise, props):
    """The port's bf16 step (``make_train_step(..., torch.bfloat16)``) on
    a copy of ``port`` in training mode, JAX's ``props`` injected where
    there are any -> (the log, the stepped copy)."""
    from dynamask_torch.engine import DetectorSGD, make_train_step
    from dynamask_torch.engine import step_lr_schedule as tsched
    net = copy.deepcopy(port).train()
    opt = DetectorSGD(net, LR, 0.9, 1e-4, 35.0,
                      tsched(LR, 10, warmup_iters=0))
    inject = (injected_train_proposals(props) if props is not None
              else contextlib.nullcontext())
    with inject:
        log = make_train_step(net, opt, torch.bfloat16)(
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in noise.items()})
    return {k: float(v) for k, v in log.items()}, net


def check_step(got, ref, net, want=None):
    """Every loss of JAX's step within LOSS_RTOL_JAX of the port's, the
    accuracy equal; the masters and their gradients fp32."""
    keys = {k for k in ref if 'loss' in k}
    if want is not None:
        assert keys == want | {'loss'}, sorted(keys)
    assert keys <= set(got), sorted(keys - set(got))
    for k in sorted(keys):
        assert np.isfinite(got[k]), k
        assert abs(got[k] - ref[k]) <= LOSS_RTOL_JAX * abs(ref[k]) + 1e-6, (
            k, got[k], ref[k])
    if 'acc' in ref:
        assert got['acc'] == pytest.approx(ref['acc'])
    assert all(p.dtype == torch.float32 for p in net.parameters())
    grads = [p.grad for p in net.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(t.dtype == torch.float32 for t in net.state_dict().values()
               if t.is_floating_point())


# -- the families -------------------------------------------------------------

def sampler_tables(seed=14, counts=(N_ANCHORS, G + P)):
    """One seeded priority table per candidate count."""
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(size=n).astype(np.float32) for n in counts}


def rpn_rcnn_noise(tables, anchors=N_ANCHORS, candidates=G + P):
    return {'rpn': tables[anchors][None], 'rcnn': tables[candidates][None]}


def twin_family(det, variables, port, test_batch, train_batch, stages,
                draws, noise, losses, inject=injected_dets, canvas=CANVAS,
                fp32_leaves=()):
    """A family's pair and what its three checks need: the test and train
    batches, the stages' kind (``STAGES``), a factory of the JAX draws
    patch, the port's noise, the loss keys beside the total (None: not
    pinned), the dets injection, the mask canvas and the stages held to
    the fp32 function (:func:`check_stages`)."""
    return types.SimpleNamespace(
        det=det, variables=variables, port=port, test_batch=test_batch,
        train_batch=train_batch, stages=stages, draws=draws, noise=noise,
        losses=losses, inject=inject, canvas=canvas,
        fp32_leaves=fp32_leaves)


def family_step(f, jax_step):
    """(the port's log, JAX's, the stepped port) of family ``f``'s bf16
    step, JAX's step (:func:`jax_bf16`) given."""
    ref, props = jax_step
    got, net = port_step_bf16(f.port, f.train_batch, f.noise, props)
    return got, ref, net


RPN_LOSSES = {'loss_rpn_cls', 'loss_rpn_bbox'}
BOX_LOSSES = {'loss_cls', 'loss_bbox'}


@functools.lru_cache(maxsize=None)
def family(name):
    """Family ``name`` (:func:`twin_family`) from its family test's own
    twin, draws and batches."""
    if name == 'refine':
        from test_torch_port_refinemask import _demo, refine_pair
        from test_torch_port_train_slice import jax_draws
        det, variables, port, _ = refine_pair('refine')
        batch = _demo()
        rng = np.random.RandomState(14)
        noise = {'rpn': rng.uniform(size=(1, N_ANCHORS)).astype(np.float32),
                 'rcnn': rng.uniform(size=(1, G + P)).astype(np.float32),
                 'gumbel': np.zeros((8, 4), np.float32)}
        return twin_family(det, variables, port, batch, batch, 'rpn',
                           lambda: jax_draws(noise), noise,
                           RPN_LOSSES | BOX_LOSSES | {'loss_instance',
                                                      'loss_semantic'})
    if name == 'c4':
        from test_torch_port_item9_c4 import N_ANCHORS as C4_ANCHORS
        from test_torch_port_item9_c4 import _demo, twin
        tables = sampler_tables(counts=(C4_ANCHORS, G + P))
        return twin_family(*twin('mask'), _demo(), _demo(), 'rpn',
                           lambda: jax_sampler_priorities(tables),
                           rpn_rcnn_noise(tables, C4_ANCHORS),
                           RPN_LOSSES | BOX_LOSSES | {'loss_mask'})
    if name in ('cascade', 'htc'):
        from test_torch_port_cascade import (_demo, _tables, cascade_pair,
                                             port_noise)
        tables = _tables()
        return twin_family(*cascade_pair(name), _demo(),
                           _demo(semantic=name == 'htc'), 'cascade',
                           lambda: jax_sampler_priorities(tables),
                           {k: v.numpy() for k, v in
                            port_noise(tables).items()}, None,
                           injected_cascade_dets)
    if name in ('groie', 'dh'):
        from test_torch_port_two_stage_twins import _demo, twin
        tables = sampler_tables()
        return twin_family(*twin(name), _demo(), _demo(), 'rpn',
                           lambda: jax_sampler_priorities(tables),
                           rpn_rcnn_noise(tables),
                           RPN_LOSSES | BOX_LOSSES |
                           ({'loss_mask'} if name == 'groie' else set()))
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def jax_of(name):
    return jax_bf16(family(name))


def outputs_of(name):
    return jax_of(name)[0]


@functools.lru_cache(maxsize=None)
def step_of(name):
    return family_step(family(name), jax_of(name)[1])


FAMILIES = ['refine', 'c4', 'cascade', 'htc', 'groie', 'dh']
MASKED = ['refine', 'c4', 'cascade', 'htc', 'groie']


@pytest.mark.parametrize('name', FAMILIES)
def test_bf16_stages_match_jax(name):
    """The levels, the RPN maps, each box head (each cascade stage's; HTC's
    semantic logits and embedding) on JAX's RoIs, port bf16 against JAX
    bf16, each within STAGE_RL2 relative L2 and of JAX's type."""
    f = family(name)
    check_stages(f.port, f.test_batch, f.stages, outputs_of(name),
                 f.fp32_leaves)


@pytest.mark.parametrize('name', MASKED)
def test_make_test_fn_bf16_matches_jax(name):
    """``make_test_fn(bf16=True)`` on JAX's injected dets: mask
    probabilities and pasted masks against JAX's in bf16 (RefineMask's 112
    from the one-channel semantic crops, C4's through res5, the cascades'
    mean of three stages' sigmoids, GRoIE's summed all-level crops)."""
    f = family(name)
    check_make_test_fn(f.port, f.test_batch, outputs_of(name),
                       inject=f.inject)


@pytest.mark.parametrize('name', FAMILIES)
def test_bf16_step_losses_match_jax(name):
    """The bf16 step against JAX's bf16 step function on JAX's training
    proposals, with the family's draws: every loss within LOSS_RTOL_JAX,
    the accuracy equal, fp32 masters and gradients."""
    got, ref, net = step_of(name)
    check_step(got, ref, net, family(name).losses)
