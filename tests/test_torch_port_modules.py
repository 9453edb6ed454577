"""Module-level parity of the PyTorch port (dynamask_torch) against the JAX
package, on the CPU in fp32.

The JAX toy DynaMask detector (tests/test_dynamask.py:dynamask_toy_cfg:
ResNet-18, 32-channel FPN, 8 classes) is initialised, its zero-initialised
leaves (DCN offset convs, biases, BN statistics) are replaced by seeded
numpy draws so every path is exercised, and the variables are carried into
the port with ``load_jax_variables``. Each module then runs on the same
numpy inputs on both sides.

Tolerances: both sides compute in fp32 with different summation orders
(XLA vs ATen convs and GEMMs); 1e-4 absolute on O(1) activations covers
that with margin, and mask probabilities after the fused cascade agree to
2e-4.
"""

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

ATOL = 1e-4
# jax.jit without LLVM's optimisation, which takes most of a toy program's
# compile; its results differ from the default compile's in the last bits.
# Only for parameter inits (both sides then load the same draws) and for
# forward passes of dense layers, which move by about as much; every
# gradient, and every program that thresholds, sorts, ranks, assigns,
# samples or suppresses, stays at jax.jit, where an ulp can flip a decision
fast_jit = functools.partial(
    jax.jit, compiler_options={'xla_backend_optimization_level': 0})
# off-grid coordinates: a sample that lands exactly on a plane's inclusion
# edge (y == extent) is decided by the last ulp of its coordinate, which
# XLA (fma-contracted) and ATen round differently; see ROADMAP queue 3
ROIS = np.asarray([[4.3, 4.1, 40.2, 36.7], [10.6, 8.2, 60.1, 60.3],
                   [0.4, 0.2, 20.3, 24.1], [30.2, 20.7, 63.4, 63.1],
                   [-6.3, 50.2, 30.1, 70.6], [12.5, 12.5, 12.5, 12.5]],
                  np.float32)
LABELS = np.asarray([1, 3, 0, 7, 5, 2], np.int64)


def randomize_variables(variables, seed=1):
    """Replace zero-initialised leaves and BN statistics with seeded draws
    (kernels keep their He init; all-zero kernels get N(0, 0.02))."""
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ('kernel', 'weight'):
            return (rng.normal(0, 0.02, x.shape).astype(np.float32)
                    if not np.any(x) else x)
        if name == 'bias':
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == 'mean':
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(fill, variables)


@functools.lru_cache(maxsize=None)
def _toy_variables():
    """The JAX toy detector's randomised variables (one init per process;
    the dynamic mode shares the faithful mode's parameter tree)."""
    from test_dynamask import dynamask_toy_cfg
    from test_models import demo_batch
    from dynamask_tpu.models import build_detector as jax_build
    det = jax_build(*dynamask_toy_cfg())
    batch = demo_batch(0, b=1, h=64, w=64, g=3, s=16)
    return randomize_variables(
        jax.jit(det.init)({'params': jax.random.PRNGKey(0)}, batch))


def toy_pair(dynamic=False, capacity=(1.0, 0.5, 0.25)):
    """(JAX detector, its variables, the port detector loaded from them,
    the model config)."""
    from test_dynamask import dynamask_toy_cfg
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.models import build_detector
    from dynamask_torch.engine import load_jax_variables

    model, train_cfg, test_cfg = dynamask_toy_cfg()
    model['roi_head']['dynamic_inference'] = dynamic
    model['roi_head']['dynamic_capacity'] = capacity
    det = jax_build(model, train_cfg, test_cfg)
    variables = _toy_variables()
    port = build_detector(model, train_cfg, test_cfg, device='cpu')
    load_jax_variables(port, variables)
    return det, variables, port, (model, train_cfg, test_cfg)


@pytest.fixture(scope='module')
def pair():
    return toy_pair()


def nchw(a):
    """NHWC numpy -> NCHW tensor view in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope='module')
def pyramid():
    rng = np.random.RandomState(5)
    return [rng.uniform(-1, 1, (1, 64 // s, 64 // s, 32)).astype(np.float32)
            for s in (4, 8, 16, 32, 64)]


def _close(a, b, atol=ATOL, msg=''):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=atol, err_msg=msg)


class TestBackboneNeck:
    def test_resnet50_fpn_64(self):
        """Full-width ResNet-50 + 256-channel FPN at 64x64."""
        from dynamask_tpu.models import ResNet as JResNet
        from dynamask_tpu.models.fpn import FPN as JFPN
        from dynamask_torch.models import FPN, ResNet
        from dynamask_torch.engine import load_jax_variables

        x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
        jb = JResNet(depth=50, frozen_stages=1)
        jn = JFPN(in_channels=(256, 512, 1024, 2048), out_channels=256,
                  num_outs=5)
        bv = randomize_variables(jax.jit(jb.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)), seed=2)
        c = jb.apply(bv, jnp.asarray(x))
        nv = randomize_variables(jax.jit(jn.init)(jax.random.PRNGKey(1), c),
                                 seed=3)
        ref = jn.apply(nv, c)

        port = torch.nn.Module()
        port.backbone = ResNet(depth=50, frozen_stages=1)
        port.neck = FPN((256, 512, 1024, 2048), 256, 5)
        port.eval().to(memory_format=torch.channels_last)
        load_jax_variables(port, {
            'params': {'backbone': bv['params'], 'neck': nv['params']},
            'batch_stats': {'backbone': bv['batch_stats']}})
        with torch.no_grad():
            got = port.neck(port.backbone(nchw(x)))
        assert len(got) == len(ref) == 5
        for i, (a, b) in enumerate(zip(ref, got)):
            scale = float(np.abs(np.asarray(a)).max())
            _close(a, b.permute(0, 2, 3, 1).numpy(), atol=1e-5 * scale + ATOL,
                   msg=f'P{i + 2}')


class TestRPN:
    def test_maps_and_proposals(self, pair):
        from dynamask_tpu.models.rpn_head import rpn_get_proposals as jprops
        from dynamask_torch.models import rpn_get_proposals
        det, variables, port, _ = pair
        img = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
        shape = np.asarray([[64., 64.]], np.float32)

        def fn(m, x):
            feats = m.extract_feat(x, train=False)
            cls, reg = m.rpn_head(feats, train=False)
            gen = m._anchor_generator()
            anchors = gen.grid_anchors([tuple(f.shape[1:3]) for f in feats])
            return cls, reg, jprops(cls, reg, anchors, jnp.asarray(shape),
                                    nms_pre=m.rpn_nms_pre_test,
                                    max_num=m.rpn_max_num,
                                    nms_thr=m.rpn_nms_thr)

        cls_j, reg_j, props_j = det.apply(variables, jnp.asarray(img),
                                          method=fn)
        with torch.no_grad():
            feats = port.extract_feat(nchw(img))
            cls_t, reg_t = port.rpn_head(feats)
            anchors = port.anchor_generator.grid_anchors(
                [tuple(f.shape[-2:]) for f in feats])
            props_t = rpn_get_proposals(
                cls_t, reg_t, anchors, torch.from_numpy(shape),
                nms_pre=port.rpn_nms_pre_test, max_num=port.rpn_max_num,
                nms_thr=port.rpn_nms_thr)
        for a, b in zip(cls_j + reg_j, cls_t + reg_t):
            _close(a, b.permute(0, 2, 3, 1).numpy())
        np.testing.assert_array_equal(np.asarray(props_j.valid),
                                      props_t.valid.numpy())
        _close(props_j.boxes, props_t.boxes.numpy(), atol=1e-3)
        _close(props_j.scores, props_t.scores.numpy())


class TestBoxHead:
    def test_head_and_dets_on_shared_rois(self, pair, pyramid):
        from dynamask_tpu.models.bbox_head import bbox_head_get_dets as jdets
        from dynamask_torch.models.bbox_head import bbox_head_get_dets
        det, variables, port, _ = pair
        rb = np.zeros(len(ROIS), np.int32)
        cls_j, reg_j = det.apply(
            variables, [jnp.asarray(f) for f in pyramid], jnp.asarray(ROIS),
            jnp.asarray(rb), method=lambda m, f, r, b:
            m.roi_head._bbox_forward(f, r, b, train=False))
        with torch.no_grad():
            cls_t, reg_t = port.roi_head._bbox_forward(
                [nchw(f) for f in pyramid], torch.from_numpy(ROIS),
                torch.from_numpy(rb).long())
        _close(cls_j, cls_t.numpy())
        _close(reg_j, reg_t.numpy())

        # decode + multiclass NMS on the same logits: larger deltas and
        # well-separated class scores so the kept set is decided by margins
        rng = np.random.RandomState(3)
        cls = rng.normal(0, 2, (len(ROIS), 9)).astype(np.float32)
        reg = rng.normal(0, 0.5, (len(ROIS), 32)).astype(np.float32)
        valid = np.asarray([1, 1, 1, 1, 1, 0], bool)
        args = (8, (0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2), 0.05, 0.5, 8)
        dj = jdets(jnp.asarray(ROIS), jnp.asarray(cls), jnp.asarray(reg),
                   jnp.asarray(valid), jnp.asarray([64., 64.]),
                   jnp.asarray([2., 2., 2., 2.]), *args)
        dt = bbox_head_get_dets(
            torch.from_numpy(ROIS), torch.from_numpy(cls),
            torch.from_numpy(reg), torch.from_numpy(valid),
            torch.tensor([64., 64.]), torch.tensor([2., 2., 2., 2.]), *args)
        np.testing.assert_array_equal(np.asarray(dj[2]), dt[2].numpy())
        np.testing.assert_array_equal(np.asarray(dj[1]), dt[1].numpy())
        _close(dj[0], dt[0].numpy())


class TestDynaMaskHead:
    @pytest.mark.parametrize('caps', [None, (6, 4, 3, 2)])
    def test_stage_logits(self, pair, pyramid, caps):
        """The 32-channel cascade on shared RoIs, full and bucketed."""
        det, variables, port, _ = pair
        rng = np.random.RandomState(9)
        inst = rng.uniform(-1, 1, (len(ROIS), 14, 14, 32)).astype(np.float32)
        rb = np.zeros(len(ROIS), np.int32)
        preds_j, det_j = det.apply(
            variables, jnp.asarray(inst), [jnp.asarray(f) for f in pyramid],
            jnp.asarray(ROIS), jnp.asarray(rb),
            jnp.asarray(LABELS, jnp.int32),
            method=lambda m, x, fs, r, b, l: m.roi_head.mask_head(
                x, fs, r, b, l, False, caps))
        with torch.no_grad():
            preds_t, det_t = port.roi_head.mask_head(
                nchw(inst), [nchw(f) for f in pyramid],
                torch.from_numpy(ROIS), torch.from_numpy(rb).long(),
                torch.from_numpy(LABELS), caps)
        assert len(preds_j) == len(preds_t) == 4
        for s, (a, b) in enumerate(zip(preds_j + det_j, preds_t + det_t)):
            _close(np.asarray(a)[..., 0], b[:, 0].numpy(), atol=2e-4,
                   msg=f'stage output {s}')

    def test_mask_pre_project_commutes(self, pair, pyramid):
        """MSM logits: JAX project->crop->head vs the port's same route and
        its crop-first 'full' route."""
        from dynamask_tpu.ops.roi_align import roi_align as jroi
        from dynamask_torch.ops.roi_align import roi_align
        det, variables, port, _ = pair
        rb = np.zeros(len(ROIS), np.int32)

        def route(m, p2, rois, b):
            proj = m.roi_head.mask_predictor(p2, False, 'project')
            crops = jroi(proj, rois, b, 56, 0.25, sampling_ratio=1)
            return m.roi_head.mask_predictor(crops, False, 'head')

        ref = det.apply(variables, jnp.asarray(pyramid[0]), jnp.asarray(ROIS),
                        jnp.asarray(rb), method=route)
        msm = port.roi_head.mask_predictor
        rois_t, rb_t = torch.from_numpy(ROIS), torch.from_numpy(rb).long()
        with torch.no_grad():
            proj = msm(nchw(pyramid[0]), 'project')
            crops = roi_align(proj.permute(0, 2, 3, 1), rois_t, rb_t, 56,
                              0.25, sampling_ratio=1)
            got = msm(crops.permute(0, 3, 1, 2), 'head')
            crops_full = roi_align(torch.from_numpy(pyramid[0]), rois_t,
                                   rb_t, 56, 0.25, sampling_ratio=1)
            got_full = msm(crops_full.permute(0, 3, 1, 2), 'full')
        _close(ref, got.numpy())
        _close(ref, got_full.numpy())


class TestSimpleTestMask:
    @pytest.mark.parametrize('dynamic', [False, True])
    def test_both_modes(self, dynamic, pyramid):
        """Boundary-fused cascade (faithful) and MSM-routed buckets
        (dynamic, capacities 1.0/0.5/0.25) on shared dets."""
        det, variables, port, _ = toy_pair(dynamic=dynamic)
        dets = np.concatenate([ROIS, np.linspace(0.9, 0.4, len(ROIS),
                                                 dtype=np.float32)[:, None]],
                              -1)[None]
        scale = np.full((1, 4), 0.5, np.float32)
        ref = det.apply(
            variables, [jnp.asarray(f) for f in pyramid], jnp.asarray(dets),
            jnp.asarray(LABELS[None], jnp.int32),
            {'scale_factor': jnp.asarray(scale)},
            method=lambda m, fs, d, l, b: m.roi_head.simple_test_mask(
                fs, d, l, b, rescale=True))
        routing = {}
        with torch.no_grad():
            got = port.roi_head.simple_test_mask(
                [nchw(f) for f in pyramid], torch.from_numpy(dets),
                torch.from_numpy(LABELS[None]),
                {'scale_factor': torch.from_numpy(scale)}, rescale=True,
                routing=routing)
        assert got.shape == (1, len(ROIS), 112, 112)
        _close(ref, got.numpy(), atol=2e-4)
        assert bool(routing) == dynamic
        if dynamic:
            assert int(routing['hist'].sum()) == len(ROIS)


class TestWeightCarry:
    def test_every_port_tensor_has_a_jax_leaf(self, pair):
        from dynamask_torch.engine import mmdet_key
        _, _, port, _ = pair
        keys = [k for k in port.state_dict()
                if not k.endswith('num_batches_tracked')]
        assert keys and all(mmdet_key(k) is not None for k in keys)

    def test_round_trip_through_convert_torch_weights(self, pair):
        """port state_dict -> JAX importer -> the original JAX tree."""
        from dynamask_tpu.engine.pretrained import convert_torch_weights
        _, variables, port, _ = pair
        sd = {k: v.detach().contiguous().numpy()
              for k, v in port.state_dict().items()}
        blank = jax.tree_util.tree_map(np.zeros_like, variables)
        params, stats, report = convert_torch_weights(
            sd, blank['params'], blank['batch_stats'], scope='mmdet')
        assert not report['mismatched'], report['mismatched']
        assert [k for k in report['skipped']
                if 'num_batches_tracked' not in k] == []
        got = {'params': params, 'batch_stats': stats}
        flat_ref = jax.tree_util.tree_leaves_with_path(variables)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_ref) == len(flat_got)
        for path, leaf in flat_ref:
            np.testing.assert_array_equal(
                np.asarray(flat_got[path]), np.asarray(leaf),
                err_msg=jax.tree_util.keystr(path))

    def test_init_detector_loads_a_checkpoint(self, pair, tmp_path):
        """A port state_dict saved to disk comes back through the entry
        point unchanged, over a differently seeded build."""
        from dynamask_torch.apis import init_detector
        from dynamask_torch.utils import Config
        _, _, port, (model, train_cfg, test_cfg) = pair
        path = tmp_path / 'port.pth'
        torch.save(port.state_dict(), path)
        cfg = Config(dict(model=model, train_cfg=train_cfg,
                          test_cfg=test_cfg))
        loaded = init_detector(cfg, str(path), device='cpu', seed=7)
        ref = port.state_dict()
        got = loaded.state_dict()
        assert ref.keys() == got.keys()
        for k in ref:
            assert torch.equal(ref[k], got[k]), k
