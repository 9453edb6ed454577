"""Op-level parity of the PyTorch port (dynamask_torch) against the JAX
package, on the CPU in fp32, plus the port's import and device guards.

On the CPU the kernel wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those on the GPU by chip_smoke.py.
Inputs come from seeded numpy draws; coordinates are off-grid so no sample
sits exactly on an inclusion edge, where the last ulp of the coordinate
decides (XLA contracts a*b+c into an fma, ATen does not).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDES = (4, 8, 16, 32)


def _pyramid(rng, b=2, c=16, h0=64, w0=96):
    return [rng.randn(b, h0 >> i, w0 >> i, c).astype(np.float32)
            for i in range(4)]


# RoIs on every level, partly outside the image, zero-area, and wider than
# the Pallas kernel's 64-px window on their level (rows 6-7)
ROIS = np.asarray([
    [16.3, 16.1, 80.2, 90.7],     # level 0
    [8.4, 8.2, 140.6, 150.3],     # level 1
    [4.1, 4.3, 250.2, 255.9],     # level 2
    [0.2, 0.6, 380.5, 250.1],     # level 3
    [-20.3, -10.7, 30.2, 44.1],   # partly outside
    [40.5, 40.5, 40.5, 40.5],     # zero area
    [0.3, 10.2, 380.4, 30.6],     # 95 px wide on level 0
    [2.2, 100.1, 383.7, 150.3],   # 190 px wide on level 1
    [350.1, 230.4, 420.8, 270.2],  # past the bottom-right corner
], np.float32)
BATCH = np.asarray([0, 1, 0, 1, 0, 1, 0, 1, 1], np.int64)
# both sides sample the same points in fp32; only summation order and fma
# contraction differ: ~1e-6 on the N(0, 1) features, 1e-4 leaves margin
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestRoIAlign:
    @pytest.mark.parametrize('ratio', [1, 2])
    @pytest.mark.parametrize('out_size', [7, 14])
    def test_multilevel_matches_xla(self, ratio, out_size):
        from dynamask_tpu.ops.roi_align import multilevel_roi_align as jml
        from dynamask_torch.ops.roi_align import multilevel_roi_align
        feats = _pyramid(np.random.RandomState(0))
        ref = jml([jnp.asarray(f) for f in feats], jnp.asarray(ROIS),
                  jnp.asarray(BATCH.astype(np.int32)), out_size, STRIDES,
                  sampling_ratio=ratio)
        got = multilevel_roi_align([_t(f) for f in feats], _t(ROIS),
                                   _t(BATCH), out_size, STRIDES,
                                   sampling_ratio=ratio)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize('ratio', [1, 2])
    def test_single_level_matches_xla(self, ratio):
        from dynamask_tpu.ops.roi_align import roi_align as jroi
        from dynamask_tpu.ops.roi_align import simple_roi_align as jsimple
        from dynamask_torch.ops.roi_align import roi_align, simple_roi_align
        feat = _pyramid(np.random.RandomState(1))[0]
        args_j = (jnp.asarray(feat), jnp.asarray(ROIS),
                  jnp.asarray(BATCH.astype(np.int32)))
        args_t = (_t(feat), _t(ROIS), _t(BATCH))
        np.testing.assert_allclose(
            roi_align(*args_t, 14, 0.25, sampling_ratio=ratio).numpy(),
            np.asarray(jroi(*args_j, 14, 0.25, sampling_ratio=ratio)),
            atol=ATOL)
        np.testing.assert_allclose(
            simple_roi_align(*args_t, 28, 0.125, sampling_ratio=ratio).numpy(),
            np.asarray(jsimple(*args_j, 28, 0.125, sampling_ratio=ratio)),
            atol=ATOL)
        # legacy (aligned=False) RoIAlign is not ported: refused, not run
        with pytest.raises(NotImplementedError):
            roi_align(*args_t, 7, 0.25, sampling_ratio=ratio, aligned=False)

    def test_matches_pallas_inside_its_window(self):
        """The Pallas kernel (interpret mode) on the RoIs its 64-px window
        covers; the port has no window and matches the XLA form above on
        the others."""
        from dynamask_tpu.ops.roi_align_pallas import \
            multilevel_roi_align_pallas
        from dynamask_torch.ops.roi_align import multilevel_roi_align
        feats = _pyramid(np.random.RandomState(2), c=32)
        rois, batch = ROIS[:4], BATCH[:4]
        ref = multilevel_roi_align_pallas(
            [jnp.asarray(f) for f in feats], jnp.asarray(rois),
            jnp.asarray(batch.astype(np.int32)), 7, STRIDES, interpret=True)
        got = multilevel_roi_align([_t(f) for f in feats], _t(rois),
                                   _t(batch), 7, STRIDES)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    def test_level_routing(self):
        from dynamask_tpu.ops.roi_align import map_roi_levels as jmap
        from dynamask_torch.ops.roi_align import map_roi_levels
        np.testing.assert_array_equal(
            map_roi_levels(_t(ROIS), 4).numpy(),
            np.asarray(jmap(jnp.asarray(ROIS), 4)))

    def test_wrapper_does_not_fall_back_off_cpu(self):
        """A tensor neither on the CPU nor on a CUDA device is refused: the
        plain version runs only for CPU tensors."""
        from dynamask_torch.ops.roi_align import roi_align_fwd
        m = torch.device('meta')
        with pytest.raises(ValueError):
            roi_align_fwd(torch.empty(10, 4, device=m),
                          torch.empty(2, 4, device=m),
                          torch.empty(2, dtype=torch.int64, device=m),
                          torch.empty(2, dtype=torch.int32, device=m),
                          torch.empty(2, dtype=torch.int32, device=m),
                          torch.empty(2, device=m), 7, 2)


class TestWindowedDCN:
    @pytest.mark.parametrize('s,c', [(8, 16), (8, 32), (14, 16), (14, 32)])
    def test_matches_jax(self, s, c):
        """Offsets up to ±5 px reach past the ±3 window (clip) and off the
        plane (zero mask); compared with the XLA form, the Pallas row-matmul
        kernel in interpret mode, and its sampled column tensor."""
        from dynamask_tpu.ops.deform_conv import deform_conv2d_windowed
        from dynamask_tpu.ops.deform_conv_pallas import deform_conv2d_rowmm
        from dynamask_torch.ops.deform_conv import (
            deform_conv2d, deform_im2col_windowed)
        rng = np.random.RandomState(s + c)
        n, g = 3, 2
        x = rng.randn(n, s, s, c).astype(np.float32)
        off = rng.uniform(-5, 5, (n, s, s, 2 * g * 9)).astype(np.float32)
        w = (rng.randn(3, 3, c, 24) * 0.1).astype(np.float32)
        ja = (jnp.asarray(x), jnp.asarray(off), jnp.asarray(w))
        ref = deform_conv2d_windowed(*ja, 3, 1, 1, 1, g, 3)
        got = deform_conv2d(_t(x), _t(off), _t(w), 3, 1, 1, 1, g, 3).numpy()
        # O(1) outputs summed over 9*C products: fp32 order differences
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
        rowmm = deform_conv2d_rowmm(*ja, 3, 1, 1, g, 3, interpret=True)
        np.testing.assert_allclose(got, np.asarray(rowmm), atol=ATOL)
        # column tensors: JAX (n, g, y, c, t*S + x) vs port (n, y, x, g, t, c)
        samp = np.asarray(deform_conv2d_rowmm(*ja, 3, 1, 1, g, 3,
                                              interpret=True,
                                              return_sampled=True))
        samp = samp.reshape(n, g, s, c // g, 9, s).transpose(0, 2, 5, 1, 4, 3)
        col = deform_im2col_windowed(_t(x), _t(off), 3, 1, 1, g, 3)
        np.testing.assert_allclose(col.numpy(), samp, atol=1e-5)

    def test_wrapper_does_not_fall_back_off_cpu(self):
        from dynamask_torch.ops.deform_conv import deform_im2col_windowed
        m = torch.device('meta')
        with pytest.raises(ValueError):
            deform_im2col_windowed(torch.empty(1, 8, 8, 16, device=m),
                                   torch.empty(1, 8, 8, 36, device=m),
                                   3, 1, 1, 2, 3)


def _random_boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


class TestNMS:
    def test_nms_and_batched(self):
        import importlib
        jn = importlib.import_module('dynamask_tpu.ops.nms')
        tn = importlib.import_module('dynamask_torch.ops.nms')
        rng = np.random.RandomState(0)
        boxes = _random_boxes(rng, 600)
        scores = rng.permutation(600).astype(np.float32) / 600 + 0.01
        valid = rng.uniform(size=600) > 0.1
        idxs = rng.randint(0, 3, 600)
        for pre in (4096, 300):
            ref = jn.nms(jnp.asarray(boxes), jnp.asarray(scores),
                         jnp.asarray(valid), 0.5, 80, pre)
            got = tn.nms(_t(boxes), _t(scores), _t(valid), 0.5, 80, pre)
            for a, b in zip(ref, got):
                np.testing.assert_allclose(np.asarray(a), b.numpy())
        ref = jn.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(idxs.astype(np.int32)),
                             jnp.asarray(valid), 0.7, 300)
        got = tn.batched_nms(_t(boxes), _t(scores), _t(idxs), _t(valid),
                             0.7, 300)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(np.asarray(a), b.numpy())

    def test_multiclass(self):
        from dynamask_tpu.ops.nms import multiclass_nms as jmc
        from dynamask_torch.ops.nms import multiclass_nms
        rng = np.random.RandomState(1)
        n, ncls = 200, 8
        boxes = np.stack([_random_boxes(rng, n) for _ in range(ncls)], 1)
        boxes = boxes.reshape(n, ncls * 4)
        scores = rng.dirichlet(np.ones(ncls + 1), n)[:, :ncls].astype(
            np.float32)
        valid = rng.uniform(size=n) > 0.2
        ref = jmc(jnp.asarray(boxes), jnp.asarray(scores), 0.05, 0.5, 100,
                  valid=jnp.asarray(valid))
        got = multiclass_nms(_t(boxes), _t(scores), 0.05, 0.5, 100,
                             valid=_t(valid))
        assert int(got[2].sum()) > 50
        for a, b in zip(ref, got):
            np.testing.assert_allclose(np.asarray(a), b.numpy())


class TestBoxMath:
    def test_transforms_and_anchors(self):
        from dynamask_tpu.core import bbox_transforms as jb
        from dynamask_tpu.core.anchors import AnchorGenerator as JAG
        from dynamask_torch.core import bbox_transforms as tb
        from dynamask_torch.core.anchors import AnchorGenerator
        rng = np.random.RandomState(3)
        rois = _random_boxes(rng, 50)
        deltas = rng.normal(0, 1, (50, 12)).astype(np.float32)
        args = ((0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2))
        np.testing.assert_allclose(
            tb.delta2bbox(_t(rois), _t(deltas), *args).numpy(),
            np.asarray(jb.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas),
                                     *args)), rtol=1e-6, atol=1e-4)
        shape = np.asarray([60., 80.], np.float32)
        np.testing.assert_array_equal(
            tb.clip_boxes(_t(rois), _t(shape)).numpy(),
            np.asarray(jb.clip_boxes(jnp.asarray(rois), jnp.asarray(shape))))
        np.testing.assert_allclose(
            tb.bbox_overlaps(_t(rois), _t(rois[::-1].copy())).numpy(),
            np.asarray(jb.bbox_overlaps(jnp.asarray(rois),
                                        jnp.asarray(rois[::-1].copy()))),
            atol=1e-6)
        cfg = dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0],
                   scales=[8])
        sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
        for a, b in zip(AnchorGenerator(**cfg).grid_anchors(sizes),
                        JAG(**cfg).grid_anchors(sizes)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class TestBoundaryAndResize:
    @pytest.mark.parametrize('bw', [1, 2])
    def test_block_target(self, bw):
        from dynamask_tpu.core.boundary import generate_block_target as jg
        from dynamask_torch.core.boundary import generate_block_target
        mask = (np.random.RandomState(bw).uniform(size=(4, 28, 28)) >
                0.4).astype(np.float32)
        np.testing.assert_array_equal(
            generate_block_target(_t(mask), bw).numpy(),
            np.asarray(jg(jnp.asarray(mask), bw)))

    @pytest.mark.parametrize('align_corners', [False, True])
    def test_resize(self, align_corners):
        from dynamask_tpu.core.boundary import interpolate_bilinear as ji
        from dynamask_tpu.models.layers import resize_bilinear_2x as jr
        from dynamask_torch.core.boundary import interpolate_bilinear
        from dynamask_torch.models.layers import resize_bilinear_2x
        x = np.random.RandomState(4).randn(3, 5, 14, 14).astype(np.float32)
        np.testing.assert_allclose(
            interpolate_bilinear(_t(x), 56, 40, align_corners).numpy(),
            np.asarray(ji(jnp.asarray(x), 56, 40, align_corners)), atol=1e-5)
        # the JAX form is NHWC, the port's NCHW
        ref = np.asarray(jr(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            align_corners))
        got = resize_bilinear_2x(_t(x), align_corners).numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, atol=1e-5)


def test_paste_masks():
    from dynamask_tpu.ops.paste import paste_masks as jp
    from dynamask_torch.ops.paste import paste_masks
    rng = np.random.RandomState(5)
    masks = rng.uniform(size=(40, 28, 28)).astype(np.float32)
    boxes = _random_boxes(rng, 40, size=90.0)
    boxes[3] = [-10.3, -5.2, 30.1, 20.7]          # partly off the canvas
    ref = jp(jnp.asarray(masks), jnp.asarray(boxes), 64, 96)
    np.testing.assert_allclose(
        paste_masks(_t(masks), _t(boxes), 64, 96).numpy(), np.asarray(ref),
        atol=1e-5)


class TestGuards:
    def test_import_pulls_in_no_jax(self):
        """Importing every port package in a fresh interpreter loads
        neither JAX, flax nor the JAX package."""
        code = ('import sys\n'
                'import dynamask_torch, dynamask_torch.utils, '
                'dynamask_torch.core, dynamask_torch.ops, '
                'dynamask_torch.models, dynamask_torch.engine, '
                'dynamask_torch.apis\n'
                'bad = [m for m in sys.modules if m.split(".")[0] in '
                '("jax", "jaxlib", "flax", "dynamask_tpu")]\n'
                'assert not bad, bad\n')
        env = dict(os.environ, PYTHONPATH=REPO)
        r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr

    def test_no_jax_import_in_source(self):
        banned = ('jax', 'jaxlib', 'flax', 'dynamask_tpu')
        for root, _, files in os.walk(os.path.join(REPO, 'dynamask_torch')):
            for f in files:
                if not f.endswith('.py'):
                    continue
                path = os.path.join(root, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                for node in ast.walk(tree):
                    names = []
                    if isinstance(node, ast.Import):
                        names = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and node.module:
                        names = [node.module] if node.level == 0 else []
                    for name in names:
                        assert name.split('.')[0] not in banned, (path, name)

    def test_entry_points_need_cuda_unless_cpu(self, monkeypatch):
        from dynamask_torch.apis import init_detector
        from dynamask_torch.models import build_detector
        from dynamask_torch.utils import Config, resolve_device
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        cfg_path = os.path.join(REPO, 'configs/dynamask/coco/'
                                'r50_dynamask_1x.py')
        with pytest.raises(RuntimeError, match='CUDA'):
            resolve_device()
        with pytest.raises(RuntimeError, match='CUDA'):
            init_detector(cfg_path)
        cfg = Config.fromfile(cfg_path)
        with pytest.raises(RuntimeError, match='CUDA'):
            build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
        assert resolve_device('cpu').type == 'cpu'
