"""Gradients of the port's two differentiable ops against the JAX package, on
the CPU in fp32: the windowed DCN (autograd function over K1 and K3) and
RoIAlign (autograd function over K2 and K4). On the CPU the kernel wrappers
run their plain PyTorch versions; chip_smoke.py holds the kernels against
those on the GPU.

Each case draws its inputs and a random cotangent from a numpy seed, and
compares the port's ``torch.autograd.grad`` with ``jax.grad`` of the JAX
function. Tolerances: both sides sum the same products in other orders in
fp32, so gradients agree to ~1e-6 relative; 1e-4 of each gradient's largest
magnitude leaves margin. Where the JAX gradient is exactly zero (zero
offsets, displacements on the window's edge) the port's must be exactly zero
too.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)

G = 2            # deform groups, as every SFM fuse_conv_1
WINDOW = 3
RTOL = 1e-4


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(grad)


def _close(got, ref, what):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _offsets(case, rng, n, s):
    """(n, s, s, 2*G*9) offsets: ``random`` reaches ±5 px (past the ±3
    window and off the plane), ``zero`` is every DCN's state at init,
    ``edge`` puts displacements on ±window, just inside and outside it, and
    on integers."""
    shape = (n, s, s, G, 9, 2)
    if case == 'random':
        return rng.uniform(-5, 5, shape).astype(np.float32).reshape(
            n, s, s, -1)
    if case == 'zero':
        return np.zeros((n, s, s, 2 * G * 9), np.float32)
    base = np.stack(np.meshgrid(np.arange(3) - 1.0, np.arange(3) - 1.0,
                                indexing='ij'), -1).reshape(9, 2)
    rel = rng.choice(np.asarray([-3.0, 3.0, -2.75, 2.75, -3.25, 3.25, 0.0,
                                 1.0, -2.0, 0.5], np.float32), shape)
    return (rel - base[None, None, None, None]).astype(np.float32).reshape(
        n, s, s, -1)


@functools.lru_cache(maxsize=None)
def _jax_dcn_grads():
    """Jitted ``jax.grad`` of both JAX forms (one compile per shape, shared
    by the offset cases)."""
    from dynamask_tpu.ops.deform_conv import deform_conv2d_windowed
    from dynamask_tpu.ops.deform_conv_pallas import deform_conv2d_rowmm_ad

    def loss_xla(x, o, w, ct):
        return jnp.sum(deform_conv2d_windowed(x, o, w, 3, 1, 1, 1, G,
                                              WINDOW) * ct)

    def loss_pallas(x, o, w, ct):
        return jnp.sum(deform_conv2d_rowmm_ad(x, o, w, 3, 1, 1, G, WINDOW,
                                              True) * ct)

    return {'xla': jax.jit(jax.grad(loss_xla, (0, 1, 2))),
            'pallas': jax.jit(jax.grad(loss_pallas, (0, 1, 2)))}


@pytest.mark.parametrize('case', ['random', 'zero', 'edge'])
@pytest.mark.parametrize('s,c', [(8, 16), (8, 32), (14, 16), (14, 32)])
def test_dcn_vjp_matches_jax(s, c, case):
    """d_x, d_offset and d_w of the port's ``deform_conv2d`` against
    ``jax.grad`` of ``deform_conv2d_windowed`` (XLA, analytic VJP) and of
    ``deform_conv2d_rowmm_ad`` (the Pallas forward and backward kernels in
    interpret mode)."""
    from dynamask_torch.ops.deform_conv import deform_conv2d
    rng = np.random.RandomState(s * 100 + c)
    n, c_out = 2, 24
    x = rng.randn(n, s, s, c).astype(np.float32)
    off = _offsets(case, rng, n, s)
    w = (rng.randn(3, 3, c, c_out) * 0.1).astype(np.float32)
    ct = rng.randn(n, s, s, c_out).astype(np.float32)

    args = (jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
            jnp.asarray(ct))
    refs = {k: fn(*args) for k, fn in _jax_dcn_grads().items()}

    xt, ot, wt = _t(x, True), _t(off, True), _t(w, True)
    out = deform_conv2d(xt, ot, wt, 3, 1, 1, 1, G, WINDOW)
    got = torch.autograd.grad(out, (xt, ot, wt), _t(ct))
    for name, ref in refs.items():
        for what, a, b in zip(('d_x', 'd_offset', 'd_w'), got, ref):
            _close(a.numpy(), b, f'{name} {what}')
    d_off_ref = [np.asarray(r[1]) for r in refs.values()]
    if case == 'zero':
        # the tent derivative is 0 at an integer displacement
        assert all(not r.any() for r in d_off_ref)
        assert not got[1].numpy().any()
    else:
        # exact zeros (outside, on or past the window edge, integer
        # displacements) are zero on both sides
        np.testing.assert_array_equal(got[1].numpy() == 0,
                                      d_off_ref[0] == 0)
        assert np.count_nonzero(d_off_ref[0]) > 0


def test_zero_offset_fault_and_fix():
    """The fault this port had: autograd of the ``floor``-based sampling
    (one-sided at an integer displacement) moves zero-initialised offsets,
    while JAX's tent derivative gives them exactly zero gradient. The
    autograd function reproduces JAX."""
    from dynamask_tpu.ops.deform_conv import deform_conv2d_windowed
    from dynamask_torch.ops.deform_conv import (
        deform_conv2d, deform_im2col_windowed_plain, im2col_weight)
    rng = np.random.RandomState(0)
    n, s, c = 2, 8, 8
    x = rng.randn(n, s, s, c).astype(np.float32)
    off = np.zeros((n, s, s, 2 * G * 9), np.float32)
    w = rng.randn(3, 3, c, c).astype(np.float32)
    ref = jax.grad(lambda o: jnp.sum(deform_conv2d_windowed(
        jnp.asarray(x), o, jnp.asarray(w), 3, 1, 1, 1, G, WINDOW)))(
            jnp.asarray(off))
    assert not np.asarray(ref).any()

    ot = _t(off, True)
    col = deform_im2col_windowed_plain(_t(x), ot, 3, 1, 1, G, WINDOW)
    w2 = im2col_weight(_t(w).permute(3, 2, 0, 1), G)
    floor_form = torch.autograd.grad(
        (col.reshape(n * s * s, -1) @ w2).sum(), ot)[0]
    assert floor_form.abs().max() > 1.0           # the fault
    fixed = torch.autograd.grad(
        deform_conv2d(_t(x), ot, _t(w), 3, 1, 1, 1, G, WINDOW).sum(), ot)[0]
    assert not fixed.numpy().any()                # the fix


def test_kernel_wrappers_refuse_to_cut_the_graph():
    """A raw kernel wrapper returns a tensor with no grad_fn, so it refuses
    inputs that need a gradient; the autograd functions carry it."""
    from dynamask_torch.ops.deform_conv import (deform_col2im_windowed,
                                                deform_im2col_windowed)
    from dynamask_torch.ops.roi_align import roi_align_fwd
    x = torch.zeros(1, 8, 8, 16, requires_grad=True)
    off = torch.zeros(1, 8, 8, 36)
    with pytest.raises(RuntimeError, match='gradient'):
        deform_im2col_windowed(x, off, 3, 1, 1, 2, 3)
    with pytest.raises(RuntimeError, match='gradient'):
        deform_col2im_windowed(x, off, torch.zeros(1, 8, 8, 2, 9, 8))
    n = 2
    with pytest.raises(RuntimeError, match='gradient'):
        roi_align_fwd(torch.zeros(64, 4, requires_grad=True),
                      torch.zeros(n, 4), torch.zeros(n, dtype=torch.int64),
                      torch.full((n,), 8, dtype=torch.int32),
                      torch.full((n,), 8, dtype=torch.int32),
                      torch.ones(n), 7, 2)
    with torch.no_grad():
        assert deform_im2col_windowed(x, off, 3, 1, 1, 2, 3).shape == (
            1, 8, 8, 2, 9, 8)


def test_cuda_wrappers_do_not_fall_back():
    """K3 and K4 take no tensor that is neither on the CPU nor on a CUDA
    device: the plain versions run only for CPU tensors."""
    from dynamask_torch.ops.deform_conv import deform_col2im_windowed
    from dynamask_torch.ops.roi_align import roi_align_bwd
    m = torch.device('meta')
    with pytest.raises(ValueError):
        deform_col2im_windowed(torch.empty(1, 8, 8, 16, device=m),
                               torch.empty(1, 8, 8, 36, device=m),
                               torch.empty(1, 8, 8, 2, 9, 8, device=m),
                               3, 1, 1, 2, 3)
    with pytest.raises(ValueError):
        roi_align_bwd(torch.empty(2, 7, 7, 4, device=m), 64,
                      torch.empty(2, 4, device=m),
                      torch.empty(2, dtype=torch.int64, device=m),
                      torch.empty(2, dtype=torch.int32, device=m),
                      torch.empty(2, dtype=torch.int32, device=m),
                      torch.empty(2, device=m), 7, 2)


# RoIs on every level, partly outside, zero-area and very wide
ROIS = np.asarray([[16.3, 16.1, 80.2, 90.7], [8.4, 8.2, 140.6, 150.3],
                   [4.1, 4.3, 250.2, 255.9], [0.2, 0.6, 380.5, 250.1],
                   [-20.3, -10.7, 30.2, 44.1], [40.5, 40.5, 40.5, 40.5],
                   [0.3, 10.2, 380.4, 30.6], [350.1, 230.4, 420.8, 270.2]],
                  np.float32)
BATCH = np.asarray([0, 1, 0, 1, 0, 1, 0, 1], np.int64)
STRIDES = (4, 8, 16, 32)


@pytest.mark.parametrize('ratio', [1, 2])
@pytest.mark.parametrize('form', ['single', 'multilevel'])
def test_roi_align_feature_grad_matches_jax(form, ratio):
    """The feature gradient of the port's RoIAlign (K4's plain version)
    against ``jax.grad`` of the XLA forms."""
    jra = importlib.import_module('dynamask_tpu.ops.roi_align')
    ra = importlib.import_module('dynamask_torch.ops.roi_align')
    rng = np.random.RandomState(ratio)
    c = 8
    feats = [rng.randn(2, 64 >> i, 96 >> i, c).astype(np.float32)
             for i in range(4)]
    rb = BATCH.astype(np.int32)
    p = 7 if form == 'multilevel' else 14
    ct = rng.randn(len(ROIS), p, p, c).astype(np.float32)
    if form == 'single':
        feats = feats[:1]

        def jfn(fs):
            return jra.roi_align(fs[0], jnp.asarray(ROIS), jnp.asarray(rb),
                                 p, 0.25, sampling_ratio=ratio)

        def tfn(fs):
            return ra.roi_align(fs[0], _t(ROIS), _t(BATCH), p, 0.25,
                                sampling_ratio=ratio)
    else:
        def jfn(fs):
            return jra.multilevel_roi_align(fs, jnp.asarray(ROIS),
                                            jnp.asarray(rb), p, STRIDES,
                                            sampling_ratio=ratio)

        def tfn(fs):
            return ra.multilevel_roi_align(fs, _t(ROIS), _t(BATCH), p,
                                           STRIDES, sampling_ratio=ratio)
    ref = jax.grad(lambda fs: jnp.sum(jfn(fs) * ct))(
        [jnp.asarray(f) for f in feats])
    ft = [_t(f, True) for f in feats]
    got = torch.autograd.grad(tfn(ft), ft, _t(ct))
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a.numpy(), b, f'level {i}')
    assert any(np.abs(np.asarray(r)).sum() > 0 for r in ref)
