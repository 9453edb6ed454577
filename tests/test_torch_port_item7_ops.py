"""The backbones' deformable convs of the port against the JAX package, on
the CPU: the exact gather (``deform_conv2d_exact``, JAX
``deform_conv2d(window=None[, mask])``) and the windowed DCNv2
(``modulated_deform_conv2d``), forward and every gradient (input,
offsets, mask, weights), and ``layers.DeformConv2dPack`` choosing between
them by the map's shape as JAX's ResNet does.

Inputs and a cotangent are drawn from a numpy seed; the gradients are
``torch.autograd.grad`` against ``jax.grad`` of the JAX function. Both
sides sum the same fp32 products in other orders, so outputs and
gradients agree to ~1e-7 relative; the tolerance is 1e-5 relative L2
(``RL2``). The cases cover DCNv1 and v2, stride 1 and 2, 1 and 4 deform
groups, C/g <= 64 and > 64 (JAX's pair-packed and per-corner tables,
``dynamask_tpu/ops/deform_conv.py:455-479``), offsets past ±3 and off the
plane, integer offsets, square and non-square maps.

At an integer sample position (every offset at its zero init) the
gradient is JAX's tie rule (ROADMAP.md queue 3, 3ak), held here against
JAX's value and shown to differ from the one-sided slopes mmcv's kernel or
a finite difference would take.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)

RL2 = 1e-5


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _inputs(n, h, w, c, c_out, g, ho, wo, offsets, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    shape = (n, ho, wo, 2 * g * 9)
    if offsets == 'large':           # past ±3 and off the plane
        off = rng.uniform(-5, 5, shape)
    elif offsets == 'integer':       # every sample on the grid
        off = rng.randint(-4, 5, shape)
    else:
        off = np.zeros(shape)
    mask = 1 / (1 + np.exp(-rng.randn(n, ho, wo, g * 9)))
    wt = rng.randn(3, 3, c, c_out) / np.sqrt(9 * c)
    cot = rng.randn(n, ho, wo, c_out)
    return [a.astype(np.float32) for a in (x, off, mask, wt, cot)]


def _jax_exact(stride, g, modulated, dilation=1):
    from dynamask_tpu.ops.deform_conv import deform_conv2d

    def f(x, off, mask, wt):
        return deform_conv2d(x, off, wt, kernel_size=3, stride=stride,
                             padding=dilation, dilation=dilation,
                             deform_groups=g, window=None, roi_chunk=0,
                             mask=mask if modulated else None)
    return f


def _jax_windowed(g):
    from dynamask_tpu.ops.deform_conv import modulated_deform_conv2d

    def f(x, off, mask, wt):
        return modulated_deform_conv2d(x, off, mask, wt, kernel_size=3,
                                       padding=1, dilation=1,
                                       deform_groups=g)
    return f


def _port(fn, args, cot, argnums):
    ts = [torch.from_numpy(a).requires_grad_(i in argnums)
          for i, a in enumerate(args)]
    out = fn(*ts)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [ts[i] for i in argnums])
    return out.detach().numpy(), [g.numpy() for g in grads]


def _reference(f, args, cot, argnums):
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * cot),
                             argnums=argnums))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check(got, ref, names):
    out, grads = got
    rout, rgrads = ref
    assert out.shape == rout.shape
    assert rel_l2(out, rout) < RL2, rel_l2(out, rout)
    for name, a, b in zip(names, grads, rgrads):
        assert np.abs(b).max() > 0, name
        assert rel_l2(a, b) < RL2, (name, rel_l2(a, b))


# (modulated, stride, deform groups, C, (H, W), dilation): C/g 16 and 8
# take JAX's pair-packed table, 160 and 72 its per-corner one
EXACT = {
    'v1_s1_g1_pair': (False, 1, 1, 16, (7, 9), 1),
    'v1_s2_g4_pair': (False, 2, 4, 32, (8, 8), 1),
    'v1_s1_g1_dil2': (False, 1, 1, 16, (9, 7), 2),
    'v2_s1_g1_wide': (True, 1, 1, 160, (6, 7), 1),
    'v2_s2_g4_wide': (True, 2, 4, 288, (7, 6), 1),
    'v2_s1_g4_square': (True, 1, 4, 32, (8, 8), 1),
}


@pytest.mark.parametrize('offsets', ['large', 'integer'])
@pytest.mark.parametrize('case', sorted(EXACT))
def test_exact_gather_matches_jax(case, offsets):
    """Forward and the gradients in x, the offsets, the mask (DCNv2) and
    the weights."""
    from dynamask_torch.ops.deform_conv import deform_conv2d_exact
    modulated, stride, g, c, (h, w), dil = EXACT[case]
    ho = (h - 1) // stride + 1
    wo = (w - 1) // stride + 1
    x, off, mask, wt, cot = _inputs(2, h, w, c, 5, g, ho, wo, offsets,
                                    seed=len(case))
    args = [x, off, mask, wt]
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 3)
    ref = _reference(_jax_exact(stride, g, modulated, dil), args, cot,
                     argnums)

    def port(x, off, mask, wt):
        return deform_conv2d_exact(x, off, wt, mask if modulated else None,
                                   3, stride, dil, dil, g)
    got = _port(port, args, cot, argnums)
    _check(got, ref, [('x', 'offsets', 'mask', 'weights')[i]
                      for i in argnums])


@pytest.mark.parametrize('offsets', ['large', 'integer', 'bounds'])
@pytest.mark.parametrize('g', [1, 4])
def test_windowed_dcnv2_matches_jax(g, offsets):
    """JAX's windowed DCNv2 with offsets past its ±3 window, on the grid,
    and with displacements exactly on the window's bounds (where JAX's
    clip passes half the gradient)."""
    from dynamask_torch.ops.deform_conv import modulated_deform_conv2d
    if offsets == 'bounds':
        x, off, mask, wt, cot = _inputs(2, 8, 8, 8 * g, 5, g, 8, 8, 'zero',
                                        seed=g)
        rng = np.random.RandomState(g)
        rel = rng.choice([-3.0, 3.0, -3.5, 3.5, 2.5, 0.0], off.shape)
        tap = np.stack(np.meshgrid(np.arange(3) - 1.0, np.arange(3) - 1.0,
                                   indexing='ij'), -1).reshape(1, 9, 2)
        off = (rel.reshape(2, 8, 8, g, 9, 2) - tap).astype(
            np.float32).reshape(off.shape)
    else:
        x, off, mask, wt, cot = _inputs(2, 8, 8, 8 * g, 5, g, 8, 8, offsets,
                                        seed=g)
    args = [x, off, mask, wt]
    ref = _reference(_jax_windowed(g), args, cot, (0, 1, 2, 3))
    got = _port(lambda x, o, m, w: modulated_deform_conv2d(x, o, m, w, 3, 1,
                                                           1, g),
                args, cot, (0, 1, 2, 3))
    _check(got, ref, ['x', 'offsets', 'mask', 'weights'])


# -- 3ak: the offset gradient at an integer sample position ------------------

def _loss64(x, off, wt, cot, stride=1):
    """sum(out * cot) of the port's exact gather, in float64 values."""
    from dynamask_torch.ops.deform_conv import deform_conv2d_exact
    with torch.no_grad():
        out = deform_conv2d_exact(torch.from_numpy(x).double(),
                                  torch.from_numpy(off),
                                  torch.from_numpy(wt).double(), None, 3,
                                  stride)
    return float((out * torch.from_numpy(cot).double()).sum())


def test_tie_rule_at_zero_offsets_3ak():
    """ROADMAP.md queue 3, 3ak: a 1x6x7x4 input, 5 output channels, zero
    offsets. JAX's gradient of offset channel 0 (tap (0, 0), dy) at
    output (3, 4) is neither the slope to the right (mmcv's rule, the far
    corner minus the near one) nor the slope to the left, and the offset
    gradient is not zero (3f does not hold for the exact gather). The
    port gives JAX's value, everywhere within 1e-5."""
    from dynamask_torch.ops.deform_conv import deform_conv2d_exact
    rng = np.random.RandomState(0)
    x = rng.randn(1, 6, 7, 4).astype(np.float32)
    wt = rng.randn(3, 3, 4, 5).astype(np.float32)
    cot = rng.randn(1, 6, 7, 5).astype(np.float32)
    off = np.zeros((1, 6, 7, 18), np.float32)
    _, (ref,) = _reference(_jax_exact(1, 1, False),
                           [x, off, off[..., :9], wt], cot, (1,))
    _, (got,) = _port(lambda x, o, w: deform_conv2d_exact(x, o, w),
                      [x, off, wt], cot, (1,))
    assert rel_l2(got, ref) < RL2
    assert np.abs(ref).max() > 1.0          # not zero: 3f does not hold here
    h = 2.0 ** -10
    base = _loss64(x, off, wt, cot)
    step = np.zeros_like(off)
    step[0, 3, 4, 0] = h
    right = (_loss64(x, off + step, wt, cot) - base) / h
    left = (base - _loss64(x, off - step, wt, cot)) / h
    jax_value = ref[0, 3, 4, 0]
    assert min(abs(jax_value - right), abs(jax_value - left),
               abs(right - left)) > 0.1, (jax_value, right, left)
    np.testing.assert_allclose(got[0, 3, 4, 0], jax_value, rtol=1e-5)


@pytest.mark.parametrize('stride', [1, 2])
def test_tie_rule_at_integer_offsets_3ak(stride):
    """On integer offsets (every sample on the grid) the port's offset
    gradient is JAX's and differs from the right-hand slope, which the
    finite difference gives, on most entries."""
    from dynamask_torch.ops.deform_conv import deform_conv2d_exact
    ho = (9 - 1) // stride + 1
    x, off, _, wt, cot = _inputs(1, 9, 9, 4, 3, 1, ho, ho, 'integer',
                                 seed=5 + stride)
    _, (ref,) = _reference(_jax_exact(stride, 1, False),
                           [x, off, off[..., :9], wt], cot, (1,))
    _, (got,) = _port(lambda x, o, w: deform_conv2d_exact(
        x, o, w, None, 3, stride), [x, off, wt], cot, (1,))
    assert rel_l2(got, ref) < RL2
    h = 2.0 ** -10
    base = _loss64(x, off, wt, cot, stride)
    rng = np.random.RandomState(stride)
    differ = 0
    for idx in zip(*[rng.randint(0, s, 12) for s in off.shape]):
        step = np.zeros_like(off)
        step[idx] = h
        right = (_loss64(x, off + step, wt, cot, stride) - base) / h
        differ += abs(right - ref[idx]) > 1e-3 * (1 + abs(right))
    assert differ >= 6, differ


# -- the module: the DCNv2 form by the map's shape (3am) ---------------------

@pytest.mark.parametrize('hw,stride', [((8, 8), 1), ((8, 10), 1),
                                       ((8, 8), 2)])
def test_module_picks_the_form_by_shape_3am(hw, stride):
    """``DeformConv2dPack(modulated, square_window)`` is JAX's windowed
    form on a square map at stride 1 and the exact gather with the mask
    on any other; with offsets past ±3 the two differ on the square
    map."""
    from dynamask_torch.models.layers import DeformConv2dPack, to_nhwc
    from dynamask_torch.ops.deform_conv import (deform_conv2d_exact,
                                                modulated_deform_conv2d)
    torch.manual_seed(0)
    m = DeformConv2dPack(8, 6, stride, deform_groups=2, modulated=True,
                         square_window=True)
    with torch.no_grad():
        m.weight.normal_(0, 0.2)
        m.conv_offset.weight.normal_(0, 1.0)
        m.conv_offset.bias.uniform_(-6, 6)
    x = torch.randn(2, 8, *hw)
    with torch.no_grad():
        got = m(x).permute(0, 2, 3, 1)
        off = to_nhwc(m.conv_offset(x))
        args = (to_nhwc(x), off[..., :36], torch.sigmoid(off[..., 36:]),
                m.dense_weight())
        windowed = hw[0] == hw[1] and stride == 1
        exact = deform_conv2d_exact(args[0], args[1], args[3], args[2], 3,
                                    stride, 1, 1, 2)
        if windowed:
            want = modulated_deform_conv2d(*args, 3, 1, 1, 2)
            assert rel_l2(exact, want) > 1e-2
        else:
            want = exact
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_grouped_module_is_the_block_diagonal_dense_conv():
    """With ``groups`` and zero offsets, the module is the grouped conv of
    its weight (RegNet's mdconv at init, JAX's block-diagonal kernel)."""
    from dynamask_torch.models.layers import DeformConv2dPack
    torch.manual_seed(1)
    m = DeformConv2dPack(12, 12, 2, groups=4, modulated=True)
    with torch.no_grad():
        m.weight.normal_()
        m.conv_offset.weight.zero_()
        m.conv_offset.bias.zero_()
        m.conv_offset.bias[18:] = 30.0          # the mask's sigmoid at 1
        x = torch.randn(1, 12, 7, 9)
        want = torch.nn.functional.conv2d(x, m.weight, None, 2, 1, 1, 4)
        np.testing.assert_allclose(m(x).numpy(), want.numpy(), atol=1e-5)
