"""The port's fused windowed-DCN forward (kernel K5's plain version and its
two entry points) against the JAX package's two whole-DCN Pallas kernels,
on the CPU.

``deform_conv2d_windowed_pallas`` (the plane kernel) and
``deform_conv2d_frame`` (the frame kernel) run in interpret mode, at n = 2,
S = 10, C = 16. Each JAX function compiles once per shape, dtype and
static argument set, and the frame kernel's compile takes 10-15 s against
the plane kernel's 1.5 s; the offset cases of one geometry share a
compile. So the frame kernel is compiled three times: fp32 at g = 2, fp32
at g = 1 with padding 2 and dilation 2, and bf16 at g = 1. On the CPU the
entry points run the plain version; chip_smoke.py holds K5 against it on
the GPU.

Tolerances: in fp32 both sides sample the same points and sum the same
products in other orders, 1e-5 absolute as ``tests/test_ops.py`` holds the
JAX kernels to each other. In bf16 the plane rule computes in fp32 and
rounds once, so the port must come within one bf16 ulp of max|ref|; the
frame rule rounds at every sampling step, where XLA on the CPU may keep
more precision than bf16 between two operations, so within 2e-2 x max|ref|.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)

N, S, C, C_OUT = 2, 10, 16, 8
# (deform groups, padding, dilation) of each compiled fp32 case
GEOMETRIES = {'g2': (2, 1, 1), 'g1_pad2_dil2': (1, 2, 2)}
FP32_ATOL = 1e-5


def _inputs(offsets, g, seed=0):
    """x (N, S, S, C), offsets (N, S, S, 2*g*9) and HWIO weights from a
    numpy seed. ``random`` offsets reach ±5 px, past the ±3 window and off
    the plane; ``integer`` ones put every sample on a pixel."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, S, S, C).astype(np.float32)
    shape = (N, S, S, 2 * g * 9)
    off = {'random': lambda: rng.uniform(-5, 5, shape),
           'zero': lambda: np.zeros(shape),
           'integer': lambda: rng.randint(-5, 6, shape)}[offsets]()
    w = rng.randn(3, 3, C, C_OUT) * 0.1
    return x, off.astype(np.float32), w.astype(np.float32)


def _jax(rule, x, off, w, g, pad, dil, dtype=jnp.float32):
    from dynamask_tpu.ops.deform_conv_pallas import (
        deform_conv2d_frame, deform_conv2d_windowed_pallas)
    fn = {'plane': deform_conv2d_windowed_pallas,
          'frame': deform_conv2d_frame}[rule]
    out = fn(jnp.asarray(x).astype(dtype), jnp.asarray(off), jnp.asarray(w),
             kernel_size=3, padding=pad, dilation=dil, deform_groups=g,
             window=3, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _plain(x, off, w, g, pad, dil, round_to_input, dtype=torch.float32):
    from dynamask_torch.ops.deform_conv_fused import deform_conv2d_fused_plain
    out = deform_conv2d_fused_plain(
        torch.from_numpy(x).to(dtype), torch.from_numpy(off),
        torch.from_numpy(w), 3, pad, dil, g, 3,
        round_to_input=round_to_input)
    assert out.dtype == dtype and tuple(out.shape) == (N, S, S, C_OUT)
    return out.float().numpy()


@pytest.mark.parametrize('rule,geometry,offsets', [
    (rule, geometry, offsets)
    for rule in ('plane', 'frame') for geometry in GEOMETRIES
    for offsets in ('random', 'zero', 'integer')])
def test_plain_fp32_matches_jax(rule, geometry, offsets):
    """Both rounding rules of the plain version in fp32 against the JAX
    kernel of each rule: in fp32 the two rules are one function."""
    g, pad, dil = GEOMETRIES[geometry]
    x, off, w = _inputs(offsets, g)
    ref = _jax(rule, x, off, w, g, pad, dil)
    for round_to_input in (False, True):
        np.testing.assert_allclose(
            _plain(x, off, w, g, pad, dil, round_to_input), ref,
            atol=FP32_ATOL, err_msg=f'round_to_input={round_to_input}')


def test_plain_bf16_plane_rule_matches_jax():
    """bf16 ``x``, the plane kernel's rule (fp32 throughout, one cast):
    within one bf16 ulp of max|ref| (the two sides round one fp32 result
    each; measured: exactly equal here)."""
    x, off, w = _inputs('random', 1, seed=1)
    ref = _jax('plane', x, off, w, 1, 1, 1, jnp.bfloat16)
    got = _plain(x, off, w, 1, 1, 1, False, torch.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(got - ref).max() <= ulp


def test_plain_bf16_frame_rule_matches_jax():
    """bf16 ``x``, the frame kernel's rule: within 2e-2 x max|ref| of the
    JAX frame kernel (measured: one bf16 ulp of max|ref| 2.81, 5.6e-3 of
    it), and on average nearer to it than the plane rule is (measured: mean
    abs error 1.03e-3 against 1.71e-3), so the rounding points are the
    frame kernel's."""
    x, off, w = _inputs('random', 1, seed=1)
    ref = _jax('frame', x, off, w, 1, 1, 1, jnp.bfloat16)
    frame = _plain(x, off, w, 1, 1, 1, True, torch.bfloat16)
    plane = _plain(x, off, w, 1, 1, 1, False, torch.bfloat16)
    assert np.abs(frame - ref).max() <= 2e-2 * np.abs(ref).max()
    assert np.abs(frame - ref).mean() < np.abs(plane - ref).mean()
    assert not np.array_equal(frame, plane)


@pytest.mark.parametrize('g', [1, 2])
def test_plain_matches_port_deform_conv2d(g):
    """K5's plain version against the port's main-path form of the same
    function, K1's plain version + ``torch.matmul``
    (``ops.deform_conv.deform_conv2d``), fp32, 1e-5 relative."""
    from dynamask_torch.ops.deform_conv import deform_conv2d
    x, off, w = _inputs('random', g, seed=2)
    ref = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                        torch.from_numpy(w), deform_groups=g,
                        window=3).numpy()
    got = _plain(x, off, w, g, 1, 1, False)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('entry', ['deform_conv2d_windowed_fused',
                                   'deform_conv2d_frame'])
def test_entry_points_on_cpu_run_the_plain_version(entry, dtype):
    import dynamask_torch.ops as ops
    from dynamask_torch.ops.deform_conv_fused import deform_conv2d_fused_plain
    fn = getattr(ops, entry)
    x, off, w = _inputs('random', 2, seed=3)
    x, off, w = (torch.from_numpy(x).to(dtype), torch.from_numpy(off),
                 torch.from_numpy(w))
    before = fn.launches
    got = fn(x, off, w, 3, 1, 1, 2, 3)
    ref = deform_conv2d_fused_plain(
        x, off, w, 3, 1, 1, 2, 3,
        round_to_input=entry == 'deform_conv2d_frame')
    assert got.dtype == dtype and torch.equal(got, ref)
    assert fn.launches == before        # the plain version is no launch
    assert ops.KERNELS[entry] is fn


@pytest.mark.parametrize('entry', ['deform_conv2d_windowed_fused',
                                   'deform_conv2d_frame'])
def test_entry_points_keep_the_jax_contract(entry):
    """Non-square planes, an unbounded window, inputs that need a gradient
    and wrong offsets raise; a tensor on neither the CPU nor a GPU does
    not fall back to the plain version."""
    import dynamask_torch.ops as ops
    fn = getattr(ops, entry)
    x, off, w = (torch.from_numpy(a) for a in _inputs('random', 2))
    with pytest.raises(ValueError, match='square'):
        fn(x[:, :, :8].contiguous(), off[:, :, :8].contiguous(), w,
           deform_groups=2)
    with pytest.raises(ValueError, match='bounded window'):
        fn(x, off, w, deform_groups=2, window=None)
    with pytest.raises(ValueError, match='offsets'):
        fn(x, off[..., :18], w, deform_groups=2)
    with pytest.raises(RuntimeError, match='no gradient'):
        fn(x.requires_grad_(), off, w, deform_groups=2)
    m = torch.device('meta')
    with pytest.raises(ValueError, match='CUDA'):
        fn(torch.empty(1, 8, 8, 16, device=m),
           torch.empty(1, 8, 8, 36, device=m),
           torch.empty(3, 3, 16, 8, device=m), deform_groups=2)
