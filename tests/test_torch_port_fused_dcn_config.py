"""K5's launch configuration and weight matrix (``ops.deform_conv_fused``),
on the CPU, without JAX.

The wrapper hands the kernel a tile, a vector width, a grid, its dynamic
shared memory and a weight matrix padded to the tiles. These tests hold the
configuration at every SFM shape the port gives K5 (n = 100 and 512) and at
``chip_smoke.K5_EDGE_SHAPES``: it fits a block's shared memory, its grid
covers every output pixel and channel once, and the flagship's 14x14x256
stage at n = 100 fills the H100's 132 SMs. They replay the kernel's walk
over K (deform group, tap, chunk of channels, each chunk's tail zero) with
the padded matrix in plain torch against the plain version, and check the
claim the tensor-core instance rests on: for bf16 operands, one rounding of
the exact sum or product (the packed bf16 instructions) equals the plain
version's fp32 result rounded to bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from chip_smoke import (K5_EDGE_SHAPES, N_DETS, N_POS_TRAIN,  # noqa: E402
                        SFM_STAGES)
from dynamask_torch.ops import deform_conv_fused as dcf  # noqa: E402

torch.set_num_threads(2)

SMEM_PER_BLOCK = 232_448        # the H100's shared memory a block may take
SMS = 132
RULES = [(torch.float32, False), (torch.float32, True),
         (torch.bfloat16, False), (torch.bfloat16, True)]
# (n, S, C, C_out, g) of the SFM stages at both n and of the edge shapes
SHAPES = ([(n, s, c, c, 2) for n in (N_DETS, N_POS_TRAIN)
           for s, c in SFM_STAGES] +
          [shape[:5] for shape in K5_EDGE_SHAPES])


@pytest.mark.parametrize('dtype,rule', RULES,
                         ids=['f32', 'f32_frame', 'bf16', 'bf16_frame'])
@pytest.mark.parametrize('shape', SHAPES,
                         ids=lambda s: 'n{}_S{}_C{}_Cout{}_g{}'.format(*s))
def test_launch_config(shape, dtype, rule):
    """The tile fits a block's shared memory (the C function refuses any
    other byte count); the grid covers the pixels and output channels with
    no block past the end; the padded weight rows hold whole chunks; the
    tensor cores take the frame rule on bf16 only; 16-byte corner loads only
    where the group's channels come in such runs."""
    n, s, c, c_out, g = shape
    cfg = dcf.k5_launch_config(n, s, c, c_out, g, dtype, rule)
    mma = dtype == torch.bfloat16 and rule
    assert cfg['kernel'] == ('mma' if mma else 'fma')
    assert 0 < cfg['smem_bytes'] <= SMEM_PER_BLOCK
    elem = 2 if mma else 4
    assert cfg['smem_bytes'] == cfg['stages'] * elem * (
        cfg['bm'] * cfg['bk'] + cfg['bk'] * cfg['bn'] +
        (0 if mma else cfg['bk'] * dcf.K5_APAD))
    gx, gy = cfg['grid']
    m = n * s * s
    assert (gx - 1) * cfg['bm'] < m <= gx * cfg['bm']
    assert (gy - 1) * cfg['bn'] < c_out <= gy * cfg['bn']
    assert cfg['c_out_pad'] == gy * cfg['bn']
    cg = c // g
    assert cfg['cg_pad'] % cfg['bk'] == 0
    assert cg <= cfg['cg_pad'] < cg + cfg['bk']
    assert cfg['chunks'] == g * 9 * cfg['cg_pad'] // cfg['bk']
    run = 8 if mma else 4
    assert cfg['vec'] == (cg % run == 0)
    assert not dcf.k5_launch_config(n, s, c, c_out, g, dtype, rule,
                                    aligned=False)['vec']
    if (n, s, c) == (N_DETS, 14, 256):
        assert gx * gy >= SMS


def _inputs(n, s, c, c_out, g, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, s, s, c).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-5, 5, (n, s, s, 18 * g)).astype(
        np.float32))
    w = torch.from_numpy((rng.randn(3, 3, c, c_out) / np.sqrt(9 * c))
                         .astype(np.float32))
    return x, off, w


@pytest.mark.parametrize('shape', [(1, 6, 16, 8, 2), (1, 5, 40, 70, 2),
                                   (1, 4, 8, 3, 2), (1, 4, 64, 130, 1)],
                         ids=lambda s: 'C{}_Cout{}_g{}'.format(*s[2:]))
@pytest.mark.parametrize('dtype,rule', RULES[::2] + RULES[3:],
                         ids=['f32', 'bf16', 'bf16_frame'])
def test_weight_matrix(shape, dtype, rule):
    """The matrix the wrapper makes: the plain version's weight rows (under
    the frame rule on bf16 its ``rnd(w2)``, rounded once a call) in each
    (group, tap)'s first cg rows and the first C_out columns, zeros in the
    padding."""
    n, s, c, c_out, g = shape
    _, _, w = _inputs(*shape)
    cfg = dcf.k5_launch_config(n, s, c, c_out, g, dtype, rule)
    mat = dcf.k5_weight_matrix(w, g, cfg)
    assert mat.dtype == (torch.bfloat16 if rule and dtype == torch.bfloat16
                         else torch.float32)
    assert tuple(mat.shape) == (g * 9 * cfg['cg_pad'], cfg['c_out_pad'])
    cg = c // g
    rows = dcf._hwio_to_rows(w, g)
    plain = rows.to(dtype).float() if rule else rows
    blocks = mat.float().reshape(g * 9, cfg['cg_pad'], cfg['c_out_pad'])
    assert torch.equal(blocks[:, :cg, :c_out].reshape(-1, c_out), plain)
    assert not blocks[:, cg:].any() and not blocks[:, :, c_out:].any()


@pytest.mark.parametrize('shape', [(2, 6, 16, 8, 2), (1, 5, 40, 70, 2),
                                   (1, 4, 8, 3, 2)],
                         ids=lambda s: 'C{}_Cout{}_g{}'.format(*s[2:]))
@pytest.mark.parametrize('dtype,rule', RULES[::2] + RULES[3:],
                         ids=['f32', 'bf16', 'bf16_frame'])
def test_chunk_walk_replays_the_plain_version(shape, dtype, rule):
    """The kernel's contraction in plain torch: the samples of each (group,
    tap) padded with zero channels to whole chunks, in the walk's order,
    times the padded matrix, summed in fp32, the padded columns dropped;
    against the plain version (fp32: 1e-5 x max|ref|; bf16: one bf16 ulp of
    max|ref|, as ``chip_smoke.k5_limit``)."""
    from dynamask_torch.ops.deform_conv import _corner_index, _geometry, \
        _padded
    n, s, c, c_out, g = shape
    x, off, w = _inputs(*shape, seed=1)
    x = x.to(dtype)
    cfg = dcf.k5_launch_config(n, s, c, c_out, g, dtype, rule)
    ref = dcf.deform_conv2d_fused_plain(x, off, w, 3, 1, 1, g, 3,
                                        round_to_input=rule)
    # the samples, as the plain version makes them
    _, _, ins, _, _, fy, fx, (wy0, wy1), (wx0, wx1) = _geometry(
        off, s, s, 3, 1, 1, g, 3)
    idx, step = _corner_index(n, s, s, g, fy, fx, 3)
    xg = _padded(x, 3, g)
    rnd = (lambda t: t.to(dtype).float()) if rule else (lambda t: t)
    e = (lambda t: t[..., None])
    wx0, wx1 = e(rnd(wx0)), e(rnd(wx1))
    wy0, wy1 = e(rnd(wy0 * ins)), e(rnd(wy1 * ins))
    row0 = rnd(rnd(xg[idx] * wx0) + rnd(xg[idx + g] * wx1))
    row1 = rnd(rnd(xg[idx + step] * wx0) + rnd(xg[idx + step + g] * wx1))
    col = rnd(rnd(row0 * wy0) + rnd(row1 * wy1))      # (n, s, s, g, 9, cg)
    cg = c // g
    padded = torch.zeros(n * s * s, g * 9, cfg['cg_pad'])
    padded[:, :, :cg] = col.reshape(n * s * s, g * 9, cg)
    mat = dcf.k5_weight_matrix(w, g, cfg).float()
    acc = torch.zeros(n * s * s, cfg['c_out_pad'])
    chunks = padded.reshape(n * s * s, cfg['chunks'], cfg['bk'])
    for i in range(cfg['chunks']):
        acc += chunks[:, i] @ mat[i * cfg['bk']:(i + 1) * cfg['bk']]
    got = acc[:, :c_out].reshape(n, s, s, c_out).to(dtype)
    scale = ref.float().abs().max().item()
    limit = (2.0 ** (np.floor(np.log2(scale)) - 7) if dtype ==
             torch.bfloat16 else 1e-5 * scale)
    assert (got.float() - ref.float()).abs().max().item() <= limit


def _bf16_values(rng, size):
    """bf16 values (as float64) of random sign, mantissa and exponent in
    [-40, 40]: neighbours and far-apart magnitudes both."""
    mant = rng.randint(128, 256, size) / 128.0
    return (rng.choice([-1.0, 1.0], size) * mant *
            np.exp2(rng.randint(-40, 41, size)))


def _round_bf16(v):
    """Round float64 values once to bf16 (8 significant bits, ties to
    even): what one packed bf16 instruction gives."""
    m, ex = np.frexp(v)
    return np.ldexp(np.rint(m * 256.0) / 256.0, ex)


def test_packed_bf16_rounding_is_the_frame_rule():
    """``__hmul2_rn`` and ``__hadd2_rn`` round the exact product or sum of
    two bf16 values once; the plain version computes it in fp32 and rounds
    that to bf16. The product of two bf16 values is exact in fp32, and a
    sum is exact unless the magnitudes lie 2^16 apart, where the smaller
    cannot move the larger's bf16 rounding: the two agree bit for bit."""
    rng = np.random.RandomState(0)
    a, b = _bf16_values(rng, 200_000), _bf16_values(rng, 200_000)
    b[:50_000] = -a[:50_000] * (1 + rng.randint(-2, 3, 50_000) / 128.0)
    for exact in (a * b, a + b):
        once = _round_bf16(exact)
        plain = torch.from_numpy(exact.astype(np.float32)).to(
            torch.bfloat16).double().numpy()
        np.testing.assert_array_equal(once, plain)
