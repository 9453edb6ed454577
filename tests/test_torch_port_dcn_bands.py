"""The band design of K1 and K3 (``dynamask_torch/ops/csrc/deform_im2col.cu``
and ``deform_col2im.cu``), on the CPU.

Both kernels give one block a band of output rows, and K3 adds the band's
``d_x`` into the band's rows widened by a halo, which the blocks in flight
share in L2. That rests on a property of the windowed DCN: the clip bounds
every corner with a non-zero weight of output pixel (y, x) to rows and
columns [y - window, y + window + 1]. The tests hold the port's geometry to
that property, check the launch configuration the wrappers hand the kernels
at every shape the port runs and at the edge shapes ``chip_smoke.py`` checks
on the card, and replay K3 band by band, each band into its own halo tile,
in plain torch against the plain version and against ``jax.grad`` of the
JAX windowed DCN.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

from dynamask_torch.ops import deform_conv as dc   # noqa: E402

torch.set_num_threads(2)


def _offsets(rng, n, s, g, k, padding, dilation, window):
    """(n, s, s, 2*g*k*k) offsets up to ±10 px; a third of the
    displacements set to exactly ±window and a third to integers."""
    shape = (n, s, s, g, k * k, 2)
    off = rng.uniform(-10, 10, shape).astype(np.float32)
    base = np.arange(k) * dilation - padding
    tap = np.stack(np.meshgrid(base, base, indexing='ij'), -1).reshape(
        k * k, 2).astype(np.float32)
    pick = rng.randint(0, 3, shape)
    exact = np.where(rng.rand(*shape) < 0.5, -window, window).astype(
        np.float32) - tap
    whole = rng.randint(-10, 11, shape).astype(np.float32) - tap
    off = np.where(pick == 1, exact, np.where(pick == 2, whole, off))
    return torch.from_numpy(off.reshape(n, s, s, -1).astype(np.float32))


@pytest.mark.parametrize('padding,dilation,window',
                         [(1, 1, 3), (2, 2, 3), (1, 1, 1), (1, 1, 2),
                          (3, 3, 3)])
def test_corners_lie_in_the_band(padding, dilation, window):
    """Every corner with a non-zero weight of an inside sample of output
    pixel (y, x) lies in rows and columns [y - window, y + window + 1]."""
    rng = np.random.RandomState(window * 10 + padding)
    n, s, g, k = 2, 12, 2, 3
    off = _offsets(rng, n, s, g, k, padding, dilation, window)
    _, _, ins, _, _, fy, fx, (wy0, wy1), (wx0, wx1) = dc._geometry(
        off, s, s, k, padding, dilation, g, window)
    reached = set()
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            live = (ins > 0) & (wy * wx != 0)
            assert live.any()
            rows = (fy + dy)[live]          # corner row less y
            cols = (fx + dx)[live]          # corner column less x
            assert rows.min() >= -window and rows.max() <= window + 1
            assert cols.min() >= -window and cols.max() <= window + 1
            reached |= {rows.min().item(), rows.max().item()}
    # the offsets reach both edges of the band, so the bound is tight
    assert -window in reached and window in reached


@pytest.mark.parametrize('padding,dilation,window',
                         [(1, 1, 3), (3, 3, 3), (1, 1, 2)])
def test_offset_grad_live_is_the_plain_versions_rule(padding, dilation,
                                                      window):
    """``offset_grad_live``, which ``chip_smoke.py`` holds K3's exact zeros
    to: the plain version's offset gradient is exactly 0 wherever it is
    False (samples outside, integer and clipped displacements: a third of
    them here) and non-zero wherever it is True; zero offsets make it
    False everywhere (3f)."""
    rng = np.random.RandomState(40 + padding + window)
    n, s, g, c = 2, 11, 2, 8
    off = _offsets(rng, n, s, g, 3, padding, dilation, window)
    x = torch.from_numpy(rng.randn(n, s, s, c).astype(np.float32))
    d_col = torch.from_numpy(
        rng.randn(n, s, s, g, 9, c // g).astype(np.float32))
    kw = dict(kernel_size=3, padding=padding, dilation=dilation,
              deform_groups=g, window=window)
    live = dc.offset_grad_live(off, s, s, **kw)
    assert live.shape == off.shape and 0 < int(live.sum()) < live.numel()
    _, d_off = dc.deform_col2im_windowed_plain(x, off, d_col, **kw)
    assert not d_off[~live].any() and (d_off[live] != 0).all()
    assert not dc.offset_grad_live(torch.zeros_like(off), s, s, **kw).any()


# the shapes the port runs: the three SFM stages at inference (n = 100) and
# in training (n = 512); (n, S, C, g, padding, dilation, window)
MAIN_SHAPES = [(n, s, c, 2, 1, 1, 3) for n in (100, 512)
               for s, c in ((14, 256), (28, 128), (56, 64))]
# the edge shapes of chip_smoke.py (DCN_EDGE_SHAPES)
EDGE_SHAPES = [(2, 13, 64, 2, 1, 1, 3), (2, 17, 64, 2, 1, 1, 3),
               (2, 14, 64, 1, 1, 1, 3), (2, 9, 6, 2, 1, 1, 3),
               (2, 12, 20, 2, 1, 1, 3), (2, 14, 64, 2, 2, 2, 3),
               (2, 14, 64, 2, 1, 1, 1), (2, 14, 64, 2, 1, 1, 2),
               (1, 28, 128, 2, 1, 1, 3), (2, 14, 64, 1, 3, 3, 3)]


@pytest.mark.parametrize('kernel', ['k1', 'k3'])
@pytest.mark.parametrize('shape', MAIN_SHAPES + EDGE_SHAPES,
                         ids=lambda s: 'n{}_S{}_C{}_g{}_p{}_d{}_w{}'.format(
                             *s))
def test_launch_config(shape, kernel):
    """The bands, as the kernel derives them from the configuration, cover
    every output row exactly once; the table fits the shared memory of a
    block; the vector width is 4 only where the group's channels come in
    quads (and the bases are aligned)."""
    n, s, c, g = shape[:4]
    cg = c // g
    cfg = dc.dcn_launch_config(kernel, n, s, s, c, g, 3)
    band, n_bands = cfg['band_rows'], cfg['n_bands']
    covered = np.zeros(s, int)
    for b in range(n_bands):                 # the kernel's band of block b
        first = b * band
        rows = min(band, s - first)
        assert rows >= 1
        covered[first:first + rows] += 1
    assert (covered == 1).all()
    assert 0 < cfg['smem_bytes'] <= 232_448
    assert cfg['vec'] == (4 if cg % 4 == 0 else 1)
    assert dc.dcn_launch_config(kernel, n, s, s, c, g, 3,
                                aligned=False)['vec'] == 1
    lanes = 1 << cfg['lanes_log2']
    assert lanes <= 32
    assert lanes >= min(32, cg // cfg['vec'])
    assert cfg['table_entries'] <= min(band * s * 9, dc.TABLE_CAP)
    entry = dc.K1_ENTRY_BYTES if kernel == 'k1' else dc.K3_ENTRY_BYTES
    assert cfg['smem_bytes'] == cfg['table_entries'] * entry
    if shape in MAIN_SHAPES:
        assert cfg['vec'] == 4 and n * g * n_bands >= dc.MIN_BLOCKS


def _k3_by_bands(x, off, d_col, k, padding, dilation, g, window, band):
    """K3's band decomposition in plain torch: per band of output rows,
    every corner gradient goes into a tile of the band's rows widened by the
    halo (window above, window + 1 below, cut to the plane), which must hold
    all of them; the tiles are then added into d_x. The offset gradient is
    the plain version's channel sum, per band."""
    n, h, w, c = x.shape
    cg = c // g
    rel_y0, rel_x0, ins, rel_y, rel_x, fy, fx, (wy0, wy1), (wx0, wx1) = \
        dc._geometry(off, h, w, k, padding, dilation, g, window)
    xg = x.reshape(n, h, w, g, cg)
    dc6 = d_col * ins[..., None]
    d_x = torch.zeros(n, h, w, g, cg)
    d_off = torch.zeros(n, h, w, g, k * k, 2)
    iy = torch.arange(h).view(1, h, 1, 1, 1)
    ix = torch.arange(w).view(1, 1, w, 1, 1)
    nn_ = torch.arange(n).view(n, 1, 1, 1, 1).expand(n, h, w, g, k * k)
    gg = torch.arange(g).view(1, 1, 1, g, 1).expand(n, h, w, g, k * k)
    for first in range(0, h, band):
        last = min(h, first + band) - 1
        lo, hi = max(0, first - window), min(h - 1, last + window + 1)
        tile = torch.zeros(n, hi - lo + 1, w, g, cg)
        sl = slice(first, last + 1)
        vals = {}
        for dy, wy in ((0, wy0), (1, wy1)):
            for dx, wx in ((0, wx0), (1, wx1)):
                cy = (iy + fy.long() + dy)[:, sl]
                cx = (ix + fx.long() + dx)[:, sl]
                on = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
                cyc, cxc = cy.clamp(0, h - 1), cx.clamp(0, w - 1)
                v = xg[nn_[:, sl], cyc, cxc, gg[:, sl]] * on[..., None]
                vals[dy, dx] = v
                wgt = (wy * wx)[:, sl]
                live = on & (wgt != 0) & (ins[:, sl] > 0)
                assert ((cy[live] >= lo) & (cy[live] <= hi)).all()
                contrib = dc6[:, sl] * wgt[..., None]
                idx = (((nn_[:, sl] * (hi - lo + 1) + (cyc - lo).clamp(
                    0, hi - lo)) * w + cxc) * g + gg[:, sl])[live]
                tile.view(-1, cg).index_add_(0, idx, contrib[live])
        d_x[:, lo:hi + 1] += tile
        v00, v01, v10, v11 = (vals[0, 0], vals[0, 1], vals[1, 0],
                              vals[1, 1])
        e = (lambda t: t[:, sl][..., None])
        dcb = dc6[:, sl]
        s_y = (dcb * (e(wx0) * (v10 - v00) + e(wx1) * (v11 - v01))).sum(-1)
        s_x = (dcb * (e(wy0) * (v01 - v00) + e(wy1) * (v11 - v10))).sum(-1)
        gate_y = (rel_y > fy) & (rel_y0.abs() < window)
        gate_x = (rel_x > fx) & (rel_x0.abs() < window)
        d_off[:, sl, ..., 0] = torch.where(gate_y[:, sl], s_y, 0.0)
        d_off[:, sl, ..., 1] = torch.where(gate_x[:, sl], s_x, 0.0)
    return d_x.reshape(n, h, w, c), d_off.reshape(off.shape)


@pytest.mark.parametrize('band', [1, 3, 5])
def test_k3_band_emulation_matches_plain_and_jax(band):
    """K3 accumulated band by band, each band into its halo tile, equals
    ``deform_col2im_windowed_plain`` to 1e-6 of the largest gradient, and
    both agree with ``jax.grad`` of ``deform_conv2d_windowed`` to 1e-4 (fp32
    sums in other orders) with the same exact zeros of d_offset."""
    from dynamask_tpu.ops.deform_conv import deform_conv2d_windowed
    rng = np.random.RandomState(band)
    n, s, c, c_out, g, pad, dil, window = 2, 11, 8, 6, 2, 1, 1, 3
    x = rng.randn(n, s, s, c).astype(np.float32)
    off = _offsets(rng, n, s, g, 3, pad, dil, window).numpy()
    w = (rng.randn(3, 3, c, c_out) * 0.2).astype(np.float32)
    ct = rng.randn(n, s, s, c_out).astype(np.float32)

    ref_x, ref_off = jax.grad(
        lambda a, o: jnp.sum(deform_conv2d_windowed(
            a, o, jnp.asarray(w), 3, 1, pad, dil, g, window) *
            jnp.asarray(ct)), (0, 1))(jnp.asarray(x), jnp.asarray(off))
    w2 = dc.im2col_weight(torch.from_numpy(w).permute(3, 2, 0, 1), g)
    d_col = (torch.from_numpy(ct).reshape(-1, c_out) @ w2.t()).reshape(
        n, s, s, g, 9, c // g)
    xt, ot = torch.from_numpy(x), torch.from_numpy(off)
    plain = dc.deform_col2im_windowed_plain(xt, ot, d_col, 3, pad, dil, g,
                                            window)
    bands = _k3_by_bands(xt, ot, d_col, 3, pad, dil, g, window, band)
    for what, a, b, r in zip(('d_x', 'd_offset'), bands, plain,
                             (ref_x, ref_off)):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=what)
        for got in (a, b):
            np.testing.assert_allclose(got.numpy(), r, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=what)
    np.testing.assert_array_equal(bands[1].numpy() == 0,
                                  np.asarray(ref_off) == 0)


# the whole maps guided anchoring and DetectoRS give K1/K3 at 800x1344, the
# list phase 2 of chip_smoke.py compares on the card: (n, H, W, C, g,
# padding, dilation)
from chip_smoke import WHOLE_MAPS            # noqa: E402


@pytest.mark.parametrize('kernel', ['k1', 'k3'])
@pytest.mark.parametrize('shape', WHOLE_MAPS,
                         ids=lambda s: 'n{}_{}x{}_C{}_g{}_p{}_d{}'.format(*s))
def test_launch_config_on_whole_maps(shape, kernel):
    """On the non-square whole maps: the bands cover every row once, the
    table fits a block's shared memory, 16-byte quads and up to 32 lanes
    (cg 64-512); the 32-bit indices the kernels check hold (a plane, a
    band's column block, the grid; the 64-bit bases take the rest: GA-RPN's
    P2 for four images is a 6.2e8-element column tensor); where the maps
    give fewer than ``MIN_BLOCKS`` rows the bands narrow to one row and the
    grid stays underfilled (``n * g * H`` blocks: 25 at layer4's 25x42 on
    one image)."""
    n, h, w, c, g, pad, dil = shape
    cg = c // g
    cfg = dc.dcn_launch_config(kernel, n, h, w, c, g, 3)
    band, n_bands = cfg['band_rows'], cfg['n_bands']
    assert n_bands == -(-h // band)
    covered = np.zeros(h, int)
    for b in range(n_bands):
        covered[b * band:b * band + min(band, h - b * band)] += 1
    assert (covered == 1).all()
    assert 0 < cfg['smem_bytes'] <= 232_448
    assert cfg['vec'] == 4 and (1 << cfg['lanes_log2']) == min(32, cg // 4)
    blocks = n * g * n_bands
    assert band == 1 or blocks >= dc.MIN_BLOCKS
    if n * g * h < dc.MIN_BLOCKS:
        assert band == 1 and blocks == n * g * h < dc.MIN_BLOCKS
    assert h * w * c < 2 ** 31
    assert min(band, h) * w * g * 9 * cg < 2 ** 31
    assert blocks < 2 ** 31
    if shape == (4, 200, 336, 256, 4, 1, 1):
        assert n * h * w * 9 * c == 619_315_200


@pytest.mark.parametrize('kernel', ['k1', 'k3'])
@pytest.mark.parametrize('shape', WHOLE_MAPS,
                         ids=lambda s: 'n{}_{}x{}_C{}_g{}_p{}_d{}'.format(*s))
def test_launch_config_on_whole_maps_bf16(shape, kernel):
    """The bf16 instances' grid (``elem_bytes=2``) on the whole maps, as
    the bf16 drives of guided anchoring and DetectoRS launch them: bands,
    table and shared memory those of the fp32 instance; K1's lanes read 8
    bf16 channels at once (cg 64-512 come in runs of 8), K3's reduce 4 in
    either type, up to 32 lanes."""
    n, h, w, c, g, pad, dil = shape
    cg = c // g
    cfg = dc.dcn_launch_config(kernel, n, h, w, c, g, 3, elem_bytes=2)
    f32 = dc.dcn_launch_config(kernel, n, h, w, c, g, 3)
    for key in ('band_rows', 'n_bands', 'table_entries', 'smem_bytes'):
        assert cfg[key] == f32[key], key
    vec = 8 if kernel == 'k1' else 4
    assert cfg['vec'] == vec
    assert (1 << cfg['lanes_log2']) == min(32, cg // vec)
    assert dc.dcn_launch_config(kernel, n, h, w, c, g, 3, aligned=False,
                                elem_bytes=2)['vec'] == 1


@pytest.mark.parametrize('band', [1, 4])
def test_k3_band_emulation_at_dilation_3(band):
    """SAC's large branch: K3 band by band at padding and dilation 3 on a
    non-square 13x10 plane, one deform group, equals the plain version to
    1e-6 of the largest gradient and ``jax.grad`` of the JAX windowed DCN
    to 1e-4, with the same exact zeros of d_offset; from zero offsets (the
    SAC init) d_offset is exactly zero on all three (3f)."""
    from dynamask_tpu.ops.deform_conv import deform_conv2d_windowed
    rng = np.random.RandomState(30 + band)
    n, h, w, c, c_out, g, pad, dil, window = 2, 13, 10, 8, 6, 1, 3, 3, 3
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, c_out) * 0.2).astype(np.float32)
    ct = rng.randn(n, h, w, c_out).astype(np.float32)
    w2 = dc.im2col_weight(torch.from_numpy(wt).permute(3, 2, 0, 1), g)
    d_col = (torch.from_numpy(ct).reshape(-1, c_out) @ w2.t()).reshape(
        n, h, w, g, 9, c // g)
    xt = torch.from_numpy(x)
    random = rng.uniform(-5, 5, (n, h, w, 18)).astype(np.float32)
    for off in (random, np.zeros_like(random)):
        ref_x, ref_off = jax.grad(
            lambda a, o: jnp.sum(deform_conv2d_windowed(
                a, o, jnp.asarray(wt), 3, 1, pad, dil, g, window) *
                jnp.asarray(ct)), (0, 1))(jnp.asarray(x), jnp.asarray(off))
        ot = torch.from_numpy(off)
        plain = dc.deform_col2im_windowed_plain(xt, ot, d_col, 3, pad, dil,
                                                g, window)
        bands = _k3_by_bands(xt, ot, d_col, 3, pad, dil, g, window, band)
        for what, a, b, r in zip(('d_x', 'd_offset'), bands, plain,
                                 (ref_x, ref_off)):
            r = np.asarray(r)
            scale = float(np.abs(ref_x).max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * scale, err_msg=what)
            for got in (a, b):
                np.testing.assert_allclose(got.numpy(), r, rtol=1e-4,
                                           atol=1e-4 * scale, err_msg=what)
        np.testing.assert_array_equal(bands[1].numpy() == 0,
                                      np.asarray(ref_off) == 0)
        if not off.any():
            assert not bands[1].any() and not plain[1].any()
