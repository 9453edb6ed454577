"""The band design of K2 and K4 (``dynamask_torch/ops/csrc/roi_align.cu``
and ``roi_align_bwd.cu``), on the CPU.

Both kernels give one block a band of output rows of one RoI and build each
axis's samples once into a table. K4 is the transpose of the
separable crop (``A_y^T . d_out . A_x``): a lane owns a feature column and
gathers from the run of x samples that touch it, then adds the band's rows
in registers, flushing each row once as the rising samples pass it. That
rests on two premises the tests hold the port's sample table to: a sample
coordinate is monotone in (bin, sub-sample) after the clamp, so the samples
that touch one feature column or row are one contiguous run (and so are the
inside samples of an axis), and a grid sample is inside when both of its
axes' samples are. The tests then check the launch configuration at every
crop the port runs and at the edge shapes ``chip_smoke.py`` checks on the
card, and replay K2's table form and K4's gather band by band in plain
torch, against the plain versions and against the JAX package
(``roi_align``, ``multilevel_roi_align``, ``roi_align_separable``, forward
and ``jax.grad``). Tolerances: 1e-5 absolute for crops, 1e-5 of the largest
value for gradients (fp32 sums in other orders).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

from dynamask_torch.ops import roi_align as ra   # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
STRIDES = (4, 8, 16, 32)


def _rois(rng, n, h, w, scale):
    """``n`` RoIs in image coordinates for planes of h x w at ``scale``:
    random boxes up to the plane, small ones whose bins are far under one
    pixel, a zero-area box, one partly and one wholly off the plane, one on
    integer edges, one with its corners swapped (bins of negative size),
    and boxes whose first or last sample lands exactly on -1 or on the
    extent (at P = 7, s = 2, bin 1)."""
    iw, ih = w / scale, h / scale
    xy = rng.uniform(0, 1, (n, 2)) * [iw, ih]
    wh = rng.uniform(0, 1, (n, 2)) ** 2 * [iw, ih]
    r = np.concatenate([xy - wh / 4, xy + wh], 1)
    tiny = rng.uniform(0, 1, (n, 2)) * [iw, ih]
    r[1::4] = np.concatenate([tiny, tiny + rng.uniform(0.5, 3, (n, 2)) /
                              scale], 1)[1::4]
    low = (-0.5 - 0.25) / scale          # first sample exactly at -1
    high_x = (w - 7 + 0.25 + 0.5) / scale  # last sample exactly at w
    special = [[iw / 3, ih / 2, iw / 3, ih / 2],
               [-30 / scale, -20 / scale, iw / 4, ih / 4],
               [iw + 3 / scale, ih + 2 / scale, iw + 9 / scale,
                ih + 7 / scale],
               [0, 0, iw, ih],
               [iw * 0.6, ih * 0.7, iw * 0.2, ih * 0.3],
               [low, low, low + 7 / scale, low + 7 / scale],
               [high_x, low, high_x + 7 / scale, low + 7 / scale]]
    r[:len(special)] = special
    return r.astype(np.float32)


def _single(rng, n, b, h, w, c, scale):
    """A single-level crop's inputs: NHWC features (numpy), RoIs, images."""
    feats = rng.randn(b, h, w, c).astype(np.float32)
    return feats, _rois(rng, n, h, w, scale), rng.randint(0, b, n)


def _single_args(feats, rois, batch, scale):
    """K2's flat arguments of a single-level crop, as ``ra.roi_align``."""
    b, h, w, c = feats.shape
    n = len(rois)
    return (torch.from_numpy(feats).reshape(-1, c), torch.from_numpy(rois),
            torch.from_numpy(batch).long() * (h * w),
            torch.full((n,), h, dtype=torch.int32),
            torch.full((n,), w, dtype=torch.int32),
            torch.full((n,), scale, dtype=torch.float32))


def _multilevel_args(feats, rois, batch):
    """K2's flat arguments of an FPN-routed crop, as
    ``ra.multilevel_roi_align``."""
    tf = [torch.from_numpy(f) for f in feats]
    flat, offsets = ra._flat_planes(tf)
    r = torch.from_numpy(rois)
    lvl = ra.map_roi_levels(r, len(feats))
    hs = torch.tensor([f.shape[1] for f in feats], dtype=torch.int32)[lvl]
    ws = torch.tensor([f.shape[2] for f in feats], dtype=torch.int32)[lvl]
    base = torch.tensor(offsets)[lvl] + torch.from_numpy(batch).long() * (
        hs.long() * ws.long())
    sc = (1.0 / torch.tensor(STRIDES, dtype=torch.float32))[lvl]
    return flat, r, base, hs, ws, sc


def _axes(args, p, s):
    """The per-axis sample tables of every RoI: (y table, x table), each
    ``roi_axis_samples``' (v0, v1, h, l, inside), plus the bin sizes."""
    _, rois, _, hs, ws, sc = args
    (y1, bin_h), (x1, bin_w) = ra._roi_axes(rois, sc, p)
    return (ra.roi_axis_samples(y1, bin_h, hs, p, s),
            ra.roi_axis_samples(x1, bin_w, ws, p, s), bin_h, bin_w)


# -- premises -----------------------------------------------------------------

def test_samples_are_monotone_and_their_runs_contiguous():
    """After the clamp a sample's first corner rises with the sample index
    where the bin is not negative and falls where it is; so in ascending
    order the samples whose corners include a column X (first corner in
    {X - 1, X}) are one run, and so are the inside samples."""
    rng = np.random.RandomState(0)
    for p, s, scale in ((7, 2, 0.25), (14, 1, 0.25), (56, 1, 0.25),
                        (14, 3, 1.0)):
        feats, rois, batch = _single(rng, 40, 1, 24, 30, 1, scale)
        (v0y, _, _, _, in_y), (v0x, v1x, _, _, in_x), bin_h, bin_w = _axes(
            _single_args(feats, rois, batch, scale), p, s)
        assert (bin_w < 0).any() and (bin_w == 0).any()
        for v0, inside, b, extent in ((v0y, in_y, bin_h, 24),
                                      (v0x, in_x, bin_w, 30)):
            for i in range(len(rois)):
                order = slice(None) if b[i] >= 0 else slice(None, None, -1)
                v, ins = v0[i].numpy()[order], inside[i].numpy()[order]
                assert (np.diff(v) >= 0).all()
                idx = np.flatnonzero(ins)
                if len(idx):
                    assert (np.diff(idx) == 1).all()
                for x in range(extent):
                    run = np.flatnonzero((v == x - 1) | (v == x))
                    if len(run):
                        assert (np.diff(run) == 1).all()
        # the second corner is the first one plus one, cut to the plane
        assert torch.equal(v1x, torch.minimum(v0x + 1, torch.tensor(29)))


def test_inside_is_the_product_of_the_axes():
    """The inside test of a grid sample on its two raw coordinates (the
    JAX package's ``_bilinear_gather`` :70) is the product of the axes'
    flags, and the tables' coordinates are the JAX package's
    (``_sample_coords``) through ``tent_matrix``."""
    jra = importlib.import_module('dynamask_tpu.ops.roi_align')
    rng = np.random.RandomState(1)
    p, s, scale, h, w = 7, 2, 0.5, 20, 26
    feats, rois, batch = _single(rng, 30, 1, h, w, 1, scale)
    (v0y, v1y, hy, ly, in_y), (v0x, v1x, hx, lx, in_x), _, _ = _axes(
        _single_args(feats, rois, batch, scale), p, s)
    ys, xs = (np.asarray(a) for a in jra._sample_coords(
        jnp.asarray(rois), scale, p, s, True))
    yy, xx = ys[:, :, None], xs[:, None, :]
    inside = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
    np.testing.assert_array_equal(
        (in_y[:, :, None] & in_x[:, None, :]).numpy(), inside)
    assert inside.any() and not inside.all()
    for (v0, v1, hh, ll, ins), coords, extent in (
            ((v0y, v1y, hy, ly, in_y), ys, h), ((v0x, v1x, hx, lx, in_x), xs,
                                                w)):
        a = torch.zeros(len(rois), p, extent)
        rows = torch.arange(p).repeat_interleave(s)[None].expand_as(v0)
        nn = torch.arange(len(rois))[:, None].expand_as(v0)
        a.index_put_((nn, rows, v0), hh * ins / s, accumulate=True)
        a.index_put_((nn, rows, v1), ll * ins / s, accumulate=True)
        ref = np.asarray(jra.tent_matrix(jnp.asarray(coords), extent, p, s,
                                         jnp.float32))
        np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-6)


# -- launch configuration ----------------------------------------------------

# the crops the port runs, (n, P, s, C): inference (1000 proposals, 100
# dets; the dynamic mode's last SFM stage may hold one RoI), then training
# (2048 sampled RoIs, 512 positive slots); HTC's box-branch semantic crops
# at ratio 1 (its mask-branch ones are the SFM 14x14 shapes); GRoIE's
# all-level crops, 4 levels x the RoIs: an image's box extract, a step's
# box and mask extracts; the C4 detectors' 14x14 crops at 1024 channels
# last: an image's 1000 proposals and 100 dets, a step's 2048 and 512
MAIN_SHAPES = [(1000, 7, 2, 256), (100, 14, 2, 256), (100, 14, 1, 256),
               (100, 28, 1, 128), (100, 56, 1, 64), (100, 56, 1, 128),
               (1, 56, 1, 64), (2048, 7, 2, 256), (512, 14, 2, 256),
               (512, 14, 1, 256), (512, 28, 1, 128), (512, 56, 1, 64),
               (512, 56, 1, 128), (1000, 7, 1, 256), (2048, 7, 1, 256),
               (4000, 7, 2, 256), (8192, 7, 2, 256), (2048, 14, 2, 256),
               (1000, 14, 2, 1024), (100, 14, 2, 1024), (2048, 14, 2, 1024),
               (512, 14, 2, 1024)]
# the edge shapes of chip_smoke.py (ROI_EDGE_SHAPES)
EDGE_SHAPES = [(9, 7, 2, 3), (9, 14, 1, 10), (9, 1, 2, 16), (9, 7, 3, 16),
               (1, 7, 2, 16), (9, 7, 2, 16), (9, 56, 1, 8), (9, 14, 2, 32)]


@pytest.mark.parametrize('kernel', ['k2', 'k4'])
@pytest.mark.parametrize('shape', MAIN_SHAPES + EDGE_SHAPES,
                         ids=lambda s: 'n{}_P{}_s{}_C{}'.format(*s))
def test_launch_config(shape, kernel):
    """The bands, as the kernel derives them from the configuration, cover
    every output row exactly once; the two tables fit the shared memory of
    a block; the vector width is 4 only where C comes in quads (and the
    bases are aligned); K4's band is at most K4_BAND rows."""
    n, p, s, c = shape
    cfg = ra.roi_align_launch_config(kernel, n, p, s, c)
    band, n_bands = cfg['band_rows'], cfg['n_bands']
    covered = np.zeros(p, int)
    for b in range(n_bands):                 # the kernel's band of block b
        first = b * band
        rows = min(band, p - first)
        assert rows >= 1
        covered[first:first + rows] += 1
    assert (covered == 1).all()
    assert cfg['smem_bytes'] == (p + band) * s * ra.ROI_ENTRY_BYTES
    assert 0 < cfg['smem_bytes'] <= 232_448
    assert cfg['vec'] == (4 if c % 4 == 0 else 1)
    assert ra.roi_align_launch_config(kernel, n, p, s, c,
                                      aligned=False)['vec'] == 1
    lanes = 1 << cfg['lanes_log2']
    assert min(32, c // cfg['vec']) <= lanes <= 32
    if kernel == 'k4':
        assert band <= ra.K4_BAND
    if shape in MAIN_SHAPES:
        assert cfg['vec'] == 4
        assert n * n_bands >= min(ra.MIN_BLOCKS, n * p)


# the crops K2/K4 take in bf16 on the families the bf16 drives run, (n, P,
# s, C): RefineMask's one-channel semantic crops at 14, 28 and 56 (an
# image's 100 and LVIS's 300 dets, a step's 512 slots), HTC's stride-8
# semantic crops of a step, GRoIE's all-level crops and the C4 detectors'
# 1024-channel crops
BF16_SHAPES = [(n, p, 2, 1) for n in (100, 300, 512) for p in (14, 28, 56)] + [
    (2048, 7, 1, 256), (512, 14, 1, 256), (4000, 7, 2, 256),
    (8192, 7, 2, 256), (2048, 14, 2, 256), (1000, 14, 2, 1024),
    (100, 14, 2, 1024), (2048, 14, 2, 1024), (512, 14, 2, 1024)]


@pytest.mark.parametrize('kernel', ['k2', 'k4'])
@pytest.mark.parametrize('shape', BF16_SHAPES,
                         ids=lambda s: 'n{}_P{}_s{}_C{}'.format(*s))
def test_launch_config_bf16(shape, kernel):
    """The bf16 instances' grid (``elem_bytes=2``) at the bf16 drives'
    crops: the bands and tables those of the fp32 instance (the type
    changes only the lane's width); K2's lanes read 8 bf16 elements at once
    where C comes in runs of 8 (C = 1024), one at C = 1; K4's reduce 4 in
    either type; the bands cover every output row once and, where the RoIs
    are fewer than MIN_BLOCKS, narrow to fill the card."""
    n, p, s, c = shape
    cfg = ra.roi_align_launch_config(kernel, n, p, s, c, elem_bytes=2)
    f32 = ra.roi_align_launch_config(kernel, n, p, s, c)
    for key in ('band_rows', 'n_bands', 'smem_bytes'):
        assert cfg[key] == f32[key], key
    band, n_bands = cfg['band_rows'], cfg['n_bands']
    covered = np.zeros(p, int)
    for b in range(n_bands):
        covered[b * band:b * band + min(band, p - b * band)] += 1
    assert (covered == 1).all()
    assert 0 < cfg['smem_bytes'] <= 232_448
    wide = 8 if kernel == 'k2' else 4
    assert cfg['vec'] == (wide if c % wide == 0 else 1)
    assert (1 << cfg['lanes_log2']) == min(32, max(1, c // cfg['vec']))
    assert n * n_bands >= min(ra.MIN_BLOCKS, n * p)


# -- band-by-band replays ----------------------------------------------------

def _k2_by_bands(args, p, s, band):
    """K2's table form in plain torch: per RoI and band of output rows, the
    band's y table and the RoI's x table (corner -1 outside), then per
    (output row, column) the s x s samples blended in the kernel's order
    and divided by s*s."""
    flat, rois, base, hs, ws, sc = args
    n, c = rois.shape[0], flat.shape[1]
    (v0y, v1y, hy, ly, in_y), (v0x, v1x, hx, lx, in_x), _, _ = _axes(
        args, p, s)
    out = torch.zeros(n, p, p, c)
    for i in range(n):
        w = int(ws[i])
        plane = flat[int(base[i]):]
        for first in range(0, p, band):
            for r in range(first, min(p, first + band)):
                for px in range(p):
                    acc = torch.zeros(c)
                    for iy in range(r * s, r * s + s):
                        if not in_y[i, iy]:
                            continue
                        for ix in range(px * s, px * s + s):
                            if not in_x[i, ix]:
                                continue
                            y0, y1 = int(v0y[i, iy]) * w, int(v1y[i, iy]) * w
                            x0, x1 = int(v0x[i, ix]), int(v1x[i, ix])
                            acc += (plane[y0 + x0] * (hy[i, iy] * hx[i, ix]) +
                                    plane[y0 + x1] * (hy[i, iy] * lx[i, ix]) +
                                    plane[y1 + x0] * (ly[i, iy] * hx[i, ix]) +
                                    plane[y1 + x1] * (ly[i, iy] * lx[i, ix]))
                    out[i, r, px] = acc / (s * s)
    return out


def _k4_gather_by_bands(d_out, rows, args, p, s, band):
    """K4 in plain torch: per RoI and band, both tables in
    ascending coordinate order and the runs of their inside samples; per
    feature column X of the footprint the run of x samples whose corners
    include X (binary search), the x-contraction of each of the band's
    d_out rows over that run, and the y-contraction over two open rows,
    each flushed once into d_flat when the rising samples pass it."""
    _, rois, base, hs, ws, sc = args
    n, c = rois.shape[0], d_out.shape[-1]
    (v0y, _, hy, ly, in_y), (v0x, _, hx, lx, in_x), bin_h, bin_w = _axes(
        args, p, s)
    d_flat = torch.zeros(rows, c)
    for i in range(n):
        h, w = int(hs[i]), int(ws[i])
        plane = d_flat[int(base[i]):]
        ox = np.arange(p * s) if bin_w[i] >= 0 else np.arange(p * s)[::-1]
        x0, bx = v0x[i].numpy()[ox], ox // s
        ins_x = np.flatnonzero(in_x[i].numpy()[ox])
        for first in range(0, p, band):
            k = np.arange(first * s, min(p, first + band) * s)
            oy = k if bin_h[i] >= 0 else k[::-1]
            ins_y = np.flatnonzero(in_y[i].numpy()[oy])
            if not len(ins_x) or not len(ins_y):
                continue
            lo, hi = ins_x[0], ins_x[-1] + 1
            for x in range(x0[lo], min(x0[hi - 1] + 1, w - 1) + 1):
                jlo = lo + np.searchsorted(x0[lo:hi], x - 1, 'left')
                jhi = lo + np.searchsorted(x0[lo:hi], x + 1, 'left')
                if jlo == jhi:
                    continue
                wx = torch.zeros(p)
                for j in range(jlo, jhi):
                    kx = ox[j]
                    wx[bx[j]] += ((hx[i, kx] if x0[j] == x else 0.0) +
                                  (lx[i, kx] if min(x0[j] + 1, w - 1) == x
                                   else 0.0))
                acc0, acc1, t = torch.zeros(c), torch.zeros(c), None
                row, last = -1, -1
                for u in ins_y:
                    ky = oy[u]
                    y0, b = int(v0y[i, ky]), ky // s
                    if b != last:
                        last, t = b, wx @ d_out[i, b]
                    if y0 != row:
                        if row >= 0:
                            plane[row * w + x] += acc0 / (s * s)
                            if y0 == row + 1:
                                acc0 = acc1
                            else:
                                plane[(row + 1) * w + x] += acc1 / (s * s)
                                acc0 = torch.zeros(c)
                        acc1, row = torch.zeros(c), y0
                    acc0 = acc0 + hy[i, ky] * t
                    if min(row + 1, h - 1) == row:
                        acc0 = acc0 + ly[i, ky] * t
                    else:
                        acc1 = acc1 + ly[i, ky] * t
                plane[row * w + x] += acc0 / (s * s)
                if row + 1 < h:
                    plane[(row + 1) * w + x] += acc1 / (s * s)
    return d_flat


# (name, P, s): the box extract over the pyramid (ratio 2), a mask-size
# single-level crop at scale 1/4 (ratio 2), and an SFM-like one (ratio 1)
# from a single image (the separable form's case)
CASES = [('multilevel', 7, 2), ('single', 14, 2), ('single_image', 14, 1)]


def _case(name, p, s):
    """(torch flat arguments, JAX forward of features, JAX separable or
    None, numpy features) of one replay case, drawn from a numpy seed."""
    # the JAX ops package re-exports the function under the module's name
    jra = importlib.import_module('dynamask_tpu.ops.roi_align')
    rng = np.random.RandomState(p * 10 + s)
    c = 4
    if name == 'multilevel':
        feats = [rng.randn(2, 48 >> i, 64 >> i, c).astype(np.float32)
                 for i in range(4)]
        rois = _rois(rng, 12, 48, 64, 0.25) * rng.choice([1.0, 4.0, 8.0],
                                                          (12, 1))
        rois = rois.astype(np.float32)
        batch = rng.randint(0, 2, len(rois))
        args = _multilevel_args(feats, rois, batch)

        def jfwd(fs):
            return jra.multilevel_roi_align(
                list(fs), jnp.asarray(rois), jnp.asarray(batch, jnp.int32),
                p, STRIDES, sampling_ratio=s)
        return args, jfwd, None, feats
    b = 2 if name == 'single' else 1
    feats, rois, batch = _single(rng, 12, b, 18, 22, c, 0.25)
    args = _single_args(feats, rois, batch, 0.25)

    def jfwd(fs):
        return jra.roi_align(fs[0], jnp.asarray(rois),
                             jnp.asarray(batch, jnp.int32), p, 0.25,
                             sampling_ratio=s)
    sep = None
    if b == 1:
        def sep(fs):
            return jra.roi_align_separable(fs[0], jnp.asarray(rois), p, 0.25,
                                           sampling_ratio=s)
    return args, jfwd, sep, [feats]


@pytest.mark.parametrize('band', [1, 3, 'config'])
@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}_P{c[1]}_s'
                         f'{c[2]}')
def test_k2_table_replay_matches_plain_and_jax(case, band):
    """K2's table form, band by band, equals ``roi_align_fwd_plain`` and
    the JAX package's crop (XLA, and the separable form where it applies)
    to 1e-5."""
    name, p, s = case
    args, jfwd, sep, feats = _case(name, p, s)
    if band == 'config':
        band = ra.roi_align_launch_config('k2', len(args[1]), p, s,
                                          args[0].shape[1])['band_rows']
    got = _k2_by_bands(args, p, s, band)
    plain = ra.roi_align_fwd_plain(*args, p, s)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=TOL)
    jf = [jnp.asarray(f) for f in feats]
    for ref in (jfwd(jf), None if sep is None else sep(jf)):
        if ref is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=TOL)
    assert (got == 0).any() and (got != 0).any()


@pytest.mark.parametrize('band', [1, 3, 'config'])
@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}_P{c[1]}_s'
                         f'{c[2]}')
def test_k4_gather_replay_matches_plain_and_jax(case, band):
    """K4's gather, band by band, equals ``roi_align_bwd_plain`` and
    ``jax.grad`` of the JAX package's crop (XLA, and the separable form
    where it applies) to 1e-5 of the largest gradient."""
    name, p, s = case
    args, jfwd, sep, feats = _case(name, p, s)
    flat = args[0]
    n, c = len(args[1]), flat.shape[1]
    if band == 'config':
        band = ra.roi_align_launch_config('k4', n, p, s, c)['band_rows']
    d_out = torch.from_numpy(np.random.RandomState(7).randn(
        n, p, p, c).astype(np.float32))
    got = _k4_gather_by_bands(d_out, flat.shape[0], args, p, s, band)
    plain = ra.roi_align_bwd_plain(d_out, flat.shape[0], *args[1:], p, s)
    scale = float(plain.abs().max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=TOL * scale)
    jf = [jnp.asarray(f) for f in feats]
    ct = jnp.asarray(d_out.numpy())
    for fwd in (jfwd, sep):
        if fwd is None:
            continue
        ref = jax.grad(lambda fs: jnp.sum(fwd(fs) * ct))(jf)
        ref = np.concatenate([np.asarray(r).reshape(-1, c) for r in ref])
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=TOL * scale)
    assert (got != 0).any()
