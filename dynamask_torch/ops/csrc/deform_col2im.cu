// K3: deform_col2im_windowed -- the backward of K1 (fp32): from the column
// gradient d_col to d_x and d_offset.
//
// Replaces the Pallas body _dcn_rowmm_bwd_kernel of
// dynamask_tpu/ops/deform_conv_pallas.py:deform_conv2d_rowmm_ad (:535;
// called at :685 by the backward _rowmm_ad_bwd), the TPU backward of every
// SFM fuse_conv_1. As there, d_w and d_col are matrix products outside the
// kernel.
//
// Semantics, those of _windowed_cvjp_bwd (dynamask_tpu/ops/deform_conv.py:
// 239-326): with rel the unclipped displacement of (pixel, group, tap), a
// sample outside (-1, extent) gets and gives no gradient. Otherwise rel is
// clipped to [-window, window], t = rel - floor(rel), and
//   d_x[corner]  += d_col * (tent weight of the corner)
//   d_rel_y       = sum_c d_col * (wx0 (v10 - v00) + wx1 (v11 - v01))
//   d_rel_x       = sum_c d_col * (wy0 (v01 - v00) + wy1 (v11 - v10))
// where the tent derivative -sign(z) on |z| < 1 is zero when t == 0 (an
// integer displacement, e.g. every offset at its zero init gives exactly 0),
// and d_offset = d_rel only where the unclipped |rel| < window (the clip
// passes no gradient at or beyond its edge). Corners off the plane read 0
// and take no gradient; a corner whose tent weight is 0 takes no d_x add.
//
// Layouts: x (n, H, W, C) NHWC, offsets and d_offset (n, H, W, g*T*2) with
// channel order (g, kh, kw, [dy, dx]), d_col (n, H, W, g, T, C/g), d_x
// (n, H, W, C), zeroed by the caller.
//
// Bound on the H100: bytes. d_col is T = 9 times the size of x and is read
// once; per element the kernel does ~22 flops against 4 bytes read. At the
// flagship's training shapes (n = 512) the three SFM stages must move 8.5 GB:
// 2.54 ms at 3.35 TB/s.
//
// What held the first design back (one warp per (pixel, group, tap), a lane
// per channel, global atomics into d_x): ~11% of that bound, 23.4 ms at
// n = 512, and per element 2.6x dearer at 56^2 (cg = 32) than at 14^2: each
// 32 elements paid a 64-bit index split, the whole geometry, two 5-step
// shuffle reductions and a lane-0 store, and every element up to four
// global fp32 atomics (up to 3.7 G at 56^2 alone), each a read-modify-write
// in L2.
//
// This design: the grid of K1, one block per (RoI, deform group, band of B
// output rows), B and the table size from the wrapper (dcn_launch_config).
// The geometry of each (pixel, tap) is computed once into a table in shared
// memory (K1's table plus the gradient gates), a chunk of entries at a time.
// Groups of `lanes` threads walk the entries, each lane a quad of channels:
// a 16-byte streaming load of d_col (read once; issued one entry ahead);
// four 16-byte corner loads of x and the two channel sums, reduced over the
// group with a log2(lanes)-step shuffle, all three skipped where neither
// gate passes (zero offsets, the DCNs' state at init, pass none); and d_x
// added corner by corner with one 16-byte reduction in L2
// (red.global.add.v4.f32, new in sm_90): a quarter of the first design's
// atomics, none waiting for an answer. The clip bounds every corner with a
// non-zero weight of output row y to rows y - window .. y + window + 1, so
// a block's reductions fall in its band's rows widened by that halo, which
// the blocks in flight share in L2.
//
// A d_x tile in shared memory, added into d_x once per block, was this
// design's first form and went: sm_90 has no fp32 shared-memory atomic add
// (atomicAdd compiles to a compare-and-swap loop, ATOMS.CAST.SPIN, which
// tools/ablate_k3.py prints), and on the card the tile ran slower than the
// reductions in L2. fp32 atomics make the order of d_x's sums, and so its
// last bits, vary between runs. A cg that is not a multiple of 4, or a
// misaligned base, runs the scalar instance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// bytes of shared memory per table entry: int4 corners, float4 weights, int
// d_col offset, int d_offset offset and gates
constexpr int ENTRY_BYTES = 40;
constexpr int GATE_Y = 1, GATE_X = 2, FLAG_BITS = 2;

// K1's geometry of one (pixel, tap) plus the gradient gates: corners as
// plane pixel indices (-1 off the plane, all -1 outside), weights (wy0, wy1,
// wx0, wx1), and as flags GATE_Y where the sample is inside, the y tent
// has a slope and the clip passes y, GATE_X likewise.
__device__ __forceinline__ int tap_geometry(
    const float* __restrict__ o, int yy, int xx, int i, int j, int H, int W,
    int pad, int dil, float window, int4& pix, float4& wt) {
  const float rel_y0 = (float)(i * dil - pad) + o[0];
  const float rel_x0 = (float)(j * dil - pad) + o[1];
  const float py = (float)yy + rel_y0;
  const float px = (float)xx + rel_x0;
  pix = make_int4(-1, -1, -1, -1);
  wt = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!(py > -1.f && py < (float)H && px > -1.f && px < (float)W)) return 0;
  const float rel_y = fminf(fmaxf(rel_y0, -window), window);
  const float rel_x = fminf(fmaxf(rel_x0, -window), window);
  const float fy = floorf(rel_y);
  const float fx = floorf(rel_x);
  // the forward's tent weights, expression for expression (K1)
  wt.x = 1.f - (rel_y - fy);
  wt.y = 1.f - ((fy + 1.f) - rel_y);
  wt.z = 1.f - (rel_x - fx);
  wt.w = 1.f - ((fx + 1.f) - rel_x);
  const int y0 = yy + (int)fy, x0 = xx + (int)fx;
  const bool ry0 = y0 >= 0 && y0 < H, ry1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool rx0 = x0 >= 0 && x0 < W, rx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const int p00 = y0 * W + x0;
  pix.x = (ry0 && rx0) ? p00 : -1;
  pix.y = (ry0 && rx1) ? p00 + 1 : -1;
  pix.z = (ry1 && rx0) ? p00 + W : -1;
  pix.w = (ry1 && rx1) ? p00 + W + 1 : -1;
  return ((rel_y > fy && fabsf(rel_y0) < window) ? GATE_Y : 0) |
         ((rel_x > fx && fabsf(rel_x0) < window) ? GATE_X : 0);
}

// d_x[p .. p+3] += v: one 16-byte reduction in L2 (red.global.add.v4.f32)
__device__ __forceinline__ void global_add4(float* p, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_stream(const float* p) {
  if constexpr (VEC == 4) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  } else {
    return __ldcs(p);
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 4) deform_col2im_band_kernel(
    const float* __restrict__ x, const float* __restrict__ off,
    const float* __restrict__ d_col, float* __restrict__ d_x,
    float* __restrict__ d_off, int H, int W, int C, int g, int k, int pad,
    int dil, float window, int band_rows, int n_bands, int table_entries,
    int lanes_log2) {
  using VT = typename Vec<VEC>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* t_pix = reinterpret_cast<int4*>(smem);
  float4* t_w = reinterpret_cast<float4*>(t_pix + table_entries);
  int* t_col = reinterpret_cast<int*>(t_w + table_entries);
  int* t_aux = t_col + table_entries;

  const int T = k * k;
  const int cg = C / g;
  const int band = (int)(blockIdx.x % (unsigned)n_bands);
  const int rg = (int)(blockIdx.x / (unsigned)n_bands);
  const int gi = rg % g;
  const long long ni = rg / g;
  const int y_first = band * band_rows;
  const int rows = min(band_rows, H - y_first);
  const int entries = rows * W * T;
  const int col_pix = g * T * cg;
  // the one 64-bit base of each array
  const long long pix0 = (ni * H + y_first) * W;
  const float* plane = x + ni * H * W * C + gi * cg;
  float* dx_plane = d_x + ni * H * W * C + gi * cg;
  const float* offb = off + pix0 * (2 * g * T) + 2 * gi * T;
  float* d_offb = d_off + pix0 * (2 * g * T) + 2 * gi * T;
  const float* dcolb = d_col + pix0 * col_pix + gi * T * cg;

  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int sub = threadIdx.x & (lanes - 1);
  const int slot = threadIdx.x >> lanes_log2;
  const int slots = THREADS >> lanes_log2;
  const int quads = cg / VEC;
  // the shuffle mask of this thread's group of lanes
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));

  for (int e0 = 0; e0 < entries; e0 += table_entries) {
    const int ne = min(table_entries, entries - e0);
    for (int e = threadIdx.x; e < ne; e += THREADS) {
      const int pt = e0 + e;
      const int p = pt / T, t = pt - (pt / T) * T;
      const int py = p / W, px = p - (p / W) * W;
      const int i = t / k, j = t - (t / k) * k;
      const int o = p * (2 * g * T) + 2 * t;
      const int flags = tap_geometry(offb + o, y_first + py, px, i, j, H, W,
                                     pad, dil, window, t_pix[e], t_w[e]);
      t_col[e] = p * col_pix + t * cg;
      t_aux[e] = (o << FLAG_BITS) | flags;
    }
    __syncthreads();
    // the d_col quad of the entry after this one is loaded one entry ahead
    VT d_next{};
    if (slot < ne && sub < quads)
      d_next = load_stream<VEC>(dcolb + t_col[slot] + sub * VEC);
    for (int e = slot; e < ne; e += slots) {
      const VT d_first = d_next;
      if (e + slots < ne && sub < quads)
        d_next = load_stream<VEC>(dcolb + t_col[e + slots] + sub * VEC);
      const int4 pc = t_pix[e];
      const float4 wt = t_w[e];
      const float* dc = dcolb + t_col[e];
      const int aux = t_aux[e];
      // the offset sums are needed only where a gate passes (never at the
      // integer displacements of zero offsets): elsewhere skip the corner
      // loads, the sums and their reduction
      const bool sums = aux & (GATE_Y | GATE_X);
      const int4 pv = sums ? pc : make_int4(-1, -1, -1, -1);
      const float w00 = wt.x * wt.z, w01 = wt.x * wt.w;
      const float w10 = wt.y * wt.z, w11 = wt.y * wt.w;
      // the corners that take a d_x add
      const bool a00 = pc.x >= 0 && w00 != 0.f, a01 = pc.y >= 0 && w01 != 0.f;
      const bool a10 = pc.z >= 0 && w10 != 0.f, a11 = pc.w >= 0 && w11 != 0.f;
      float sy = 0.f, sx = 0.f;
      for (int q = sub; q < quads; q += lanes) {
        const int c = q * VEC;
        const VT d = q == sub ? d_first : load_stream<VEC>(dc + c);
        if constexpr (VEC == 4) {
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 v00 = pv.x >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pv.x * C + c)) : z;
          const float4 v01 = pv.y >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pv.y * C + c)) : z;
          const float4 v10 = pv.z >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pv.z * C + c)) : z;
          const float4 v11 = pv.w >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pv.w * C + c)) : z;
          sy += d.x * (wt.z * (v10.x - v00.x) + wt.w * (v11.x - v01.x));
          sy += d.y * (wt.z * (v10.y - v00.y) + wt.w * (v11.y - v01.y));
          sy += d.z * (wt.z * (v10.z - v00.z) + wt.w * (v11.z - v01.z));
          sy += d.w * (wt.z * (v10.w - v00.w) + wt.w * (v11.w - v01.w));
          sx += d.x * (wt.x * (v01.x - v00.x) + wt.y * (v11.x - v10.x));
          sx += d.y * (wt.x * (v01.y - v00.y) + wt.y * (v11.y - v10.y));
          sx += d.z * (wt.x * (v01.z - v00.z) + wt.y * (v11.z - v10.z));
          sx += d.w * (wt.x * (v01.w - v00.w) + wt.y * (v11.w - v10.w));
          if (a00) global_add4(dx_plane + pc.x * C + c,
                               make_float4(d.x * w00, d.y * w00, d.z * w00,
                                           d.w * w00));
          if (a01) global_add4(dx_plane + pc.y * C + c,
                               make_float4(d.x * w01, d.y * w01, d.z * w01,
                                           d.w * w01));
          if (a10) global_add4(dx_plane + pc.z * C + c,
                               make_float4(d.x * w10, d.y * w10, d.z * w10,
                                           d.w * w10));
          if (a11) global_add4(dx_plane + pc.w * C + c,
                               make_float4(d.x * w11, d.y * w11, d.z * w11,
                                           d.w * w11));
        } else {
          const float v00 = pv.x >= 0 ? __ldg(plane + pv.x * C + c) : 0.f;
          const float v01 = pv.y >= 0 ? __ldg(plane + pv.y * C + c) : 0.f;
          const float v10 = pv.z >= 0 ? __ldg(plane + pv.z * C + c) : 0.f;
          const float v11 = pv.w >= 0 ? __ldg(plane + pv.w * C + c) : 0.f;
          sy += d * (wt.z * (v10 - v00) + wt.w * (v11 - v01));
          sx += d * (wt.x * (v01 - v00) + wt.y * (v11 - v10));
          if (a00) atomicAdd(dx_plane + pc.x * C + c, d * w00);
          if (a01) atomicAdd(dx_plane + pc.y * C + c, d * w01);
          if (a10) atomicAdd(dx_plane + pc.z * C + c, d * w10);
          if (a11) atomicAdd(dx_plane + pc.w * C + c, d * w11);
        }
      }
      // a group's lanes agree on `sums`, so a group skips its shuffles whole
      for (int s = sums ? lanes >> 1 : 0; s > 0; s >>= 1) {
        sy += __shfl_xor_sync(gmask, sy, s, lanes);
        sx += __shfl_xor_sync(gmask, sx, s, lanes);
      }
      if (sub == 0) {
        float* dst = d_offb + (aux >> FLAG_BITS);
        dst[0] = (aux & GATE_Y) ? sy : 0.f;
        dst[1] = (aux & GATE_X) ? sx : 0.f;
      }
    }
    __syncthreads();   // the table is read before the next chunk's overwrites
  }
}

template <int VEC>
int launch(const float* x, const float* offsets, const float* d_col,
           float* d_x, float* d_offsets, int n, int H, int W, int C, int g,
           int k, int pad, int dil, int window, int band_rows,
           int table_entries, int lanes_log2, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = deform_col2im_band_kernel<VEC>;
  static int smem_set = 48 * 1024;
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  const int n_bands = (H + band_rows - 1) / band_rows;
  const long long blocks = (long long)n * g * n_bands;
  kernel<<<(unsigned)blocks, THREADS, smem_bytes, stream>>>(
      x, offsets, d_col, d_x, d_offsets, H, W, C, g, k, pad, dil,
      (float)window, band_rows, n_bands, table_entries, lanes_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// band_rows, table_entries, vec (4 or 1), lanes_log2 and smem_bytes come
// from the wrapper's launch configuration (ops/deform_conv.py:
// dcn_launch_config); a configuration the kernel cannot run is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int deform_col2im_windowed_f32(
    const float* x, const float* offsets, const float* d_col, float* d_x,
    float* d_offsets, int n, int H, int W, int C, int g, int k, int pad,
    int dil, int window, int band_rows, int table_entries, int vec,
    int lanes_log2, int smem_bytes, void* stream) {
  if ((long long)n * H * W * g * k * k == 0) return 0;
  const int cg = g > 0 ? C / g : 0;
  const long long rows = band_rows < H ? band_rows : H;
  const long long blocks =
      band_rows > 0 ? (long long)n * g * ((H + band_rows - 1) / band_rows) : 0;
  if (g <= 0 || C % g || band_rows <= 0 || table_entries <= 0 ||
      window < 0 || lanes_log2 < 0 || lanes_log2 > 5 ||
      (vec == 4 ? cg % 4 != 0 : vec != 1) ||
      (long long)table_entries * ENTRY_BYTES > smem_bytes ||
      // 32-bit indices: the plane, the band's column block and offsets
      // (shifted by the flag bits), the grid
      (long long)H * W * C >= (1LL << 31) ||
      rows * W * g * k * k * cg >= (1LL << 31) ||
      rows * W * 2 * g * k * k >= (1LL << (31 - FLAG_BITS)) ||
      blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return vec == 4
             ? launch<4>(x, offsets, d_col, d_x, d_offsets, n, H, W, C, g, k,
                         pad, dil, window, band_rows, table_entries,
                         lanes_log2, smem_bytes, s)
             : launch<1>(x, offsets, d_col, d_x, d_offsets, n, H, W, C, g, k,
                         pad, dil, window, band_rows, table_entries,
                         lanes_log2, smem_bytes, s);
}
