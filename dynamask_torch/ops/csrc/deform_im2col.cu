// K1: deform_im2col_windowed -- bounded-window DCNv1 sampling (fp32).
//
// Replaces the Pallas bodies _dcn_rowmm_kernel / _dcn_rowmm_yfold_kernel of
// dynamask_tpu/ops/deform_conv_pallas.py:deform_conv2d_rowmm (:318, :348;
// called at :500), the TPU dispatch of every SFM fuse_conv_1
// (dynamask_tpu/ops/deform_conv.py:404-428). As there, the kernel only
// samples: it writes the im2col tensor, and the (tap, channel) -> C_out
// contraction is one torch.matmul outside it.
//
// Semantics (deform_conv_pallas.py:420-434, deform_conv.py:138-170): for
// output pixel (y, x), deform group g and tap t = (i, j) the displacement is
// rel = (i*dil - pad, j*dil - pad) + offset[g, t]. The sample is zero when
// the UNCLIPPED absolute position y + rel_y or x + rel_x falls outside
// (-1, extent). Otherwise rel is clipped to [-window, window] on each axis and
// the sample is bilinear on the zero-padded plane.
//
// Layouts: x (n, H, W, C) NHWC, offsets (n, H, W, g*T*2) with channel order
// (g, kh, kw, [dy, dx]), col (n, H, W, g, T, C/g).
//
// Bound on the H100: bytes. col is T = 9 times the size of x and is written
// once; per element the kernel does ~13 flops against 4 bytes written, far
// below the card's ~20 flop/byte fp32 ridge. At the flagship's training
// shapes (n = 512) the three SFM stages must move 7.5 GB: 2.24 ms at
// 3.35 TB/s.
//
// What held the first design back (one thread per column element): it ran
// at ~10% of that bound, 21.6 ms for the three stages at n = 512, its time
// following the element count at ~13 ps per element (~300 GB/s of writes)
// whatever the stage. That is instruction issue, not memory: each thread
// split a 64-bit linear index with ten 64-bit divisions by runtime divisors
// and recomputed the geometry of its (pixel, group, tap) -- two offset
// loads, clip, floor, four tents -- which all cg = 32-128 channels share,
// to store 4 bytes.
//
// This design: one block per (RoI, deform group, band of B output rows),
// B and the table size from the wrapper (dcn_launch_config). The block
// computes each (pixel, tap) geometry once, one thread per entry, into a
// table in shared memory: the four corners as 32-bit pixel indices into the
// RoI-group plane (-1 off the plane, all four -1 for a sample outside) and
// the tent weights wy0, wy1, wx0, wx1 (not their products, so the blend
// below is today's expression and the column tensor is bit-identical to the
// first design's and to K5's samples). Then groups of `lanes` threads walk
// (pixel, tap) entries, each lane a quad of channels: four 16-byte corner
// loads through the read-only path (neighbouring taps and pixels share
// corners, so they hit L1) and one 16-byte streaming store (st.global.cs:
// the 9x column tensor is far larger than L2 and must not evict x). All
// index arithmetic is 32-bit from one 64-bit base per block. A cg that is
// not a multiple of 4, or a misaligned base, runs the scalar instance of the
// same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// bytes of shared memory per table entry: int4 corners, float4 weights, int
// column offset
constexpr int ENTRY_BYTES = 36;

// The geometry of one (pixel, tap), the first design's arithmetic
// expression for expression: corners (y0,x0) (y0,x0+1) (y0+1,x0)
// (y0+1,x0+1) as plane pixel indices, -1 where off the plane; weights
// (wy0, wy1, wx0, wx1); all corners -1 and weights 0 for a sample outside.
__device__ __forceinline__ void tap_geometry(
    const float* __restrict__ o, int yy, int xx, int i, int j, int H, int W,
    int pad, int dil, float window, int4& pix, float4& wt) {
  const float rel_y0 = (float)(i * dil - pad) + o[0];
  const float rel_x0 = (float)(j * dil - pad) + o[1];
  const float py = (float)yy + rel_y0;
  const float px = (float)xx + rel_x0;
  pix = make_int4(-1, -1, -1, -1);
  wt = make_float4(0.f, 0.f, 0.f, 0.f);
  if (py > -1.f && py < (float)H && px > -1.f && px < (float)W) {
    const float rel_y = fminf(fmaxf(rel_y0, -window), window);
    const float rel_x = fminf(fmaxf(rel_x0, -window), window);
    const float fy = floorf(rel_y);
    const float fx = floorf(rel_x);
    // tent weights of the two window cells each axis touches
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
  }
}

__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, const float4& wt) {
  return (v00 * wt.z + v01 * wt.w) * wt.x + (v10 * wt.z + v11 * wt.w) * wt.y;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 4) deform_im2col_band_kernel(
    const float* __restrict__ x, const float* __restrict__ off,
    float* __restrict__ col, int H, int W, int C, int g, int k, int pad,
    int dil, float window, int band_rows, int n_bands, int table_entries,
    int lanes_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* t_pix = reinterpret_cast<int4*>(smem);
  float4* t_w = reinterpret_cast<float4*>(t_pix + table_entries);
  int* t_col = reinterpret_cast<int*>(t_w + table_entries);

  const int T = k * k;
  const int cg = C / g;
  const int band = (int)(blockIdx.x % (unsigned)n_bands);
  const int rg = (int)(blockIdx.x / (unsigned)n_bands);
  const int gi = rg % g;
  const long long ni = rg / g;
  const int y_first = band * band_rows;
  const int rows = min(band_rows, H - y_first);
  const int entries = rows * W * T;
  const int col_pix = g * T * cg;          // column elements per pixel
  // the one 64-bit base of each array
  const long long pix0 = (ni * H + y_first) * W;
  const float* plane = x + ni * H * W * C + gi * cg;
  const float* offb = off + pix0 * (2 * g * T) + 2 * gi * T;
  float* colb = col + pix0 * col_pix + gi * T * cg;

  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int slot = threadIdx.x >> lanes_log2;
  const int slots = THREADS >> lanes_log2;
  const int quads = cg / VEC;

  for (int e0 = 0; e0 < entries; e0 += table_entries) {
    const int ne = min(table_entries, entries - e0);
    for (int e = threadIdx.x; e < ne; e += THREADS) {
      const int pt = e0 + e;
      const int p = pt / T, t = pt - (pt / T) * T;
      const int py = p / W, px = p - (p / W) * W;
      const int i = t / k, j = t - (t / k) * k;
      tap_geometry(offb + p * (2 * g * T) + 2 * t, y_first + py, px, i, j, H,
                   W, pad, dil, window, t_pix[e], t_w[e]);
      t_col[e] = p * col_pix + t * cg;
    }
    __syncthreads();
    for (int e = slot; e < ne; e += slots) {
      const int4 pc = t_pix[e];
      const float4 wt = t_w[e];
      float* dst = colb + t_col[e];
      for (int q = sub; q < quads; q += lanes) {
        const int c = q * VEC;
        if constexpr (VEC == 4) {
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 v00 = pc.x >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pc.x * C + c)) : z;
          const float4 v01 = pc.y >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pc.y * C + c)) : z;
          const float4 v10 = pc.z >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pc.z * C + c)) : z;
          const float4 v11 = pc.w >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                             plane + pc.w * C + c)) : z;
          float4 v;
          v.x = blend(v00.x, v01.x, v10.x, v11.x, wt);
          v.y = blend(v00.y, v01.y, v10.y, v11.y, wt);
          v.z = blend(v00.z, v01.z, v10.z, v11.z, wt);
          v.w = blend(v00.w, v01.w, v10.w, v11.w, wt);
          __stcs(reinterpret_cast<float4*>(dst + c), v);
        } else {
          const float v00 = pc.x >= 0 ? __ldg(plane + pc.x * C + c) : 0.f;
          const float v01 = pc.y >= 0 ? __ldg(plane + pc.y * C + c) : 0.f;
          const float v10 = pc.z >= 0 ? __ldg(plane + pc.z * C + c) : 0.f;
          const float v11 = pc.w >= 0 ? __ldg(plane + pc.w * C + c) : 0.f;
          __stcs(dst + c, blend(v00, v01, v10, v11, wt));
        }
      }
    }
    __syncthreads();
  }
}

template <int VEC>
int launch(const float* x, const float* offsets, float* col, int n, int H,
           int W, int C, int g, int k, int pad, int dil, int window,
           int band_rows, int table_entries, int lanes_log2, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = deform_im2col_band_kernel<VEC>;
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
      x, offsets, col, H, W, C, g, k, pad, dil, (float)window, band_rows,
      n_bands, table_entries, lanes_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// band_rows, table_entries, vec (4 or 1), lanes_log2 and smem_bytes come
// from the wrapper's launch configuration (ops/deform_conv.py:
// dcn_launch_config); a configuration the kernel cannot run is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int deform_im2col_windowed_f32(
    const float* x, const float* offsets, float* col, int n, int H, int W,
    int C, int g, int k, int pad, int dil, int window, int band_rows,
    int table_entries, int vec, int lanes_log2, int smem_bytes,
    void* stream) {
  if ((long long)n * H * W * C * k * k == 0) return 0;
  const int cg = g > 0 ? C / g : 0;
  const long long rows = band_rows < H ? band_rows : H;
  const long long blocks =
      band_rows > 0 ? (long long)n * g * ((H + band_rows - 1) / band_rows) : 0;
  if (g <= 0 || C % g || band_rows <= 0 || table_entries <= 0 ||
      lanes_log2 < 0 || lanes_log2 > 5 ||
      (vec == 4 ? cg % 4 != 0 : vec != 1) ||
      (long long)table_entries * ENTRY_BYTES > smem_bytes ||
      // 32-bit indices: the plane, the band's column block, the grid
      (long long)H * W * C >= (1LL << 31) ||
      rows * W * g * k * k * cg >= (1LL << 31) || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return vec == 4
             ? launch<4>(x, offsets, col, n, H, W, C, g, k, pad, dil, window,
                         band_rows, table_entries, lanes_log2, smem_bytes, s)
             : launch<1>(x, offsets, col, n, H, W, C, g, k, pad, dil, window,
                         band_rows, table_entries, lanes_log2, smem_bytes, s);
}
