// K2: roi_align_fwd -- FPN-routed or single-level RoIAlign (fp32), mmcv
// aligned=True rules with a static sampling ratio.
//
// Takes the place of dynamask_tpu/ops/roi_align_pallas.py:
// multilevel_roi_align_pallas (Pallas body _roi_align_kernel), and computes
// the function of the XLA forms the JAX main path dispatches,
// dynamask_tpu/ops/roi_align.py:multilevel_roi_align / roi_align
// (_bilinear_gather, :46-128). Unlike the Pallas kernel it has no 64x64 DMA
// window, so RoIs wider than ~55 px on their level keep every sample.
//
// Features arrive as one flat (rows, C) buffer: every (image, level) plane
// laid out NHWC and concatenated. RoI r samples the plane that starts at row
// base[r], of extent (h[r], w[r]), with coordinates scaled by scale[r].
// Single-level RoIAlign is the one-level case.
//
// Per output bin: s x s samples at y1 + bin_h * (p + (i + 0.5) / s) (the
// coordinate arithmetic is kept unfused so sample positions match the plain
// version bit for bit); a sample outside [-1, extent] on either axis adds
// zero, otherwise it clamps to the plane and is bilinear; the bin is the
// mean of its samples.
//
// Bound on the H100: bytes. Every output element is written once and reads
// 4*s*s feature values, most from L1/L2 (neighbouring bins share corners),
// with ~16 flops per sample.
//
// What held the first design back (one thread per (RoI, bin, channel)): 13-15%
// of that bound. Each thread split a 64-bit index with six 64-bit divisions,
// recomputed the RoI geometry (three IEEE divisions) that 64-256 channel
// threads share, did two more divisions per sample, and moved 4 bytes per
// load and store: instruction issue, as in the first K1.
//
// This design, K1's (csrc/deform_im2col.cu) applied to RoIAlign: one block per
// (RoI, band of B output rows), B from the wrapper (ops/roi_align.py:
// roi_align_launch_config). A sample grid is the outer product of two axes,
// so the block computes each axis's samples once into tables in shared
// memory: the RoI's P*s x samples and the band's B*s y samples, each with its
// two clamped corners, its two weights and its inside flag (corner -1 when
// outside). Groups of `lanes` threads then walk (output column, channel quad)
// of the band's rows: 16-byte corner loads through the read-only path and one
// 16-byte streaming store per bin (st.global.cs: the crops are read once by
// the next layer). The blend is the first design's expression in the first
// design's order, v00*(hy*hx) + v01*(hy*lx) + v10*(ly*hx) + v11*(ly*lx) summed
// over the samples and then divided by s*s, so the output is bit-identical to
// it. All index arithmetic is 32-bit from one 64-bit base per RoI. A C that
// is not a multiple of 4, or a misaligned base, runs the scalar instance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ENTRY_BYTES = 16;   // shared bytes per axis sample

// One sample of one axis: its first corner i0 (-1 when the sample is
// outside [-1, extent]), its second corner i1 (both scaled by `stride`:
// the plane width for rows, 1 for columns) and the weights h = 1 - l and l
// of the two.
struct AxisSample {
  int i0, i1;
  float h, l;
};

// Sample k = p * s + i of an axis starting at `lo` with bins of `bin`: the
// first design's arithmetic, expression for expression.
__device__ __forceinline__ AxisSample axis_sample(int k, int s, float lo,
                                                  float bin, int extent,
                                                  int stride) {
  const int p = k / s, i = k - (k / s) * s;
  const float g = __fadd_rn((float)p, __fdiv_rn((float)i + 0.5f, (float)s));
  const float v = __fadd_rn(lo, __fmul_rn(bin, g));
  const float ef = (float)extent;
  AxisSample a;
  const float vc = fminf(fmaxf(v, 0.f), ef - 1.f);
  const float v0f = floorf(vc);
  a.l = vc - v0f;
  a.h = 1.f - a.l;
  const int v0 = (int)v0f;
  a.i0 = (v >= -1.f && v <= ef) ? v0 * stride : -1;
  a.i1 = min(v0 + 1, extent - 1) * stride;
  return a;
}

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_ro(const float* p) {
  if constexpr (VEC == 4) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return __ldg(p);
  }
}

// acc += v00*(hy*hx) + v01*(hy*lx) + v10*(ly*hx) + v11*(ly*lx), per lane
__device__ __forceinline__ void blend_add(float& acc, float v00, float v01,
                                          float v10, float v11,
                                          const AxisSample& y,
                                          const AxisSample& x) {
  acc += v00 * (y.h * x.h) + v01 * (y.h * x.l) + v10 * (y.l * x.h) +
         v11 * (y.l * x.l);
}

__device__ __forceinline__ void blend_add(float4& acc, const float4& v00,
                                          const float4& v01,
                                          const float4& v10,
                                          const float4& v11,
                                          const AxisSample& y,
                                          const AxisSample& x) {
  blend_add(acc.x, v00.x, v01.x, v10.x, v11.x, y, x);
  blend_add(acc.y, v00.y, v01.y, v10.y, v11.y, y, x);
  blend_add(acc.z, v00.z, v01.z, v10.z, v11.z, y, x);
  blend_add(acc.w, v00.w, v01.w, v10.w, v11.w, y, x);
}

// S > 0 fixes the sampling ratio at compile time; S == 0 reads s.
template <int VEC, int S>
__global__ void __launch_bounds__(THREADS, 4) roi_align_band_kernel(
    const float* __restrict__ feat, const float* __restrict__ rois,
    const long long* __restrict__ base, const int* __restrict__ hs,
    const int* __restrict__ ws, const float* __restrict__ scales,
    float* __restrict__ out, int C, int P, int s_rt, int band_rows,
    int n_bands, int lanes_log2) {
  using VT = typename Vec<VEC>::T;
  const int s = S > 0 ? S : s_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  AxisSample* t_x = reinterpret_cast<AxisSample*>(smem);   // P*s
  AxisSample* t_y = t_x + P * s;                            // rows*s

  const int band = (int)(blockIdx.x % (unsigned)n_bands);
  const long long n = blockIdx.x / (unsigned)n_bands;
  const int py_first = band * band_rows;
  const int rows = min(band_rows, P - py_first);

  // the RoI's geometry, the first design's arithmetic
  const float offset = 0.5f;   // aligned=True: the half-pixel shift
  const float sc = scales[n];
  const float* roi = rois + 4 * n;
  const float x1 = __fsub_rn(__fmul_rn(roi[0], sc), offset);
  const float y1 = __fsub_rn(__fmul_rn(roi[1], sc), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], sc), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], sc), offset);
  const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)P);
  const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)P);
  const int h = hs[n], w = ws[n];

  const int nx = P * s, ny = rows * s;
  for (int e = threadIdx.x; e < nx + ny; e += THREADS) {
    if (e < nx)
      t_x[e] = axis_sample(e, s, x1, bin_w, w, 1);
    else
      t_y[e - nx] = axis_sample(py_first * s + e - nx, s, y1, bin_h, h, w);
  }
  __syncthreads();

  // the one 64-bit base of each array
  const float* plane = feat + base[n] * C;
  float* outb = out + (n * P + py_first) * P * C;
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int slot = threadIdx.x >> lanes_log2;
  const int slots = THREADS >> lanes_log2;
  const int quads = C / VEC;
  const float ss = (float)(s * s);

  for (int e = slot; e < rows * P; e += slots) {
    const int r = e / P, px = e - (e / P) * P;
    for (int q = sub; q < quads; q += lanes) {
      const int c = q * VEC;
      VT acc{};
      // s is a constant where S > 0, and these loops unroll
      for (int iy = 0; iy < s; ++iy) {
        const AxisSample ya = t_y[r * s + iy];
        if (ya.i0 < 0) continue;
        for (int ix = 0; ix < s; ++ix) {
          const AxisSample xa = t_x[px * s + ix];
          if (xa.i0 < 0) continue;
          const VT v00 = load_ro<VEC>(plane + (ya.i0 + xa.i0) * C + c);
          const VT v01 = load_ro<VEC>(plane + (ya.i0 + xa.i1) * C + c);
          const VT v10 = load_ro<VEC>(plane + (ya.i1 + xa.i0) * C + c);
          const VT v11 = load_ro<VEC>(plane + (ya.i1 + xa.i1) * C + c);
          blend_add(acc, v00, v01, v10, v11, ya, xa);
        }
      }
      float* dst = outb + (r * P + px) * C + c;
      if constexpr (VEC == 4) {
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(acc.x / ss, acc.y / ss, acc.z / ss, acc.w / ss));
      } else {
        __stcs(dst, acc / ss);
      }
    }
  }
}

template <int VEC, int S>
int launch(const float* feat, const float* rois, const long long* base,
           const int* hs, const int* ws, const float* scales, float* out,
           int N, int C, int P, int s, int band_rows, int lanes_log2,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = roi_align_band_kernel<VEC, S>;
  static int smem_set = 48 * 1024;
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  const int n_bands = (P + band_rows - 1) / band_rows;
  const long long blocks = (long long)N * n_bands;
  kernel<<<(unsigned)blocks, THREADS, smem_bytes, stream>>>(
      feat, rois, base, hs, ws, scales, out, C, P, s, band_rows, n_bands,
      lanes_log2);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_s(const float* feat, const float* rois, const long long* base,
             const int* hs, const int* ws, const float* scales, float* out,
             int N, int C, int P, int s, int band_rows, int lanes_log2,
             int smem_bytes, cudaStream_t stream) {
  switch (s) {
    case 1:
      return launch<VEC, 1>(feat, rois, base, hs, ws, scales, out, N, C, P,
                            s, band_rows, lanes_log2, smem_bytes, stream);
    case 2:
      return launch<VEC, 2>(feat, rois, base, hs, ws, scales, out, N, C, P,
                            s, band_rows, lanes_log2, smem_bytes, stream);
    default:
      return launch<VEC, 0>(feat, rois, base, hs, ws, scales, out, N, C, P,
                            s, band_rows, lanes_log2, smem_bytes, stream);
  }
}

}  // namespace

// band_rows, vec (4 or 1), lanes_log2 and smem_bytes come from the wrapper's
// launch configuration (ops/roi_align.py:roi_align_launch_config); a
// configuration the kernel cannot run is refused with cudaErrorInvalidValue
// before anything is launched. `rows` is the row count of the flat buffer.
extern "C" int roi_align_fwd_f32(
    const float* feat, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, float* out, int N,
    int C, int P, int s, long long rows, int band_rows, int vec,
    int lanes_log2, int smem_bytes, void* stream) {
  if ((long long)N * P * C == 0) return 0;
  const int b = band_rows < P ? band_rows : P;
  const long long blocks =
      band_rows > 0 ? (long long)N * ((P + band_rows - 1) / band_rows) : 0;
  if (s <= 0 || band_rows <= 0 || lanes_log2 < 0 || lanes_log2 > 5 ||
      (vec == 4 ? C % 4 != 0 : vec != 1) ||
      (long long)(P + b) * s * ENTRY_BYTES > smem_bytes ||
      // 32-bit indices: the flat buffer, one RoI's crop, the grid
      rows * C >= (1LL << 31) || (long long)P * P * C >= (1LL << 31) ||
      blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return vec == 4 ? launch_s<4>(feat, rois, base, hs, ws, scales, out, N, C,
                                P, s, band_rows, lanes_log2, smem_bytes, st)
                  : launch_s<1>(feat, rois, base, hs, ws, scales, out, N, C,
                                P, s, band_rows, lanes_log2, smem_bytes, st);
}
