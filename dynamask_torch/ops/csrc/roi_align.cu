// K2: roi_align_fwd -- FPN-routed or single-level RoIAlign, fp32 and bf16,
// mmcv aligned=True rules with a static sampling ratio.
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
// is not a multiple of 16 bytes' channels (4 fp32, 8 bf16), or a misaligned
// base, runs the scalar instance.
//
// bf16 (the mixed-precision policy of dynamask_tpu/core/fp16.py): features
// and crops are bf16, 8 channels a lane in 16-byte loads and stores; RoIs,
// scales and plane indices are the fp32 instance's. Coordinates and weights
// are fp32, the blend widens each corner and sums in fp32, and the mean is
// rounded once. The JAX form keeps the features' type and rounds the
// bilinear weights to it (dynamask_tpu/ops/roi_align.py:105-110), so the two
// agree to about a bf16 ulp of the crop.

#include "elem.cuh"

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

// acc += v00*(hy*hx) + v01*(hy*lx) + v10*(ly*hx) + v11*(ly*lx), per lane
template <int VEC>
__device__ __forceinline__ void blend_add(float (&acc)[VEC],
                                          const float (&v00)[VEC],
                                          const float (&v01)[VEC],
                                          const float (&v10)[VEC],
                                          const float (&v11)[VEC],
                                          const AxisSample& y,
                                          const AxisSample& x) {
#pragma unroll
  for (int u = 0; u < VEC; ++u)
    acc[u] += v00[u] * (y.h * x.h) + v01[u] * (y.h * x.l) +
              v10[u] * (y.l * x.h) + v11[u] * (y.l * x.l);
}

// S > 0 fixes the sampling ratio at compile time; S == 0 reads s.
template <typename T, int VEC, int S>
__global__ void __launch_bounds__(THREADS, 4) roi_align_band_kernel(
    const T* __restrict__ feat, const float* __restrict__ rois,
    const long long* __restrict__ base, const int* __restrict__ hs,
    const int* __restrict__ ws, const float* __restrict__ scales,
    T* __restrict__ out, int C, int P, int s_rt, int band_rows, int n_bands,
    int lanes_log2) {
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
  const T* plane = feat + base[n] * C;
  T* outb = out + (n * P + py_first) * P * C;
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
      float acc[VEC];
      elem::fill(acc, 0.f);
      // s is a constant where S > 0, and these loops unroll
      for (int iy = 0; iy < s; ++iy) {
        const AxisSample ya = t_y[r * s + iy];
        if (ya.i0 < 0) continue;
        for (int ix = 0; ix < s; ++ix) {
          const AxisSample xa = t_x[px * s + ix];
          if (xa.i0 < 0) continue;
          float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
          elem::load_ro<T, VEC>(plane + (ya.i0 + xa.i0) * C + c, v00);
          elem::load_ro<T, VEC>(plane + (ya.i0 + xa.i1) * C + c, v01);
          elem::load_ro<T, VEC>(plane + (ya.i1 + xa.i0) * C + c, v10);
          elem::load_ro<T, VEC>(plane + (ya.i1 + xa.i1) * C + c, v11);
          blend_add<VEC>(acc, v00, v01, v10, v11, ya, xa);
        }
      }
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u] = acc[u] / ss;
      elem::store_cs<T, VEC>(outb + (r * P + px) * C + c, acc);
    }
  }
}

template <typename T, int VEC, int S>
int launch(const T* feat, const float* rois, const long long* base,
           const int* hs, const int* ws, const float* scales, T* out, int N,
           int C, int P, int s, int band_rows, int lanes_log2, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = roi_align_band_kernel<T, VEC, S>;
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

template <typename T, int VEC>
int launch_s(const T* feat, const float* rois, const long long* base,
             const int* hs, const int* ws, const float* scales, T* out,
             int N, int C, int P, int s, int band_rows, int lanes_log2,
             int smem_bytes, cudaStream_t stream) {
  switch (s) {
    case 1:
      return launch<T, VEC, 1>(feat, rois, base, hs, ws, scales, out, N, C,
                               P, s, band_rows, lanes_log2, smem_bytes,
                               stream);
    case 2:
      return launch<T, VEC, 2>(feat, rois, base, hs, ws, scales, out, N, C,
                               P, s, band_rows, lanes_log2, smem_bytes,
                               stream);
    default:
      return launch<T, VEC, 0>(feat, rois, base, hs, ws, scales, out, N, C,
                               P, s, band_rows, lanes_log2, smem_bytes,
                               stream);
  }
}

// Checks the launch configuration and launches the instance of `vec`: the
// 16-byte one (4 fp32, 8 bf16 channels a lane) or the scalar one.
template <typename T>
int entry(const T* feat, const float* rois, const long long* base,
          const int* hs, const int* ws, const float* scales, T* out, int N,
          int C, int P, int s, long long rows, int band_rows, int vec,
          int lanes_log2, int smem_bytes, void* stream) {
  constexpr int WIDE = elem::Wide<T>::kVec;
  if ((long long)N * P * C == 0) return 0;
  const int b = band_rows < P ? band_rows : P;
  const long long blocks =
      band_rows > 0 ? (long long)N * ((P + band_rows - 1) / band_rows) : 0;
  if (s <= 0 || band_rows <= 0 || lanes_log2 < 0 || lanes_log2 > 5 ||
      (vec == WIDE ? C % WIDE != 0 : vec != 1) ||
      (long long)(P + b) * s * ENTRY_BYTES > smem_bytes ||
      // 32-bit indices: the flat buffer, one RoI's crop, the grid
      rows * C >= (1LL << 31) || (long long)P * P * C >= (1LL << 31) ||
      blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return vec == WIDE
             ? launch_s<T, WIDE>(feat, rois, base, hs, ws, scales, out, N, C,
                                 P, s, band_rows, lanes_log2, smem_bytes, st)
             : launch_s<T, 1>(feat, rois, base, hs, ws, scales, out, N, C, P,
                              s, band_rows, lanes_log2, smem_bytes, st);
}

}  // namespace

// band_rows, vec (16 bytes of channels: 4 fp32 or 8 bf16; or 1), lanes_log2
// and smem_bytes come from the wrapper's launch configuration
// (ops/roi_align.py:roi_align_launch_config); a configuration the kernel
// cannot run is refused with cudaErrorInvalidValue before anything is
// launched. `rows` is the row count of the flat buffer. The features and
// the crops share the element type of the symbol; RoIs and scales are fp32.
extern "C" int roi_align_fwd_f32(
    const float* feat, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, float* out, int N,
    int C, int P, int s, long long rows, int band_rows, int vec,
    int lanes_log2, int smem_bytes, void* stream) {
  return entry<float>(feat, rois, base, hs, ws, scales, out, N, C, P, s,
                      rows, band_rows, vec, lanes_log2, smem_bytes, stream);
}

extern "C" int roi_align_fwd_bf16(
    const __nv_bfloat16* feat, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, __nv_bfloat16* out,
    int N, int C, int P, int s, long long rows, int band_rows, int vec,
    int lanes_log2, int smem_bytes, void* stream) {
  return entry<__nv_bfloat16>(feat, rois, base, hs, ws, scales, out, N, C, P,
                              s, rows, band_rows, vec, lanes_log2,
                              smem_bytes, stream);
}
