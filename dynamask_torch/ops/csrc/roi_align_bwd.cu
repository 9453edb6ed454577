// K4: roi_align_bwd -- the backward of K2, from an fp32 or a bf16 d_out:
// the gradient of the flat feature buffer from the gradient of the RoI
// crops.
//
// The JAX package differentiates its XLA RoIAlign (dynamask_tpu/ops/
// roi_align.py:roi_align / multilevel_roi_align, _bilinear_gather :46-128)
// with XLA's autodiff and has no Pallas backward; on the H100 the transpose
// of K2 is this kernel. RoIs carry no gradient: proposals and mask targets
// are detached in the JAX training step.
//
// Every output bin of K2 is the mean of s x s bilinear samples, so each
// sample passes d_out / s^2 times its four bilinear weights to the four
// (edge-clamped) corners of its plane, with K2's rules exactly: a sample
// outside [-1, extent] on either axis passes nothing, an inside one clamps
// to the plane, and the coordinate arithmetic is kept unfused as in K2 so
// both kernels see the same sample positions.
//
// Layouts as K2: d_out (N, P, P, C); d_feat (rows, C) is the flat buffer of
// every (image, level) plane laid out NHWC and concatenated, zeroed by the
// caller; RoI r reads the plane that starts at row base[r], of extent
// (h[r], w[r]), at coordinate scale scale[r].
//
// Bound on the H100: bytes, d_out read once and d_feat written once.
//
// What held the first design back (K2's first layout, one thread per (RoI,
// bin, channel), 4*s*s scalar fp32 atomics per d_out element): 11-20% of the
// bound, K2's instruction-issue costs plus 822 M atomics for the MSM crop
// alone, many on one address (neighbouring bins of a RoI whose bins are
// narrower than a pixel share corners, and ~6 positive RoIs share each GT).
//
// This design is the transpose of the separable crop, on K2's grid (one
// block per (RoI, band of B output rows), B from the wrapper's launch
// configuration, ops/roi_align.py:roi_align_launch_config). One RoI's crop
// is A_y . plane . A_x^T with per-axis tent matrices (dynamask_tpu/ops/
// roi_align.py:tent_matrix :344, roi_align_separable :388), so its
// footprint's gradient is A_y^T . d_out . A_x / s^2. The block builds the
// RoI's x samples and the band's y samples into tables in shared memory. A
// sample coordinate is monotone in (bin, sub-sample) after the clamp, so the
// tables are kept in ascending order and the samples that touch one feature
// column X (x0 in {X - 1, X}) are one contiguous run, found by binary search.
// A group of lanes owns (column X, channel quad) of the RoI's footprint: it
// gathers the x-contraction of each of the band's d_out rows from that run
// with 16-byte loads, no atomics, and accumulates the y-contraction in
// registers over the band's feature rows, which rise with the samples: two
// rows are open at a time, and a row is flushed, once, with one 16-byte
// reduction into d_feat (red.global.add.v4.f32, sm_90) when the samples have
// passed it. Reductions meet only where bands or RoIs overlap.
//
// K2's layout read backwards (lanes over output bins, each inside sample
// adding d_out times its four weights into its four corners with 16-byte
// reductions) was measured beside it at the six training crops, with
// synthetic and with clustered RoIs, and was slower at every one, by
// 1.5-3.0x (tools/ab_torch_roi.py --ablate builds it beside this source).
// Where bins are wider than a pixel the gather flushes as many rows as that
// form adds corners, and still wins.
//
// fp32 atomics make the order of the sums, and so the last bits of d_feat,
// vary between runs. A C that is not a multiple of 4, or a misaligned base,
// runs the scalar instance.
//
// bf16 (the mixed-precision training step): d_out is read as bf16 as it
// is, 4 channels a lane as in fp32, in 8-byte loads, so that the flushes
// keep the fp32 instance's 16-byte reductions side by side (csrc/
// elem.cuh); the contractions and the row accumulators are fp32, and
// d_feat is the fp32 scratch the caller zero-fills in either type. The caller
// rounds d_feat to the features' type once at the end. No bf16 atomics: a
// bf16 sum in L2 would round at every add.

#include <limits.h>

#include "elem.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ENTRY_BYTES = 16;   // shared bytes per axis sample

// One sample of one axis: i0 its clamped first corner, i1 the output bin it
// belongs to, h = 1 - l and l the weights of its two corners.
struct AxisSample {
  int i0, i1;
  float h, l;
};

// Sample k = p * s + i of an axis starting at `lo` with bins of `bin`: K2's
// arithmetic, expression for expression. Returns whether it is inside.
__device__ __forceinline__ bool axis_geometry(int k, int s, float lo,
                                              float bin, int extent, int& v0,
                                              float& h, float& l) {
  const int p = k / s, i = k - (k / s) * s;
  const float g = __fadd_rn((float)p, __fdiv_rn((float)i + 0.5f, (float)s));
  const float v = __fadd_rn(lo, __fmul_rn(bin, g));
  const float ef = (float)extent;
  const float vc = fminf(fmaxf(v, 0.f), ef - 1.f);
  const float v0f = floorf(vc);
  l = vc - v0f;
  h = 1.f - l;
  v0 = (int)v0f;
  return v >= -1.f && v <= ef;
}

template <int VEC>
__device__ __forceinline__ bool nonzero(const float (&v)[VEC]) {
  bool any = false;
#pragma unroll
  for (int u = 0; u < VEC; ++u) any = any || v[u] != 0.f;
  return any;
}
template <int VEC>
__device__ __forceinline__ void axpy(float (&acc)[VEC], float a,
                                     const float (&v)[VEC]) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc[u] += a * v[u];
}
template <int VEC>
__device__ __forceinline__ void assign(float (&dst)[VEC],
                                     const float (&src)[VEC]) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) dst[u] = src[u];
}

// The RoI's geometry, K2's arithmetic: the first sample's coordinates and
// the bin sizes.
__device__ __forceinline__ void roi_geometry(const float* roi, float sc,
                                             int P, float& x1, float& y1,
                                             float& bin_w, float& bin_h) {
  const float offset = 0.5f;   // aligned=True: the half-pixel shift
  x1 = __fsub_rn(__fmul_rn(roi[0], sc), offset);
  y1 = __fsub_rn(__fmul_rn(roi[1], sc), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], sc), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], sc), offset);
  bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)P);
  bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)P);
}

// *p += acc / s^2 (inv = 1 / s^2), where anything was gathered: one fp32
// reduction in L2 per 4 channels (red.global.add.v4.f32), or a scalar one
template <int VEC>
__device__ __forceinline__ void flush(float* p, const float (&acc)[VEC],
                                      float inv) {
  if (nonzero(acc)) elem::red_add<VEC>(p, acc, inv);
}

// First slot in [lo, hi) of the ascending table whose clamped corner is at
// least v (hi if none).
__device__ __forceinline__ int first_at_least(const AxisSample* t, int lo,
                                              int hi, int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid].i0 < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The x-contraction of one d_out row for feature column X into t: the sum
// over the run [jlo, jhi) of x samples that touch X of each sample's weight
// at X times d_out at its bin (row pointer `dn`, advanced to the lane's
// channels). Samples of one bin lie side by side in the run and share one
// load.
template <typename T, int VEC>
__device__ __forceinline__ void x_contraction(const AxisSample* t_x, int jlo,
                                              int jhi, int X, int w,
                                              const T* dn, int C,
                                              float (&t)[VEC]) {
  float v[VEC];
  elem::fill(t, 0.f);
  float wsum = 0.f;
  int bin = t_x[jlo].i1;
  for (int j = jlo; j < jhi; ++j) {
    const AxisSample xa = t_x[j];
    if (xa.i1 != bin) {
      if (wsum != 0.f) {
        elem::load_ro<T, VEC>(dn + bin * C, v);
        axpy(t, wsum, v);
      }
      wsum = 0.f;
      bin = xa.i1;
    }
    wsum += (xa.i0 == X ? xa.h : 0.f) + (min(xa.i0 + 1, w - 1) == X ? xa.l
                                                                   : 0.f);
  }
  if (wsum != 0.f) {
    elem::load_ro<T, VEC>(dn + bin * C, v);
    axpy(t, wsum, v);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 4) roi_align_bwd_band_kernel(
    const T* __restrict__ d_out, const float* __restrict__ rois,
    const long long* __restrict__ base, const int* __restrict__ hs,
    const int* __restrict__ ws, const float* __restrict__ scales,
    float* __restrict__ d_feat, int C, int P, int s, int band_rows,
    int n_bands, int lanes_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  AxisSample* t_x = reinterpret_cast<AxisSample*>(smem);   // P*s, ascending
  AxisSample* t_y = t_x + P * s;                            // rows*s, ascending
  // the inside samples' slots: x first, last; y first, last
  __shared__ int lim[4];

  const int band = (int)(blockIdx.x % (unsigned)n_bands);
  const long long n = blockIdx.x / (unsigned)n_bands;
  const int py_first = band * band_rows;
  const int rows = min(band_rows, P - py_first);
  float x1, y1, bin_w, bin_h;
  roi_geometry(rois + 4 * n, scales[n], P, x1, y1, bin_w, bin_h);
  const int h = hs[n], w = ws[n];

  if (threadIdx.x == 0) {
    lim[0] = lim[2] = INT_MAX;
    lim[1] = lim[3] = -1;
  }
  __syncthreads();
  // a coordinate rises with the sample index when the bin is not negative
  // and falls with it otherwise: the tables are laid out so that it rises
  const bool up_x = bin_w >= 0.f, up_y = bin_h >= 0.f;
  const int nx = P * s, ny = rows * s;
  for (int e = threadIdx.x; e < nx + ny; e += THREADS) {
    const bool is_x = e < nx;
    const int t = is_x ? e : e - nx;
    const int k = is_x ? (up_x ? t : nx - 1 - t)
                       : py_first * s + (up_y ? t : ny - 1 - t);
    AxisSample a;
    const bool inside = is_x ? axis_geometry(k, s, x1, bin_w, w, a.i0, a.h,
                                             a.l)
                             : axis_geometry(k, s, y1, bin_h, h, a.i0, a.h,
                                             a.l);
    a.i1 = k / s;
    (is_x ? t_x : t_y)[t] = a;
    if (inside) {   // the inside samples of a sorted axis are one run
      atomicMin(&lim[is_x ? 0 : 2], t);
      atomicMax(&lim[is_x ? 1 : 3], t);
    }
  }
  __syncthreads();
  const int ilo = lim[0], ihi = lim[1], ylo = lim[2], yhi = lim[3];
  if (ihi < 0 || yhi < 0) return;   // the same for the whole block

  // the one 64-bit base of each array
  float* plane = d_feat + base[n] * C;
  const T* don = d_out + n * P * P * C;
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int slot = threadIdx.x >> lanes_log2;
  const int slots = THREADS >> lanes_log2;
  const int quads = C / VEC;
  const float inv = 1.f / (float)(s * s);
  // the footprint's columns
  const int xlo = t_x[ilo].i0, xhi = min(t_x[ihi].i0 + 1, w - 1);

  for (int X = xlo + slot; X <= xhi; X += slots) {
    // the x samples whose corners include X: x0 in {X - 1, X}
    const int jlo = first_at_least(t_x, ilo, ihi + 1, X - 1);
    const int jhi = first_at_least(t_x, jlo, ihi + 1, X + 1);
    if (jlo == jhi) continue;
    for (int q = sub; q < quads; q += lanes) {
      const int c = q * VEC;
      float* col = plane + X * C + c;
      // rows R and R + 1 are open; the samples' rows only rise
      float acc0[VEC], acc1[VEC], t[VEC];
      elem::fill(acc0, 0.f);
      elem::fill(acc1, 0.f);
      elem::fill(t, 0.f);
      int R = -1, bin = -1;
      for (int u = ylo; u <= yhi; ++u) {
        const AxisSample ya = t_y[u];
        if (ya.i1 != bin) {
          bin = ya.i1;
          x_contraction<T, VEC>(t_x, jlo, jhi, X, w, don + bin * P * C + c,
                                C, t);
        }
        if (ya.i0 != R) {   // rows below the sample's are done
          if (R >= 0) {
            flush(col + R * w * C, acc0, inv);
            if (ya.i0 == R + 1) {
              assign(acc0, acc1);
            } else {
              flush(col + (R + 1) * w * C, acc1, inv);
              elem::fill(acc0, 0.f);
            }
          }
          elem::fill(acc1, 0.f);
          R = ya.i0;
        }
        axpy(acc0, ya.h, t);
        if (min(R + 1, h - 1) == R) axpy(acc0, ya.l, t); else axpy(acc1, ya.l, t);
      }
      flush(col + R * w * C, acc0, inv);
      flush(col + (R + 1) * w * C, acc1, inv);   // 0 where R + 1 == h
    }
  }
}

template <typename T, int VEC>
int launch(const T* d_out, const float* rois, const long long* base,
           const int* hs, const int* ws, const float* scales, float* d_feat,
           int N, int C, int P, int s, int band_rows, int lanes_log2,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = roi_align_bwd_band_kernel<T, VEC>;
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
      d_out, rois, base, hs, ws, scales, d_feat, C, P, s, band_rows, n_bands,
      lanes_log2);
  return (int)cudaGetLastError();
}

// Checks the launch configuration and launches the instance of `vec`: 4
// channels a lane (a 16-byte fp32 reduction into d_feat) or the scalar one.
template <typename T>
int entry(const T* d_out, const float* rois, const long long* base,
          const int* hs, const int* ws, const float* scales, float* d_feat,
          int N, int C, int P, int s, long long rows, int band_rows, int vec,
          int lanes_log2, int smem_bytes, void* stream) {
  constexpr int WIDE = elem::kReduceVec;
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
             ? launch<T, WIDE>(d_out, rois, base, hs, ws, scales, d_feat, N,
                               C, P, s, band_rows, lanes_log2, smem_bytes, st)
             : launch<T, 1>(d_out, rois, base, hs, ws, scales, d_feat, N, C,
                            P, s, band_rows, lanes_log2, smem_bytes, st);
}

}  // namespace

// band_rows, vec (4 channels, in either type; or 1), lanes_log2 and
// smem_bytes come from the wrapper's launch configuration
// (ops/roi_align.py:roi_align_launch_config); a configuration the kernel
// cannot run is refused with cudaErrorInvalidValue before anything is
// launched. `rows` is the row count of d_feat, an fp32 sum for either type
// of d_out.
extern "C" int roi_align_bwd_f32(
    const float* d_out, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, float* d_feat, int N,
    int C, int P, int s, long long rows, int band_rows, int vec,
    int lanes_log2, int smem_bytes, void* stream) {
  return entry<float>(d_out, rois, base, hs, ws, scales, d_feat, N, C, P, s,
                      rows, band_rows, vec, lanes_log2, smem_bytes, stream);
}

extern "C" int roi_align_bwd_bf16(
    const __nv_bfloat16* d_out, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, float* d_feat, int N,
    int C, int P, int s, long long rows, int band_rows, int vec,
    int lanes_log2, int smem_bytes, void* stream) {
  return entry<__nv_bfloat16>(d_out, rois, base, hs, ws, scales, d_feat, N,
                              C, P, s, rows, band_rows, vec, lanes_log2,
                              smem_bytes, stream);
}
