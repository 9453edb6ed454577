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
// Bound on the H100: memory. Every output element reads 4*s*s feature
// values (most from L1/L2: neighbouring bins share corners) and does ~10
// flops per sample. Design: one thread per (RoI, bin, channel), channel
// fastest, so each corner load of a warp is 128 contiguous bytes of an NHWC
// row and the output write is coalesced; the RoI geometry is recomputed per
// thread (a few flops) instead of staged in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void roi_align_fwd_kernel(
    const float* __restrict__ feat, const float* __restrict__ rois,
    const long long* __restrict__ base, const int* __restrict__ hs,
    const int* __restrict__ ws, const float* __restrict__ scales,
    float* __restrict__ out, int C, int P, int s, long long total) {
  const float offset = 0.5f;   // aligned=True: the half-pixel shift
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    long long r = idx / C;
    const int px = (int)(r % P);
    r /= P;
    const int py = (int)(r % P);
    const long long n = r / P;

    const float sc = scales[n];
    const float* roi = rois + 4 * n;
    const float x1 = __fsub_rn(__fmul_rn(roi[0], sc), offset);
    const float y1 = __fsub_rn(__fmul_rn(roi[1], sc), offset);
    const float x2 = __fsub_rn(__fmul_rn(roi[2], sc), offset);
    const float y2 = __fsub_rn(__fmul_rn(roi[3], sc), offset);
    const float roi_w = __fsub_rn(x2, x1), roi_h = __fsub_rn(y2, y1);
    const float bin_w = __fdiv_rn(roi_w, (float)P);
    const float bin_h = __fdiv_rn(roi_h, (float)P);
    const int h = hs[n], w = ws[n];
    const float hf = (float)h, wf = (float)w;
    const float* plane = feat + base[n] * C + c;

    float acc = 0.f;
    for (int iy = 0; iy < s; ++iy) {
      const float gy = __fadd_rn((float)py,
                                 __fdiv_rn((float)iy + 0.5f, (float)s));
      const float y = __fadd_rn(y1, __fmul_rn(bin_h, gy));
      for (int ix = 0; ix < s; ++ix) {
        const float gx = __fadd_rn((float)px,
                                   __fdiv_rn((float)ix + 0.5f, (float)s));
        const float x = __fadd_rn(x1, __fmul_rn(bin_w, gx));
        if (!(y >= -1.f && y <= hf && x >= -1.f && x <= wf)) continue;
        const float yc = fminf(fmaxf(y, 0.f), hf - 1.f);
        const float xc = fminf(fmaxf(x, 0.f), wf - 1.f);
        const float y0f = floorf(yc), x0f = floorf(xc);
        const float ly = yc - y0f, lx = xc - x0f;
        const float hy = 1.f - ly, hx = 1.f - lx;
        const int y0 = (int)y0f, x0 = (int)x0f;
        const int y1i = min(y0 + 1, h - 1), x1i = min(x0 + 1, w - 1);
        const float v00 = plane[((long long)y0 * w + x0) * C];
        const float v01 = plane[((long long)y0 * w + x1i) * C];
        const float v10 = plane[((long long)y1i * w + x0) * C];
        const float v11 = plane[((long long)y1i * w + x1i) * C];
        acc += v00 * (hy * hx) + v01 * (hy * lx) + v10 * (ly * hx) +
               v11 * (ly * lx);
      }
    }
    out[idx] = acc / (float)(s * s);
  }
}

}  // namespace

extern "C" int roi_align_fwd_f32(
    const float* feat, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, float* out, int N,
    int C, int P, int s, void* stream) {
  const long long total = (long long)N * P * P * C;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond this
  roi_align_fwd_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      feat, rois, base, hs, ws, scales, out, C, P, s, total);
  return (int)cudaGetLastError();
}
