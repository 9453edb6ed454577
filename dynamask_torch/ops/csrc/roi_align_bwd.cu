// K4: roi_align_bwd -- the backward of K2 (fp32): the gradient of the flat
// feature buffer from the gradient of the RoI crops.
//
// The JAX package differentiates its XLA RoIAlign (dynamask_tpu/ops/
// roi_align.py:roi_align / multilevel_roi_align, _bilinear_gather :46-128)
// with XLA's autodiff and has no Pallas backward; on the H100 the transpose
// of K2 is this kernel. RoIs carry no gradient: proposals and mask targets
// are detached in the JAX training step.
//
// Every output bin of K2 is the mean of s x s bilinear samples; here each
// sample adds d_out / s^2 times its four bilinear weights into the four
// (edge-clamped) corners of its plane, with K2's rules exactly: a sample
// outside [-1, extent] on either axis adds nothing, an inside one clamps to
// the plane, and the coordinate arithmetic is kept unfused as in K2 so both
// kernels see the same sample positions.
//
// Layouts as K2: d_out (N, P, P, C); d_feat (rows, C) is the flat buffer of
// every (image, level) plane laid out NHWC and concatenated, zeroed by the
// caller; RoI r reads the plane that starts at row base[r], of extent
// (h[r], w[r]), at coordinate scale scale[r].
//
// Bound on the H100: memory. Each d_out element is read once and scatters
// 4*s*s atomics (neighbouring bins hit the same corners, mostly in L2).
// Design: K2's thread layout, one thread per (RoI, bin, channel) with the
// channel fastest, so each corner atomic of a warp covers 128 contiguous
// bytes of an NHWC row. fp32 atomics make the order of the sums, and so the
// last bits of d_feat, vary between runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void roi_align_bwd_kernel(
    const float* __restrict__ d_out, const float* __restrict__ rois,
    const long long* __restrict__ base, const int* __restrict__ hs,
    const int* __restrict__ ws, const float* __restrict__ scales,
    float* __restrict__ d_feat, int C, int P, int s, long long total) {
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
    float* plane = d_feat + base[n] * C + c;
    const float gd = d_out[idx] / (float)(s * s);
    if (gd == 0.f) continue;

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
        atomicAdd(plane + ((long long)y0 * w + x0) * C, gd * (hy * hx));
        atomicAdd(plane + ((long long)y0 * w + x1i) * C, gd * (hy * lx));
        atomicAdd(plane + ((long long)y1i * w + x0) * C, gd * (ly * hx));
        atomicAdd(plane + ((long long)y1i * w + x1i) * C, gd * (ly * lx));
      }
    }
  }
}

}  // namespace

extern "C" int roi_align_bwd_f32(
    const float* d_out, const float* rois, const long long* base,
    const int* hs, const int* ws, const float* scales, float* d_feat, int N,
    int C, int P, int s, void* stream) {
  const long long total = (long long)N * P * P * C;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond this
  roi_align_bwd_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      d_out, rois, base, hs, ws, scales, d_feat, C, P, s, total);
  return (int)cudaGetLastError();
}
