// K1: deform_im2col_windowed -- bounded-window DCNv1 sampling (fp32).
//
// Replaces the Pallas bodies _dcn_rowmm_kernel / _dcn_rowmm_yfold_kernel of
// dynamask_tpu/ops/deform_conv_pallas.py:deform_conv2d_rowmm, the TPU
// dispatch of every SFM fuse_conv_1 (dynamask_tpu/ops/deform_conv.py:404-428).
// As there, the kernel only samples: it writes the im2col tensor, and the
// (tap, channel) -> C_out contraction is one torch.matmul outside it.
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
// Bound on the H100: memory. col is T = 9 times the size of x; per element
// the kernel does ~15 flops against 4 bytes written, far below the card's
// ~20 flop/byte fp32 ridge. Design: one thread per col element with the
// channel index fastest, so a warp reads 32 consecutive channels of each
// bilinear corner (coalesced NHWC rows) and writes 128 contiguous bytes of
// col; the two offsets of a (pixel, group, tap) are one broadcast load for
// the warp. No shared memory: the 4 corners of neighbouring taps hit L1/L2.
// Fusing the sampling into the GEMM (implicit GEMM on wgmma) would remove the
// col round trip through HBM and is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void deform_im2col_windowed_kernel(
    const float* __restrict__ x, const float* __restrict__ off,
    float* __restrict__ col, int H, int W, int C, int g, int k, int pad,
    int dil, float window, long long total) {
  const int cg = C / g;
  const int T = k * k;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cg);
    long long r = idx / cg;
    const int t = (int)(r % T);
    r /= T;
    const int gi = (int)(r % g);
    const long long pix = r / g;            // (ni * H + yy) * W + xx
    const int xx = (int)(pix % W);
    const int yy = (int)((pix / W) % H);
    const long long ni = pix / ((long long)W * H);
    const int i = t / k;
    const int j = t - i * k;

    const float* o = off + pix * (2LL * g * T) + 2LL * (gi * T + t);
    float rel_y = (float)(i * dil - pad) + o[0];
    float rel_x = (float)(j * dil - pad) + o[1];
    const float py = (float)yy + rel_y;
    const float px = (float)xx + rel_x;
    float v = 0.f;
    if (py > -1.f && py < (float)H && px > -1.f && px < (float)W) {
      rel_y = fminf(fmaxf(rel_y, -window), window);
      rel_x = fminf(fmaxf(rel_x, -window), window);
      const float fy = floorf(rel_y);
      const float fx = floorf(rel_x);
      // tent weights of the two window cells each axis touches
      const float wy0 = 1.f - (rel_y - fy), wy1 = 1.f - ((fy + 1.f) - rel_y);
      const float wx0 = 1.f - (rel_x - fx), wx1 = 1.f - ((fx + 1.f) - rel_x);
      const int y0 = yy + (int)fy, x0 = xx + (int)fx;
      const float* plane = x + ni * (long long)H * W * C + gi * cg + c;
      const bool ry0 = y0 >= 0 && y0 < H, ry1 = y0 + 1 >= 0 && y0 + 1 < H;
      const bool rx0 = x0 >= 0 && x0 < W, rx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const float v00 = (ry0 && rx0) ? plane[((long long)y0 * W + x0) * C] : 0.f;
      const float v01 = (ry0 && rx1) ? plane[((long long)y0 * W + x0 + 1) * C] : 0.f;
      const float v10 = (ry1 && rx0) ? plane[((long long)(y0 + 1) * W + x0) * C] : 0.f;
      const float v11 = (ry1 && rx1) ? plane[((long long)(y0 + 1) * W + x0 + 1) * C] : 0.f;
      v = (v00 * wx0 + v01 * wx1) * wy0 + (v10 * wx0 + v11 * wx1) * wy1;
    }
    col[idx] = v;
  }
}

}  // namespace

extern "C" int deform_im2col_windowed_f32(
    const float* x, const float* offsets, float* col, int n, int H, int W,
    int C, int g, int k, int pad, int dil, int window, void* stream) {
  const long long total = (long long)n * H * W * C * k * k;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond this
  deform_im2col_windowed_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      x, offsets, col, H, W, C, g, k, pad, dil, (float)window, total);
  return (int)cudaGetLastError();
}
