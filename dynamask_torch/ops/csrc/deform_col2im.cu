// K3: deform_col2im_windowed -- the backward of K1 (fp32): from the column
// gradient d_col to d_x and d_offset.
//
// Replaces the Pallas body _dcn_rowmm_bwd_kernel of
// dynamask_tpu/ops/deform_conv_pallas.py:deform_conv2d_rowmm_ad (the
// backward _rowmm_ad_bwd), the TPU backward of every SFM fuse_conv_1. As
// there, d_w and d_col are matrix products outside the kernel.
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
// and take no gradient.
//
// Layouts: x (n, H, W, C) NHWC, offsets and d_offset (n, H, W, g*T*2) with
// channel order (g, kh, kw, [dy, dx]), d_col (n, H, W, g, T, C/g), d_x
// (n, H, W, C), zeroed by the caller.
//
// Bound on the H100: memory. d_col is T = 9 times the size of x and is read
// once; per element the kernel does ~20 flops against 4 bytes read plus up to
// four 4-byte atomics into d_x (mostly hits in L2: neighbouring taps share
// corners). Design: one warp per (pixel, group, tap) with the lanes over the
// channels, so d_col reads and corner reads/atomics are 128 contiguous bytes
// of an NHWC row; the two channel sums are warp-shuffle reductions and lane
// 0 writes the two offset gradients. Corners whose tent weight is 0 (every
// far corner at an integer displacement) skip their atomics. fp32 atomics
// make the order of d_x's sums, and so its last bits, vary between runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

__global__ void deform_col2im_windowed_kernel(
    const float* __restrict__ x, const float* __restrict__ off,
    const float* __restrict__ d_col, float* __restrict__ d_x,
    float* __restrict__ d_off, int H, int W, int C, int g, int k, int pad,
    int dil, float window, long long total_warps) {
  const int cg = C / g;
  const int T = k * k;
  const int lane = threadIdx.x & 31;
  const long long warps_per_grid = ((long long)gridDim.x * blockDim.x) >> 5;
  // every lane of a warp holds the same item, so all branches below are
  // warp-uniform and the full-mask shuffles are safe
  for (long long item = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
       item < total_warps; item += warps_per_grid) {
    const int t = (int)(item % T);
    long long r = item / T;
    const int gi = (int)(r % g);
    const long long pix = r / g;             // (ni * H + yy) * W + xx
    const int xx = (int)(pix % W);
    const int yy = (int)((pix / W) % H);
    const long long ni = pix / ((long long)W * H);
    const int i = t / k;
    const int j = t - i * k;

    const long long o_at = pix * (2LL * g * T) + 2LL * (gi * T + t);
    const float rel_y0 = (float)(i * dil - pad) + off[o_at];
    const float rel_x0 = (float)(j * dil - pad) + off[o_at + 1];
    const float py = (float)yy + rel_y0;
    const float px = (float)xx + rel_x0;
    if (!(py > -1.f && py < (float)H && px > -1.f && px < (float)W)) {
      if (lane == 0) {
        d_off[o_at] = 0.f;
        d_off[o_at + 1] = 0.f;
      }
      continue;
    }
    const float rel_y = fminf(fmaxf(rel_y0, -window), window);
    const float rel_x = fminf(fmaxf(rel_x0, -window), window);
    const float fy = floorf(rel_y);
    const float fx = floorf(rel_x);
    // the forward's tent weights, expression for expression (K1)
    const float wy0 = 1.f - (rel_y - fy), wy1 = 1.f - ((fy + 1.f) - rel_y);
    const float wx0 = 1.f - (rel_x - fx), wx1 = 1.f - ((fx + 1.f) - rel_x);
    const int y0 = yy + (int)fy, x0 = xx + (int)fx;
    const bool ry0 = y0 >= 0 && y0 < H, ry1 = y0 + 1 >= 0 && y0 + 1 < H;
    const bool rx0 = x0 >= 0 && x0 < W, rx1 = x0 + 1 >= 0 && x0 + 1 < W;
    const bool a00 = ry0 && rx0 && wy0 * wx0 != 0.f;
    const bool a01 = ry0 && rx1 && wy0 * wx1 != 0.f;
    const bool a10 = ry1 && rx0 && wy1 * wx0 != 0.f;
    const bool a11 = ry1 && rx1 && wy1 * wx1 != 0.f;
    const long long plane = ni * (long long)H * W * C + gi * cg;
    const long long p00 = plane + ((long long)y0 * W + x0) * C;
    const long long p01 = p00 + C;
    const long long p10 = p00 + (long long)W * C;
    const long long p11 = p10 + C;
    const float* dc = d_col + item * cg;   // item == (pix * g + gi) * T + t

    float sy = 0.f, sx = 0.f;
    for (int c = lane; c < cg; c += 32) {
      const float d = dc[c];
      const float v00 = (ry0 && rx0) ? x[p00 + c] : 0.f;
      const float v01 = (ry0 && rx1) ? x[p01 + c] : 0.f;
      const float v10 = (ry1 && rx0) ? x[p10 + c] : 0.f;
      const float v11 = (ry1 && rx1) ? x[p11 + c] : 0.f;
      sy += d * (wx0 * (v10 - v00) + wx1 * (v11 - v01));
      sx += d * (wy0 * (v01 - v00) + wy1 * (v11 - v10));
      if (a00) atomicAdd(d_x + p00 + c, d * (wy0 * wx0));
      if (a01) atomicAdd(d_x + p01 + c, d * (wy0 * wx1));
      if (a10) atomicAdd(d_x + p10 + c, d * (wy1 * wx0));
      if (a11) atomicAdd(d_x + p11 + c, d * (wy1 * wx1));
    }
    sy = warp_sum(sy);
    sx = warp_sum(sx);
    if (lane == 0) {
      d_off[o_at] = (rel_y > fy && fabsf(rel_y0) < window) ? sy : 0.f;
      d_off[o_at + 1] = (rel_x > fx && fabsf(rel_x0) < window) ? sx : 0.f;
    }
  }
}

}  // namespace

extern "C" int deform_col2im_windowed_f32(
    const float* x, const float* offsets, const float* d_col, float* d_x,
    float* d_offsets, int n, int H, int W, int C, int g, int k, int pad,
    int dil, int window, void* stream) {
  const long long total_warps = (long long)n * H * W * g * k * k;
  if (total_warps == 0) return 0;
  const int threads = 256;                      // 8 warps, 8 items a block
  long long blocks = (total_warps * 32 + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond this
  deform_col2im_windowed_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      x, offsets, d_col, d_x, d_offsets, H, W, C, g, k, pad, dil,
      (float)window, total_warps);
  return (int)cudaGetLastError();
}
