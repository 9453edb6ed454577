// K5: deform_conv_fused -- the whole bounded-window DCNv1 forward in one
// launch: bilinear window sampling and the per-tap (channel) -> C_out
// contraction, accumulated in fp32 on the CUDA cores.
//
// Replaces the Pallas bodies _dcn_win_kernel (deform_conv2d_windowed_pallas,
// dynamask_tpu/ops/deform_conv_pallas.py:40) and _dcn_frame_kernel
// (deform_conv2d_frame, :177). Both sample AND contract inside their body,
// so this kernel does too; no column tensor goes through device memory.
//
// Semantics are K1's (csrc/deform_im2col.cu), with its unfused coordinate
// arithmetic, so K5 and K1 place every sample identically: for output pixel
// (y, x), deform group g and tap t = (i, j), rel = (i*dil - pad, j*dil - pad)
// + offset[g, t]; the sample is zero when the UNCLIPPED position leaves
// (-1, extent) on either axis, else rel is clipped to [-window, window] and
// the sample is bilinear on the zero-padded plane.
//
// Rounding rules, a template parameter:
//   ROUND = false (_dcn_win_kernel, :71/:76/:150): the sample and the product
//     in fp32 whatever the input type, one cast of the result to T;
//   ROUND = true (_dcn_frame_kernel, :189-207): the tent weights, each window
//     product, each row sum, each row times its y weight, the per-tap sample
//     and the weight are rounded to T; the product accumulates in fp32.
// For T = float the two rules are one function: one instantiation serves both.
//
// Layouts: x (n, S, S, C) NHWC; offsets (n, S, S, g*T*2) fp32, channel order
// (g, kh, kw, [dy, dx]); w2 (g*T*C/g, C_out) fp32, rows in the column
// tensor's (group, tap, channel) order; out (n, S, S, C_out) NHWC in T.
//
// Bound on the H100: operations. The contraction is 2*n*S^2*9*C*C_out flops
// against n*S^2*(C + 36 + C_out) elements read and written: at C = C_out
// about 9*C_out = 576-2304 flops per element, far above the card's ~20
// flop/byte fp32 ridge. Under ROUND with T = bf16 both factors of the
// product are bf16 and the sum fp32, work the tensor cores do at ~15x the
// fp32 rate; this kernel keeps it on the CUDA cores, so there it sits far
// from its bound. Design, simple first (in fp32 it reaches about a quarter
// of its bound; the sample loads do not overlap the FMAs): an
// implicit GEMM, M = output pixels, N = C_out, K = (group, tap, channel).
// One CTA per (128-pixel tile, 64-output-channel tile), 256 threads. It
// loops over the deform groups, the taps and 32-channel chunks of the
// group. Per (group, tap) 128 threads place their pixel's sample (corner,
// validity of the four corners, tent weights) in shared memory. Per chunk all
// threads write the chunk's 128 x 32 bilinear samples into shared memory
// (lanes 8 channels x 4 pixels: 32-byte corner rows, conflict-free stores
// into the padded tile), and the chunk's 32 x 64 weights beside them; then
// each thread adds an 8-pixel x 4-channel register block with fp32 FMAs.
// The output is written once. Tensor cores (TF32, wgmma) stay off: the port
// is held to fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                  // output pixels per CTA
constexpr int BN = 64;                   // output channels per CTA
constexpr int BK = 32;                   // input channels per chunk
constexpr int TM = 8;                    // pixels per thread
constexpr int TN = 4;                    // output channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int APAD = 4;                  // sample-tile row pad

static_assert(THREADS == 256, "the sampling lane map assumes 8 warps");
static_assert(BK == 32 && BM % 8 == 0, "the sampling lane map");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// astype(T) of the frame kernel: round an fp32 value to T's precision
template <typename T, bool ROUND>
__device__ __forceinline__ float rnd(float v) {
  return ROUND ? to_f32(from_f32<T>(v)) : v;
}

template <typename T, bool ROUND>
__global__ void __launch_bounds__(THREADS, 2) deform_conv_fused_kernel(
    const T* __restrict__ x, const float* __restrict__ off,
    const float* __restrict__ w2, T* __restrict__ out, int n, int S, int C,
    int Cout, int g, int k, int pad, int dil, float window) {
  __shared__ __align__(16) float As[BK][BM + APAD];   // samples, channel-major
  __shared__ __align__(16) float Bs[BK][BN];          // weights
  __shared__ int s_pix[BM];      // pixel index of corner (y0, x0)
  __shared__ int s_valid[BM];    // bits: (y0,x0) (y0,x0+1) (y0+1,x0) (y0+1,x0+1)
  __shared__ float s_w[4][BM];   // wy0, wy1, wx0, wx1

  const int H = S, W = S;
  const int tid = threadIdx.x;
  const long long M = (long long)n * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int cg = C / g;
  const int T_ = k * k;

  // GEMM map: 16 x 16 threads, each TM pixels x TN output channels
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);
  // sampling map: a warp covers 8 channels x 4 pixels per step
  const int lane = tid & 31, warp = tid >> 5;
  const int s_c = (warp & 3) * 8 + (lane & 7);          // 0..31
  const int s_p0 = (warp >> 2) * 4 + (lane >> 3);       // 0..7, step 8

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    for (int t = 0; t < T_; ++t) {
      if (tid < BM) {
        // K1's coordinate arithmetic, unfused, for pixel m0 + tid
        const long long m = m0 + tid;
        int valid = 0, pix = 0;
        float wy0 = 0.f, wy1 = 0.f, wx0 = 0.f, wx1 = 0.f;
        if (m < M) {
          const int xx = (int)(m % W);
          const int yy = (int)((m / W) % H);
          const long long ni = m / ((long long)W * H);
          const int i = t / k;
          const int j = t - i * k;
          const float* o = off + m * (2LL * g * T_) + 2LL * (gi * T_ + t);
          float rel_y = (float)(i * dil - pad) + o[0];
          float rel_x = (float)(j * dil - pad) + o[1];
          const float py = (float)yy + rel_y;
          const float px = (float)xx + rel_x;
          if (py > -1.f && py < (float)H && px > -1.f && px < (float)W) {
            rel_y = fminf(fmaxf(rel_y, -window), window);
            rel_x = fminf(fmaxf(rel_x, -window), window);
            const float fy = floorf(rel_y);
            const float fx = floorf(rel_x);
            wy0 = 1.f - (rel_y - fy);
            wy1 = 1.f - ((fy + 1.f) - rel_y);
            wx0 = 1.f - (rel_x - fx);
            wx1 = 1.f - ((fx + 1.f) - rel_x);
            const int y0 = yy + (int)fy, x0 = xx + (int)fx;
            const bool ry0 = y0 >= 0 && y0 < H, ry1 = y0 + 1 >= 0 && y0 + 1 < H;
            const bool rx0 = x0 >= 0 && x0 < W, rx1 = x0 + 1 >= 0 && x0 + 1 < W;
            valid = (ry0 && rx0) | ((ry0 && rx1) << 1) | ((ry1 && rx0) << 2) |
                    ((ry1 && rx1) << 3);
            pix = (int)((ni * H + y0) * W + x0);
          }
        }
        s_pix[tid] = pix;
        s_valid[tid] = valid;
        s_w[0][tid] = rnd<T, ROUND>(wy0);
        s_w[1][tid] = rnd<T, ROUND>(wy1);
        s_w[2][tid] = rnd<T, ROUND>(wx0);
        s_w[3][tid] = rnd<T, ROUND>(wx1);
      }
      __syncthreads();

      const long long wrow = (long long)(gi * T_ + t) * cg;
      for (int c0 = 0; c0 < cg; c0 += BK) {
        const int c = c0 + s_c;
        const long long coff = (long long)gi * cg + c;
#pragma unroll 4
        for (int r = 0; r < BM / 8; ++r) {
          const int p = s_p0 + 8 * r;
          const int valid = s_valid[p];
          float v = 0.f;
          if (valid && c < cg) {
            const long long o00 = (long long)s_pix[p] * C + coff;
            const long long orow = (long long)W * C;
            const float v00 = (valid & 1) ? to_f32(x[o00]) : 0.f;
            const float v01 = (valid & 2) ? to_f32(x[o00 + C]) : 0.f;
            const float v10 = (valid & 4) ? to_f32(x[o00 + orow]) : 0.f;
            const float v11 = (valid & 8) ? to_f32(x[o00 + orow + C]) : 0.f;
            const float wy0 = s_w[0][p], wy1 = s_w[1][p];
            const float wx0 = s_w[2][p], wx1 = s_w[3][p];
            if constexpr (ROUND) {
              const float r0 = rnd<T, ROUND>(
                  __fadd_rn(rnd<T, ROUND>(__fmul_rn(v00, wx0)),
                            rnd<T, ROUND>(__fmul_rn(v01, wx1))));
              const float r1 = rnd<T, ROUND>(
                  __fadd_rn(rnd<T, ROUND>(__fmul_rn(v10, wx0)),
                            rnd<T, ROUND>(__fmul_rn(v11, wx1))));
              v = rnd<T, ROUND>(__fadd_rn(rnd<T, ROUND>(__fmul_rn(r0, wy0)),
                                          rnd<T, ROUND>(__fmul_rn(r1, wy1))));
            } else {
              v = (v00 * wx0 + v01 * wx1) * wy0 + (v10 * wx0 + v11 * wx1) * wy1;
            }
          }
          As[s_c][p] = v;
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
          const int kk = e / BN, jj = e - (e / BN) * BN;
          const int ck = c0 + kk, co = n0 + jj;
          Bs[kk][jj] = (ck < cg && co < Cout)
                           ? rnd<T, ROUND>(w2[(wrow + ck) * Cout + co])
                           : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tm * TM]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&As[kk][tm * TM + 4]);
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tn * TN]);
          const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + tm * TM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tn * TN + j;
      if (co < Cout) out[m * Cout + co] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, bool ROUND>
int launch(const void* x, const float* offsets, const float* w2, void* out,
           int n, int H, int W, int C, int Cout, int g, int k, int pad,
           int dil, int window, void* stream) {
  if (H != W || g <= 0 || C % g) return (int)cudaErrorInvalidValue;
  const long long M = (long long)n * H * W;
  if (M == 0 || Cout == 0) return 0;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((Cout + BN - 1) / BN));
  deform_conv_fused_kernel<T, ROUND><<<grid, THREADS, 0,
                                       (cudaStream_t)stream>>>(
      static_cast<const T*>(x), offsets, w2, static_cast<T*>(out), n, H, C,
      Cout, g, k, pad, dil, (float)window);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 input: one function for both rules (deform_conv2d_windowed_fused and
// deform_conv2d_frame)
extern "C" int deform_conv_fused_f32(
    const void* x, const float* offsets, const float* w2, void* out, int n,
    int H, int W, int C, int Cout, int g, int k, int pad, int dil, int window,
    void* stream) {
  return launch<float, false>(x, offsets, w2, out, n, H, W, C, Cout, g, k,
                              pad, dil, window, stream);
}

// bf16 input, the plane kernel's rule: fp32 throughout, bf16 result
extern "C" int deform_conv_fused_bf16(
    const void* x, const float* offsets, const float* w2, void* out, int n,
    int H, int W, int C, int Cout, int g, int k, int pad, int dil, int window,
    void* stream) {
  return launch<__nv_bfloat16, false>(x, offsets, w2, out, n, H, W, C, Cout,
                                      g, k, pad, dil, window, stream);
}

// bf16 input, the frame kernel's rule: rounded to bf16 at every sampling step
extern "C" int deform_conv_fused_bf16_round(
    const void* x, const float* offsets, const float* w2, void* out, int n,
    int H, int W, int C, int Cout, int g, int k, int pad, int dil, int window,
    void* stream) {
  return launch<__nv_bfloat16, true>(x, offsets, w2, out, n, H, W, C, Cout,
                                     g, k, pad, dil, window, stream);
}
