// K5: deform_conv_fused -- the whole bounded-window DCNv1 forward in one
// launch: bilinear window sampling and the per-tap (channel) -> C_out
// contraction, accumulated in fp32.
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
// Rounding rules:
//   the plane rule (_dcn_win_kernel, :71/:76/:150): the sample and the
//     product in fp32 whatever the input type, one cast of the result to T;
//   the frame rule (_dcn_frame_kernel, :189-207): the tent weights, each
//     window product, each row sum, each row times its y weight, the per-tap
//     sample and the weight are rounded to T; the product sums in fp32.
// For T = float the two rules are one function and one instance.
//
// Layouts: x (n, S, S, C) NHWC; offsets (n, S, S, g*T*2) fp32, channel order
// (g, kh, kw, [dy, dx]); w (g*T*cg_pad, c_out_pad), rows in the column
// tensor's (group, tap, channel) order with each (group, tap) padded with
// zero rows to cg_pad (a multiple of the chunk depth BK) and the columns to
// the tiles' width, fp32 for the FMA kernel and bf16 (the frame rule's
// rounded weight) for the tensor-core one; out (n, S, S, C_out) NHWC in T.
// The wrapper (ops/deform_conv_fused.py, k5_launch_config) chooses the tile,
// the vector width, the grid and the shared-memory bytes; the C functions
// check them against their own and refuse what they cannot run.
//
// The work is an implicit GEMM: M = n*S^2 output pixels, N = C_out,
// K = (group, tap, channel) = 9*C. At the SFM stages (14^2 x 256, 28^2 x 128,
// 56^2 x 64, g = 2) and n = 100 each is 23.1 GFLOP of contraction beside
// 45-181 M sampled column elements, each a blend of four corner reads.
//
// Both kernels are warp-specialised: sampler warps fill a ring of STAGES
// shared-memory stages, each one (group, tap, channel-chunk) of K, with the
// chunk's blended samples and (by cp.async) its weight rows; compute warps
// drain them. Named barriers hand the stages over: FULL (samplers arrive,
// compute warps sync) and EMPTY (the reverse); a bar.arrive synchronises
// with the bar.sync it completes, which orders the sampler's shared stores
// (and its finished copies) before the compute warps' reads. A sampler
// lane computes its pixels' geometry once a (group, tap), the next (group,
// tap)'s offsets a whole (group, tap) ahead, and the taps are walked with
// counters, not divisions. A chunk's tail past the group's channels (cg
// not a multiple of the chunk) is zero-filled, as are the weight matrix's
// padded rows; ragged pixels and output channels are masked.
//
// k5_mma_kernel -- the frame rule on a bf16 x. Both factors of the product
//   are bf16 and the sum fp32: a bf16 tensor-core product
//   (mma.sync.m16n8k16, ldmatrix from XOR-swizzled stages, conflict-free).
//   At 989 TFLOP/s the contraction is 0.023 ms a stage, so the sampler sets
//   the pace. 8 sampler warps (two a sub-partition) and 8 MMA warps of 32 x
//   WN outputs; 128 x 128 or 128 x 64 outputs a block, 64 x 256 where
//   C_out > 128 (each pixel sampled once, not once an output tile), 32
//   channels a chunk. Chunk i + 1's corner loads (16 bytes, 8 channels a
//   lane; a corner off the plane reads a zero row, no branch) go out before
//   chunk i's blends, and each lane's pixels take their geometry by
//   shuffle from the lanes that computed it. The blend is packed bf16
//   arithmetic, __hmul2_rn and __hadd2_rn: the product of two bf16 values
//   is exact in fp32 and a sum is exact or too lopsided to round otherwise,
//   so one rounding a step gives the plain version's fp32-then-round steps
//   bit for bit, and the _rn forms keep the compiler from contracting a
//   product and a sum into one rounding. Where cg is not a multiple of 8
//   (or x is not 16-byte aligned) the loads go one channel at a time.
//
// k5_fma_kernel -- the fp32 rule (fp32 x, and the plane rule on a bf16 x):
//   fp32 FMAs on the CUDA cores (TF32 stays off: the port is held to fp32),
//   which set the pace at 2*C_out flops a sample. 4 sampler warps and 4 FMA
//   warps of 8 x 16 outputs a thread, 128 x 128 outputs a block over
//   32-channel chunks, 256 x 64 over 16 where C_out <= 64. On Hopper the
//   shared loads feed a lane 4 bytes a clock against an FMA a clock, so an
//   8 x 8 block (16 floats for 64 FMAs) would keep them as busy as the
//   FMAs; 8 x 16 loads 24 floats for 128. The k loop is unrolled 4 deep:
//   fully unrolled, its ~70 KB of code outgrows the instruction cache and
//   stalls the FMA warps. The sampler's next half-chunk of corner loads (4
//   channels a lane, 16 bytes in fp32) goes out before the current half is
//   blended.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// ------------------------------------------------------------- geometry --

struct Geo {
  int pix;      // pixel index of corner (y0, x0)
  int valid;    // bits: (y0,x0) (y0,x0+1) (y0+1,x0) (y0+1,x0+1)
  float wy0, wy1, wx0, wx1;
};

// an output pixel m = (img, yy, xx) whose samples a lane computes; not live
// past the end
struct Pixel {
  int m, img, yy, xx;
  bool live;
};

__device__ __forceinline__ Pixel pixel_at(int m, int M, int S) {
  Pixel p = {m, 0, 0, 0, m < M};
  if (p.live) {
    const int plane = S * S;
    p.img = m / plane;
    const int rem = m - p.img * plane;
    p.yy = rem / S;
    p.xx = rem - p.yy * S;
  }
  return p;
}

// the offsets (dy, dx) of (group, tap) gt from pixel p's row of them
__device__ __forceinline__ float2 offsets_of(const float* __restrict__ orow,
                                             const Pixel& p, int gt) {
  if (!p.live) return make_float2(0.f, 0.f);
  return make_float2(__ldg(orow + 2 * gt), __ldg(orow + 2 * gt + 1));
}

// K1's coordinate arithmetic, unfused, for pixel p, tap (i, j) and its
// offsets o; all zero for a sample outside or a pixel past the end
__device__ __forceinline__ Geo geometry(const Pixel& p, float2 o, int S,
                                        int i, int j, int pad, int dil,
                                        float window) {
  Geo r = {0, 0, 0.f, 0.f, 0.f, 0.f};
  if (!p.live) return r;
  float rel_y = (float)(i * dil - pad) + o.x;
  float rel_x = (float)(j * dil - pad) + o.y;
  const float py = (float)p.yy + rel_y;
  const float px = (float)p.xx + rel_x;
  if (!(py > -1.f && py < (float)S && px > -1.f && px < (float)S)) return r;
  rel_y = fminf(fmaxf(rel_y, -window), window);
  rel_x = fminf(fmaxf(rel_x, -window), window);
  const float fy = floorf(rel_y);
  const float fx = floorf(rel_x);
  r.wy0 = 1.f - (rel_y - fy);
  r.wy1 = 1.f - ((fy + 1.f) - rel_y);
  r.wx0 = 1.f - (rel_x - fx);
  r.wx1 = 1.f - ((fx + 1.f) - rel_x);
  const int y0 = p.yy + (int)fy, x0 = p.xx + (int)fx;
  const bool ry0 = y0 >= 0 && y0 < S, ry1 = y0 + 1 >= 0 && y0 + 1 < S;
  const bool rx0 = x0 >= 0 && x0 < S, rx1 = x0 + 1 >= 0 && x0 + 1 < S;
  r.valid = (ry0 && rx0) | ((ry0 && rx1) << 1) | ((ry1 && rx0) << 2) |
            ((ry1 && rx1) << 3);
  r.pix = (p.img * S + y0) * S + x0;
  return r;
}

// the walk over K in chunks: (group, tap (i, j)) and the chunk's first
// channel c0, advanced without divisions
struct Walk {
  int gi, i, j, c0;
  __device__ __forceinline__ void next(int k, int cgp, int bk) {
    c0 += bk;
    if (c0 < cgp) return;
    c0 = 0;
    if (++j < k) return;
    j = 0;
    if (++i < k) return;
    i = 0;
    ++gi;
  }
  // the (group, tap) index gi*k*k + i*k + j
  __device__ __forceinline__ int gt(int k) const {
    return (gi * k + i) * k + j;
  }
};

// ----------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t b2_bits(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ bf162 bits_b2(uint32_t u) {
  return *reinterpret_cast<bf162*>(&u);
}

// both kernels: a ring of STAGES shared-memory stages handed from the
// sampler warps to the compute warps by named barriers
constexpr int STAGES = 4;
constexpr int FULL_BAR = 1;              // named barriers 1..4: stage landed
constexpr int EMPTY_BAR = 1 + STAGES;    // 5..8: stage consumed

// ------------------------------------------- the frame rule, tensor cores --

constexpr int MMA_BK = 32;            // channels per chunk (two k16 steps)
constexpr int SAMPLER_WARPS = 8;      // two on each SM sub-partition
constexpr int MMA_WARPS = 8;          // 32-pixel x WN-channel tiles
constexpr int SAMPLER_THREADS = 32 * SAMPLER_WARPS;
constexpr int MMA_THREADS = 32 * (SAMPLER_WARPS + MMA_WARPS);   // 512
constexpr int A_ROW_BYTES = MMA_BK * 2;                         // 64

// BM pixels x BN output channels a CTA: 128 x 128 or 128 x 64, or 64 x 256
// where C_out > 128, so that no pixel is sampled twice there
template <int BM, int BN> struct MmaTile {
  static constexpr int PIX = BM / SAMPLER_WARPS;  // pixels a sampler warp
  static constexpr int ROWS = PIX / 8;            // a sampler lane's pixels
  static constexpr int WM = BM / 32;              // MMA warps along pixels
  static constexpr int WN = BN / (MMA_WARPS / WM);  // a warp's channels
  static constexpr int NT = WN / 8;               // its n8 tiles
  static constexpr int A_STAGE_BYTES = BM * A_ROW_BYTES;
  static constexpr int B_ROW_BYTES = BN * 2;
  static constexpr int B_STAGE_BYTES = MMA_BK * B_ROW_BYTES;
  static constexpr int STAGE_BYTES = A_STAGE_BYTES + B_STAGE_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(ROWS >= 1 && NT % 2 == 0 && NT * 8 * MMA_WARPS / WM == BN,
                "the tile's warp grids");
};

// 8 bf16 channels from p: one 16-byte load, or one at a time where the
// group's channels do not come in 16-byte runs (nvalid left in the group)
template <bool VEC>
__device__ __forceinline__ uint4 load8(const bf16* p, int nvalid) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < nvalid ? __ldg(q + e) : 0u;
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                    h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

// the frame rule on a pair of channels: each product and each sum rounded
__device__ __forceinline__ uint32_t blend2(uint32_t v00, uint32_t v01,
                                           uint32_t v10, uint32_t v11,
                                           bf162 wx0, bf162 wx1, bf162 wy0,
                                           bf162 wy1) {
  const bf162 r0 = __hadd2_rn(__hmul2_rn(bits_b2(v00), wx0),
                              __hmul2_rn(bits_b2(v01), wx1));
  const bf162 r1 = __hadd2_rn(__hmul2_rn(bits_b2(v10), wx0),
                              __hmul2_rn(bits_b2(v11), wx1));
  return b2_bits(__hadd2_rn(__hmul2_rn(r0, wy0), __hmul2_rn(r1, wy1)));
}

// what a corner off the plane reads
__device__ const uint4 kZeroRow = {0u, 0u, 0u, 0u};

// one chunk's corner rows of a sampler lane (8 channels of ROWS pixels),
// with each pixel's packed bf16 tent weights (x0, x1), (y0, y1)
template <int ROWS> struct Corners {
  uint4 v[ROWS][4];
  uint32_t wx[ROWS], wy[ROWS];
};

// the loads of a chunk: pixel (lane >> 2) + 8r of the warp takes its
// geometry from the lane that computed it, channels c.. of group offset goff
template <bool VEC, int ROWS>
__device__ __forceinline__ void gather(Corners<ROWS>& L, const Geo& G,
                                       uint32_t gwx, uint32_t gwy, int lane,
                                       const bf16* __restrict__ x, int C,
                                       int cg, int goff, int c,
                                       long long row_step) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int src = (lane >> 2) + 8 * r;
    const int pix = __shfl_sync(0xffffffffu, G.pix, src);
    const int val = __shfl_sync(0xffffffffu, G.valid, src);
    L.wx[r] = __shfl_sync(0xffffffffu, gwx, src);
    L.wy[r] = __shfl_sync(0xffffffffu, gwy, src);
    const bf16* base = x + (long long)pix * C + goff + c;
    if (VEC) {
      // branch-free: a corner off the plane, or past the group's channels,
      // reads the zero row
      const int live = c < cg ? val : 0;
      const uint4* z = &kZeroRow;
      L.v[r][0] = __ldg(live & 1 ? reinterpret_cast<const uint4*>(base) : z);
      L.v[r][1] =
          __ldg(live & 2 ? reinterpret_cast<const uint4*>(base + C) : z);
      L.v[r][2] = __ldg(
          live & 4 ? reinterpret_cast<const uint4*>(base + row_step) : z);
      L.v[r][3] = __ldg(live & 8 ? reinterpret_cast<const uint4*>(
                                       base + row_step + C)
                                 : z);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) L.v[r][e] = make_uint4(0, 0, 0, 0);
    if (val && c < cg) {
      const int nv = cg - c;
      if (val & 1) L.v[r][0] = load8<false>(base, nv);
      if (val & 2) L.v[r][1] = load8<false>(base + C, nv);
      if (val & 4) L.v[r][2] = load8<false>(base + row_step, nv);
      if (val & 8) L.v[r][3] = load8<false>(base + row_step + C, nv);
    }
  }
}

// the blends of a chunk into its stage, rows p0 + 8r, 16-byte chunk q,
// swizzled so that ldmatrix's eight rows fall on eight bank groups
template <int ROWS>
__device__ __forceinline__ void place(const Corners<ROWS>& L,
                                      unsigned char* a_s, int p0, int q) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bf162 wxp = bits_b2(L.wx[r]), wyp = bits_b2(L.wy[r]);
    const bf162 wx0 = __low2bfloat162(wxp), wx1 = __high2bfloat162(wxp);
    const bf162 wy0 = __low2bfloat162(wyp), wy1 = __high2bfloat162(wyp);
    uint4 o;
    o.x = blend2(L.v[r][0].x, L.v[r][1].x, L.v[r][2].x, L.v[r][3].x, wx0,
                 wx1, wy0, wy1);
    o.y = blend2(L.v[r][0].y, L.v[r][1].y, L.v[r][2].y, L.v[r][3].y, wx0,
                 wx1, wy0, wy1);
    o.z = blend2(L.v[r][0].z, L.v[r][1].z, L.v[r][2].z, L.v[r][3].z, wx0,
                 wx1, wy0, wy1);
    o.w = blend2(L.v[r][0].w, L.v[r][1].w, L.v[r][2].w, L.v[r][3].w, wx0,
                 wx1, wy0, wy1);
    const int p = p0 + 8 * r;
    *reinterpret_cast<uint4*>(a_s + p * A_ROW_BYTES +
                              ((q ^ ((p >> 1) & 3)) << 4)) = o;
  }
}

// a chunk's MMA_BK x BN weight rows by cp.async, 16 bytes a copy, swizzled
// by row so that ldmatrix.trans's eight rows fall on eight bank groups
template <int BN>
__device__ __forceinline__ void copy_weights(uint32_t b_s,
                                             const bf16* __restrict__ src,
                                             int Cp, int t) {
#pragma unroll
  for (int u = 0; u < MMA_BK * BN / 8 / SAMPLER_THREADS; ++u) {
    const int e = t + u * SAMPLER_THREADS;
    const int kk = e / (BN / 8), nc = e - kk * (BN / 8);
    cp_async16(b_s + kk * (BN * 2) + ((nc ^ (kk & 7)) << 4),
               src + (long long)kk * Cp + nc * 8);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return b2_bits(__floats2bfloat162_rn(lo, hi));
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, 1) k5_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ off,
    const bf16* __restrict__ w, bf16* __restrict__ out, int M, int S, int C,
    int Cout, int g, int k, int pad, int dil, float window) {
  typedef MmaTile<BM, BN> Tl;
  constexpr int PIX = Tl::PIX;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int cg = C / g, gT = g * k * k;
  const int cgp = (cg + MMA_BK - 1) / MMA_BK * MMA_BK;
  const int nchunks = gT * (cgp / MMA_BK);
  const int Cp = gridDim.y * BN;           // w's padded row length
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < SAMPLER_WARPS) {
    // ---- sampler. A lane computes the geometry of pixel lane % PIX of
    // its warp's PIX (the other lanes repeat the first PIX) and blends 8
    // channels of pixels (lane >> 2) + 8r. Chunk i + 1's corner loads go
    // out before chunk i's blends; the next (group, tap)'s offsets a whole
    // (group, tap) ahead.
    const Pixel P = pixel_at(m0 + warp * PIX + (lane % PIX), M, S);
    const int q = lane & 3;
    const int p0 = warp * PIX + (lane >> 2);
    const long long row_step = (long long)S * C;
    const float* orow = off + (long long)P.m * (2 * gT);
    Walk at = {0, 0, 0, 0};               // chunk i + 1 once step i begins
    Geo G = geometry(P, offsets_of(orow, P, 0), S, 0, 0, pad, dil, window);
    float2 on = gT > 1 ? offsets_of(orow, P, 1) : make_float2(0.f, 0.f);
    uint32_t gwx = pack_bf16(G.wx0, G.wx1), gwy = pack_bf16(G.wy0, G.wy1);
    Corners<Tl::ROWS> L0, L1;
    copy_weights<BN>(sbase + Tl::A_STAGE_BYTES, w + n0, Cp, threadIdx.x);
    cp_async_commit();
    gather<VEC>(L0, G, gwx, gwy, lane, x, C, cg, 0, 8 * q, row_step);

    auto step = [&](int i, const Corners<Tl::ROWS>& cur,
                    Corners<Tl::ROWS>& nxt) {
      const int s = i % STAGES;
      at.next(k, cgp, MMA_BK);
      if (i + 1 < nchunks) {
        const int gt1 = at.gt(k);
        if (at.c0 == 0) {                 // a new (group, tap)
          G = geometry(P, on, S, at.i, at.j, pad, dil, window);
          gwx = pack_bf16(G.wx0, G.wx1);
          gwy = pack_bf16(G.wy0, G.wy1);
          if (gt1 + 1 < gT) on = offsets_of(orow, P, gt1 + 1);
        }
        const int s1 = (i + 1) % STAGES;
        if (i + 1 >= STAGES) bar_sync(EMPTY_BAR + s1, MMA_THREADS);
        copy_weights<BN>(sbase + s1 * Tl::STAGE_BYTES + Tl::A_STAGE_BYTES,
                         w + (long long)(gt1 * cgp + at.c0) * Cp + n0, Cp,
                         threadIdx.x);
        gather<VEC>(nxt, G, gwx, gwy, lane, x, C, cg, at.gi * cg,
                    at.c0 + 8 * q, row_step);
      }
      cp_async_commit();                  // (empty after the last chunk)
      place(cur, smem + s * Tl::STAGE_BYTES, p0, q);
      cp_async_wait<1>();                 // chunk i's weights have landed
      bar_arrive(FULL_BAR + s, MMA_THREADS);
    };
    for (int i = 0; i < nchunks; i += 2) {
      step(i, L0, L1);
      if (i + 1 < nchunks) step(i + 1, L1, L0);
    }
    return;
  }

  // ---- MMA warps: a 32 x WN tile each
  const int cw = warp - SAMPLER_WARPS;
  const int wm = cw % Tl::WM, wn = cw / Tl::WM;
  float acc[2][Tl::NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < Tl::NT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  for (int i = 0; i < nchunks; ++i) {
    const int s = i % STAGES;
    bar_sync(FULL_BAR + s, MMA_THREADS);
    const uint32_t a_s = sbase + s * Tl::STAGE_BYTES;
    const uint32_t b_s = a_s + Tl::A_STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < MMA_BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + (lane & 15);
        const int kc = ks * 2 + (lane >> 4);
        ldsm_x4(a[mt],
                a_s + row * A_ROW_BYTES + ((kc ^ ((row >> 1) & 3)) << 4));
      }
      uint32_t b[Tl::NT][2];
#pragma unroll
      for (int nb = 0; nb < Tl::NT / 2; ++nb) {
        const int kr = ks * 16 + (lane & 15);
        const int nc = (wn * Tl::WN + nb * 16) / 8 + (lane >> 4);
        uint32_t r[4];
        ldsm_x4_t(r, b_s + kr * Tl::B_ROW_BYTES + ((nc ^ (kr & 7)) << 4));
        b[2 * nb][0] = r[0];
        b[2 * nb][1] = r[1];
        b[2 * nb + 1][0] = r[2];
        b[2 * nb + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < Tl::NT; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    if (i + STAGES < nchunks) bar_arrive(EMPTY_BAR + s, MMA_THREADS);
  }

  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + (lane >> 2) + 8 * h;
      if (m >= M) continue;
      bf16* orow = out + (long long)m * Cout;
#pragma unroll
      for (int nt = 0; nt < Tl::NT; ++nt) {
        const int co = n0 + wn * Tl::WN + nt * 8 + (lane & 3) * 2;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pairs && co + 1 < Cout) {
          *reinterpret_cast<bf162*>(orow + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < Cout) orow[co] = __float2bfloat16_rn(v0);
          if (co + 1 < Cout) orow[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ------------------------------------------------ the fp32 rule, FMAs --

constexpr int FMA_SAMPLER_WARPS = 4;
constexpr int FMA_WARPS = 4;          // 128 threads of 8 x 16 outputs
constexpr int FMA_SAMPLERS = 32 * FMA_SAMPLER_WARPS;
constexpr int FMA_THREADS = 32 * (FMA_SAMPLER_WARPS + FMA_WARPS);   // 256
constexpr int FMA_APAD = 4;           // sample rows 16 mod 32 words apart

// BM x BN tile over BK-channel chunks; 4096 samples a chunk either way. A
// compute thread (tm, tn) of the 16 x 8 grid adds rows tm*4 + 64a + 0..3
// (a < RM) and columns tn*4 + 32b + 0..3 (b < RN): 24 floats from shared
// memory a k step for 128 FMAs, which keeps the FMAs, not the shared
// loads (4 bytes a lane a clock), the pace
template <int BM> struct FmaTile {
  static constexpr int BN = 16384 / BM;           // 128 or 64
  static constexpr int BK = 4096 / BM;            // 32 or 16
  static constexpr int RM = BM / 64;              // row groups: 2 or 4
  static constexpr int RN = BN / 32;              // column groups: 4 or 2
  static constexpr int AST = BM + FMA_APAD;       // sample row stride
  static constexpr int NP = BM / 64;              // pixels a sampler lane
  static constexpr int SPP = BK / 8;              // its steps a pixel
  static constexpr int A_FLOATS = BK * AST;
  static constexpr int B_FLOATS = BK * BN;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * 4;
};
static_assert(FmaTile<128>::NP * FmaTile<128>::SPP == 8 &&
                  FmaTile<256>::NP * FmaTile<256>::SPP == 8,
              "a sampler lane's 8 steps of 4 channels");
static_assert(FmaTile<128>::RM * FmaTile<128>::RN == 8 &&
                  FmaTile<256>::RM * FmaTile<256>::RN == 8,
              "8 x 16 outputs a compute thread");

template <typename T> struct Raw;
template <> struct Raw<float> { typedef float4 type; };   // 4 fp32
template <> struct Raw<bf16> { typedef uint2 type; };     // 4 bf16

template <typename T> __device__ __forceinline__ typename Raw<T>::type
raw_zero();
template <> __device__ __forceinline__ float4 raw_zero<float>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ uint2 raw_zero<bf16>() {
  return make_uint2(0u, 0u);
}

// 4 channels from p: one vector load, or one at a time (nvalid left)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int nvalid) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), nvalid > 1 ? __ldg(p + 1) : 0.f,
                     nvalid > 2 ? __ldg(p + 2) : 0.f,
                     nvalid > 3 ? __ldg(p + 3) : 0.f);
}
template <bool VEC>
__device__ __forceinline__ uint2 load4(const bf16* p, int nvalid) {
  if (VEC) return __ldg(reinterpret_cast<const uint2*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  const uint32_t h0 = __ldg(q), h1 = nvalid > 1 ? __ldg(q + 1) : 0u;
  const uint32_t h2 = nvalid > 2 ? __ldg(q + 2) : 0u;
  const uint32_t h3 = nvalid > 3 ? __ldg(q + 3) : 0u;
  return make_uint2(h0 | (h1 << 16), h2 | (h3 << 16));
}

__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float blend1(float v00, float v01, float v10,
                                        float v11, const Geo& G) {
  return (v00 * G.wx0 + v01 * G.wx1) * G.wy0 +
         (v10 * G.wx0 + v11 * G.wx1) * G.wy1;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(FMA_THREADS, 1) k5_fma_kernel(
    const T* __restrict__ x, const float* __restrict__ off,
    const float* __restrict__ w, T* __restrict__ out, int M, int S, int C,
    int Cout, int g, int k, int pad, int dil, float window) {
  typedef FmaTile<BM> Tl;
  typedef typename Raw<T>::type R;
  constexpr int BN = Tl::BN, BK = Tl::BK, AST = Tl::AST, NP = Tl::NP;
  constexpr int SPP = Tl::SPP, RM = Tl::RM, RN = Tl::RN;
  extern __shared__ __align__(128) float fsmem[];   // [STAGES][A | B]
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int cg = C / g, gT = g * k * k;
  const int cgp = (cg + BK - 1) / BK * BK;
  const int nchunks = gT * (cgp / BK);
  const int Cp = gridDim.y * BN;

  if (threadIdx.x < FMA_SAMPLERS) {
    // ---- sampler: two lanes a pixel, 4 channels each; the lane's NP
    // pixels plo + 64j, its step e (of 8) pixel e / SPP at channels
    // 8 * (e % SPP) + sub of the chunk. The loads of the next half-chunk
    // (4 steps) go out before the current one is blended; the next (group,
    // tap)'s offsets a whole (group, tap) ahead.
    const int t = threadIdx.x, plo = t >> 1, sub = 4 * (t & 1);
    const long long row_step = (long long)S * C;
    Pixel P[NP];
    Geo G[NP];
    float2 on[NP];
    const float* orow[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      P[j] = pixel_at(m0 + plo + 64 * j, M, S);
      orow[j] = off + (long long)P[j].m * (2 * gT);
      G[j] = geometry(P[j], offsets_of(orow[j], P[j], 0), S, 0, 0, pad, dil,
                      window);
      on[j] = gT > 1 ? offsets_of(orow[j], P[j], 1) : make_float2(0.f, 0.f);
    }
    // half H (0 or 1) of a chunk at channel c0 of group offset goff: its
    // steps' corner rows and the geometry of their pixels
    constexpr int NPH = NP / 2;
    struct Half {
      R raw[4][4];
      Geo g[NPH];
    };
    auto gather = [&](Half& L, auto half, int c0, int goff) {
      constexpr int H = decltype(half)::value;
#pragma unroll
      for (int j = 0; j < NPH; ++j) L.g[j] = G[H * NPH + j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = 4 * H + jj;
        const Geo& Gp = G[e / SPP];
        const int c = c0 + 8 * (e % SPP) + sub;
#pragma unroll
        for (int v = 0; v < 4; ++v) L.raw[jj][v] = raw_zero<T>();
        if (Gp.valid && c < cg) {
          const T* base = x + (long long)Gp.pix * C + goff + c;
          const int nv = cg - c;
          if (Gp.valid & 1) L.raw[jj][0] = load4<VEC>(base, nv);
          if (Gp.valid & 2) L.raw[jj][1] = load4<VEC>(base + C, nv);
          if (Gp.valid & 4) L.raw[jj][2] = load4<VEC>(base + row_step, nv);
          if (Gp.valid & 8)
            L.raw[jj][3] = load4<VEC>(base + row_step + C, nv);
        }
      }
    };
    auto place = [&](const Half& L, auto half, float* As) {
      constexpr int H = decltype(half)::value;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = 4 * H + jj;
        const Geo& Gp = L.g[e / SPP - H * NPH];
        const int p = plo + 64 * (e / SPP);
        const int cl = 8 * (e % SPP) + sub;
        const float4 a = widen(L.raw[jj][0]), b = widen(L.raw[jj][1]);
        const float4 c = widen(L.raw[jj][2]), d = widen(L.raw[jj][3]);
        As[(cl + 0) * AST + p] = blend1(a.x, b.x, c.x, d.x, Gp);
        As[(cl + 1) * AST + p] = blend1(a.y, b.y, c.y, d.y, Gp);
        As[(cl + 2) * AST + p] = blend1(a.z, b.z, c.z, d.z, Gp);
        As[(cl + 3) * AST + p] = blend1(a.w, b.w, c.w, d.w, Gp);
      }
    };
    typedef std::integral_constant<int, 0> First;
    typedef std::integral_constant<int, 1> Second;
    Half L0, L1;                          // a chunk's first and second half
    Walk at = {0, 0, 0, 0};
    gather(L0, First(), 0, 0);
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % STAGES;
      const int c0 = at.c0, goff = at.gi * cg;
      gather(L1, Second(), c0, goff);
      if (i >= STAGES) bar_sync(EMPTY_BAR + s, FMA_THREADS);
      float* As = fsmem + s * Tl::STAGE_FLOATS;   // [BK][AST], channel-major
      float* Bs = As + Tl::A_FLOATS;              // [BK][BN]
      const float* wsrc = w + (long long)(at.gt(k) * cgp + c0) * Cp + n0;
#pragma unroll
      for (int e = t; e < BK * BN / 4; e += FMA_SAMPLERS) {
        const int kk = e / (BN / 4), cc = (e - kk * (BN / 4)) * 4;
        cp_async16(smem_u32(Bs + kk * BN + cc),
                   wsrc + (long long)kk * Cp + cc);
      }
      cp_async_commit();
      place(L0, First(), As);
      at.next(k, cgp, BK);                // chunk i + 1
      if (i + 1 < nchunks) {
        if (at.c0 == 0) {                 // a new (group, tap)
          const int gt = at.gt(k);
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            G[j] = geometry(P[j], on[j], S, at.i, at.j, pad, dil, window);
            if (gt + 1 < gT) on[j] = offsets_of(orow[j], P[j], gt + 1);
          }
        }
        gather(L0, First(), at.c0, at.gi * cg);
      }
      place(L1, Second(), As);
      cp_async_wait<0>();
      bar_arrive(FULL_BAR + s, FMA_THREADS);
    }
    return;
  }

  // ---- FMA warps
  const int ct = threadIdx.x - FMA_SAMPLERS;
  const int tn = ct & 7, tm = ct >> 3;
  float acc[4 * RM][4 * RN];
#pragma unroll
  for (int a = 0; a < 4 * RM; ++a)
#pragma unroll
    for (int b = 0; b < 4 * RN; ++b) acc[a][b] = 0.f;

  for (int i = 0; i < nchunks; ++i) {
    const int s = i % STAGES;
    bar_sync(FULL_BAR + s, FMA_THREADS);
    const float* A = fsmem + s * Tl::STAGE_FLOATS;
    const float* B = A + Tl::A_FLOATS;
    // unrolled 4 deep, not BK: the fully unrolled loop's ~70 KB of code
    // outgrows the instruction cache and stalls the FMA warps
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[4 * RM], bv[4 * RN];
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const float4 v =
            *reinterpret_cast<const float4*>(A + kk * AST + 64 * a + tm * 4);
        av[4 * a] = v.x;
        av[4 * a + 1] = v.y;
        av[4 * a + 2] = v.z;
        av[4 * a + 3] = v.w;
      }
#pragma unroll
      for (int b = 0; b < RN; ++b) {
        const float4 v =
            *reinterpret_cast<const float4*>(B + kk * BN + 32 * b + tn * 4);
        bv[4 * b] = v.x;
        bv[4 * b + 1] = v.y;
        bv[4 * b + 2] = v.z;
        bv[4 * b + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < 4 * RM; ++a)
#pragma unroll
        for (int b = 0; b < 4 * RN; ++b)
          acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (i + STAGES < nchunks) bar_arrive(EMPTY_BAR + s, FMA_THREADS);
  }

#pragma unroll
  for (int a = 0; a < 4 * RM; ++a) {
    const int m = m0 + 64 * (a >> 2) + tm * 4 + (a & 3);
    if (m >= M) continue;
    T* orow = out + (long long)m * Cout;
#pragma unroll
    for (int b = 0; b < 4 * RN; ++b) {
      const int co = n0 + 32 * (b >> 2) + tn * 4 + (b & 3);
      if (co < Cout) orow[co] = from_f32<T>(acc[a][b]);
    }
  }
}

// ------------------------------------------------------------- launch --

struct Args {
  const void* x;
  const float* off;
  const void* w;
  void* out;
  int n, H, W, C, Cout, g, k, pad, dil, window;
  int tile, vec, grid_x, grid_y, smem;
  void* stream;
};

// above 48 KB a block's dynamic shared memory needs the kernel's consent
template <typename K>
cudaError_t set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the contract and the wrapper's launch configuration against the kernel's
// own: tiles bm x bn, shared-memory bytes
int check(const Args& a, int bm, int bn, int smem) {
  if (a.H != a.W || a.g <= 0 || a.C % a.g || a.k <= 0) return 1;
  const long long M = (long long)a.n * a.H * a.W;
  if (M >= (1LL << 31)) return 1;
  if (a.smem != smem || smem > 232448) return 1;
  if ((long long)a.grid_x * bm < M || (long long)(a.grid_x - 1) * bm >= M)
    return 1;
  if ((long long)a.grid_y * bn < a.Cout ||
      (long long)(a.grid_y - 1) * bn >= a.Cout)
    return 1;
  return 0;
}

template <int BM, int BN, bool VEC>
int run_mma(const Args& a) {
  if (check(a, BM, BN, MmaTile<BM, BN>::SMEM))
    return (int)cudaErrorInvalidValue;
  auto kernel = k5_mma_kernel<BM, BN, VEC>;
  const cudaError_t e = set_smem(kernel, a.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)a.grid_x, (unsigned)a.grid_y), MMA_THREADS, a.smem,
           (cudaStream_t)a.stream>>>(
      static_cast<const bf16*>(a.x), a.off, static_cast<const bf16*>(a.w),
      static_cast<bf16*>(a.out), a.n * a.H * a.W, a.H, a.C, a.Cout, a.g, a.k,
      a.pad, a.dil, (float)a.window);
  return (int)cudaGetLastError();
}

template <typename T, int BM, bool VEC>
int run_fma(const Args& a) {
  typedef FmaTile<BM> Tl;
  if (check(a, BM, Tl::BN, Tl::SMEM)) return (int)cudaErrorInvalidValue;
  auto kernel = k5_fma_kernel<T, BM, VEC>;
  const cudaError_t e = set_smem(kernel, a.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)a.grid_x, (unsigned)a.grid_y), FMA_THREADS, a.smem,
           (cudaStream_t)a.stream>>>(
      static_cast<const T*>(a.x), a.off, static_cast<const float*>(a.w),
      static_cast<T*>(a.out), a.n * a.H * a.W, a.H, a.C, a.Cout, a.g, a.k,
      a.pad, a.dil, (float)a.window);
  return (int)cudaGetLastError();
}

// tile 0: 128 x 128 over 32-channel chunks, 1: 256 x 64 over 16
template <typename T>
int launch_fma(const Args& a) {
  if (a.n * (long long)a.H * a.W == 0 || a.Cout == 0) return 0;
  if (a.tile == 0) return a.vec ? run_fma<T, 128, true>(a)
                                : run_fma<T, 128, false>(a);
  if (a.tile == 1) return a.vec ? run_fma<T, 256, true>(a)
                                : run_fma<T, 256, false>(a);
  return (int)cudaErrorInvalidValue;
}

// tile 0: 128 pixels x 128 output channels, 1: 128 x 64, 2: 64 x 256
int launch_mma(const Args& a) {
  if (a.n * (long long)a.H * a.W == 0 || a.Cout == 0) return 0;
  if (a.tile == 0) return a.vec ? run_mma<128, 128, true>(a)
                                : run_mma<128, 128, false>(a);
  if (a.tile == 1) return a.vec ? run_mma<128, 64, true>(a)
                                : run_mma<128, 64, false>(a);
  if (a.tile == 2) return a.vec ? run_mma<64, 256, true>(a)
                                : run_mma<64, 256, false>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define K5_ARGS                                                              \
  const void *x, const float *offsets, const void *w, void *out, int n,     \
      int H, int W, int C, int Cout, int g, int k, int pad, int dil,         \
      int window, int tile, int vec, int grid_x, int grid_y, int smem,      \
      void *stream
#define K5_PACK                                                              \
  Args{x, offsets, w, out, n, H, W, C, Cout, g, k, pad, dil, window, tile,  \
       vec, grid_x, grid_y, smem, stream}

// fp32 input: one function for both rules (deform_conv2d_windowed_fused and
// deform_conv2d_frame); fp32 weights
extern "C" int deform_conv_fused_f32(K5_ARGS) {
  return launch_fma<float>(K5_PACK);
}

// bf16 input, the plane kernel's rule: fp32 throughout, bf16 result; fp32
// weights
extern "C" int deform_conv_fused_bf16(K5_ARGS) {
  return launch_fma<bf16>(K5_PACK);
}

// bf16 input, the frame kernel's rule: rounded to bf16 at every sampling
// step, the product on the tensor cores; bf16 (rounded) weights
extern "C" int deform_conv_fused_bf16_round(K5_ARGS) {
  return launch_mma(K5_PACK);
}
