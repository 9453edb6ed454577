// Element access shared by K1-K4 for fp32 and bf16 tensors.
//
// A kernel instance takes its tensors' element type T (float or
// __nv_bfloat16) and VEC, the elements one lane moves at a time: 16 bytes
// (4 fp32 or 8 bf16) where the channel count and the bases allow it, else 1
// (the wrapper's launch configuration decides, ops/deform_conv.py:
// dcn_launch_config and ops/roi_align.py:roi_align_launch_config). Loads
// widen to fp32 registers; all arithmetic is fp32; a bf16 result is rounded
// once, to nearest even, when it is stored. Sums across lanes or blocks go
// into fp32 scratch with fp32 reductions in L2: sm_90 has no vector bf16
// reduction that keeps the sum exact. A kernel whose lanes end in such
// reductions (K3, K4) keeps 4 channels a lane in either type, 8-byte bf16
// loads: its lanes' 16-byte reductions then fill whole 32-byte sectors side
// by side, where 8 channels a lane would make two half-sector reductions
// each and double the sectors L2 must reduce (8 channels a lane ran K3 at
// 2.2x and K4 at 1.2x their fp32 instances' times at the flagship's
// training shapes, chip_smoke.py phase 2 on an H100 80GB HBM3 at 700 W).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace elem {

// the elements of one 16-byte access
template <typename T> struct Wide;
template <> struct Wide<float> { static constexpr int kVec = 4; };
template <> struct Wide<__nv_bfloat16> { static constexpr int kVec = 8; };
// the channels of one lane of a kernel that reduces into fp32: one 16-byte
// fp32 reduction
constexpr int kReduceVec = 4;

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// one element, widened to fp32, or rounded from it
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes as fp32 registers, and back
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    v[0] = bf16_lo(u.x);
    v[1] = bf16_hi(u.x);
    v[2] = bf16_lo(u.y);
    v[3] = bf16_hi(u.y);
    v[4] = bf16_lo(u.z);
    v[5] = bf16_hi(u.z);
    v[6] = bf16_lo(u.w);
    v[7] = bf16_hi(u.w);
  }
}
template <typename T>
__device__ __forceinline__ void unpack(const uint2& u, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
  } else {
    v[0] = bf16_lo(u.x);
    v[1] = bf16_hi(u.x);
    v[2] = bf16_lo(u.y);
    v[3] = bf16_hi(u.y);
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    return make_uint4(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                      bf16_bits(v[2]) | (bf16_bits(v[3]) << 16),
                      bf16_bits(v[4]) | (bf16_bits(v[5]) << 16),
                      bf16_bits(v[6]) | (bf16_bits(v[7]) << 16));
  }
}

// one scalar element through the read-only path, streaming, and stored
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
  return bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float ldcs1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ldcs1(const __nv_bfloat16* p) {
  return bf16_lo(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void stcs1(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void stcs1(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)bf16_bits(v));
}

// VEC elements at p (aligned to their size where VEC > 1: 16 or 8 bytes)
// into v: through the read-only path (ld.global.nc), or streaming
// (ld.global.cs: data read once)
template <typename T, int VEC>
__device__ __forceinline__ void load_ro(const T* p, float (&v)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16 || VEC * sizeof(T) == 8,
                "16-byte, 8-byte or scalar");
  if constexpr (VEC == 1) {
    v[0] = ldg1(p);
  } else if constexpr (VEC * sizeof(T) == 16) {
    unpack<T>(__ldg(reinterpret_cast<const uint4*>(p)), v);
  } else {
    unpack<T>(__ldg(reinterpret_cast<const uint2*>(p)), v);
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void load_cs(const T* p, float (&v)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16 || VEC * sizeof(T) == 8,
                "16-byte, 8-byte or scalar");
  if constexpr (VEC == 1) {
    v[0] = ldcs1(p);
  } else if constexpr (VEC * sizeof(T) == 16) {
    unpack<T>(__ldcs(reinterpret_cast<const uint4*>(p)), v);
  } else {
    unpack<T>(__ldcs(reinterpret_cast<const uint2*>(p)), v);
  }
}
// v to VEC elements at p, streaming (st.global.cs: not kept in L2)
template <typename T, int VEC>
__device__ __forceinline__ void store_cs(T* p, const float (&v)[VEC]) {
  static_assert(VEC == 1 || VEC == Wide<T>::kVec, "16-byte or scalar");
  if constexpr (VEC == 1) {
    stcs1(p, v[0]);
  } else {
    __stcs(reinterpret_cast<uint4*>(p), pack<T>(v));
  }
}

template <int VEC>
__device__ __forceinline__ void fill(float (&v)[VEC], float a) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = a;
}

// fp32 p[0 .. VEC) += a * v: 16-byte reductions in L2
// (red.global.add.v4.f32, new in sm_90) where VEC is a multiple of 4
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float (&v)[VEC],
                                        float a) {
  if constexpr (VEC == 1) {
    atomicAdd(p, v[0] * a);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      atomicAdd(reinterpret_cast<float4*>(p + k),
                make_float4(v[k] * a, v[k + 1] * a, v[k + 2] * a,
                            v[k + 3] * a));
  }
}

}  // namespace elem
