// The kernels' value types: f32, f64, and the half types bf16 and f16,
// which are summed in f32.
//
// A half value or operand widens exactly to f32 in registers
// (__bfloat162float: a bf16 is the top half of the f32 of the same value;
// __half2float: every f16 is an f32); sums run in the working type Work<O>
// of the output type O (float for f32, bf16 and f16 outputs, double for
// f64); a half output is rounded once, at the store, to nearest even
// (__float2bfloat16_rn, __float2half_rn).  Vector loads and stores move 16
// bytes of the operand type at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cask {

template <typename T>
struct Work {
  using type = T;
};
template <>
struct Work<__nv_bfloat16> {
  using type = float;
};
template <>
struct Work<__half> {
  using type = float;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// a working-type sum as the output type O: rounded once, to nearest even,
// for a half O
template <typename O, typename A>
__device__ __forceinline__ O narrow(A v) {
  if constexpr (std::is_same_v<O, __nv_bfloat16>) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same_v<O, __half>) {
    return __float2half_rn(v);
  } else {
    return O(v);
  }
}

// two f32 values rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two f32 values rounded to the half type H and packed, lo in the low half
template <typename H>
__device__ __forceinline__ uint32_t pack_half2(float lo, float hi) {
  if constexpr (std::is_same_v<H, __half>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    return pack_bf16x2(lo, hi);
  }
}

// the two values of the half type H in a packed word, widened
template <typename H>
__device__ __forceinline__ float2 unpack_half2(uint32_t w) {
  if constexpr (std::is_same_v<H, __half>) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
}

// VEC consecutive elements of a row into working-type registers: one vector
// load (read-only path) of VEC elements, 16 bytes (8 for 4 half values)
template <typename X, int VEC, typename A>
__device__ __forceinline__ void load_vec(const X* p, A (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = A(widen(__ldg(p)));
  } else if constexpr (sizeof(X) == 2) {
    static_assert(VEC == 8 || VEC == 4, "half vectors are 8 or 4 elements");
    uint32_t w[VEC / 2];
    if constexpr (VEC == 8) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    }
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      const float2 f = unpack_half2<X>(w[e]);
      out[2 * e] = A(f.x);
      out[2 * e + 1] = A(f.y);
    }
  } else if constexpr (sizeof(X) == 4) {
    static_assert(VEC == 4, "f32 vectors are 4 elements");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = A(q.x); out[1] = A(q.y); out[2] = A(q.z); out[3] = A(q.w);
  } else {
    static_assert(VEC == 2, "f64 vectors are 2 elements");
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    out[0] = A(q.x); out[1] = A(q.y);
  }
}

// four consecutive elements into working-type registers with one streaming
// (evict-first, ld.global.cs) vector load: 16 bytes, 8 for half values, two
// of 16 for f64; p must be aligned to the vector's width
template <typename V, typename A>
__device__ __forceinline__ void load4_cs(const V* p, A (&out)[4]) {
  if constexpr (sizeof(V) == 2) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    const float2 lo = unpack_half2<V>(q.x), hi = unpack_half2<V>(q.y);
    out[0] = A(lo.x); out[1] = A(lo.y); out[2] = A(hi.x); out[3] = A(hi.y);
  } else if constexpr (sizeof(V) == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    out[0] = A(q.x); out[1] = A(q.y); out[2] = A(q.z); out[3] = A(q.w);
  } else {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    out[0] = A(a.x); out[1] = A(a.y); out[2] = A(b.x); out[3] = A(b.y);
  }
}

// four consecutive int32 indices with one streaming 16-byte load
__device__ __forceinline__ void load4i_cs(const int* p, int (&out)[4]) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

// VEC working-type values stored as the output type O with streaming
// stores: vector stores of 16 bytes (8 for 4 half values) where the row's
// chunk is that wide and aligned (the caller's vec gate), scalar otherwise
template <typename O, int VEC, typename A>
__device__ __forceinline__ void store_vec(O* p, const A (&v)[VEC]) {
  if constexpr (sizeof(O) == 2) {
    if constexpr (VEC == 8) {
      __stcs(reinterpret_cast<uint4*>(p),
             make_uint4(pack_half2<O>(v[0], v[1]), pack_half2<O>(v[2], v[3]),
                        pack_half2<O>(v[4], v[5]), pack_half2<O>(v[6], v[7])));
    } else if constexpr (VEC == 4) {
      __stcs(reinterpret_cast<uint2*>(p),
             make_uint2(pack_half2<O>(v[0], v[1]), pack_half2<O>(v[2], v[3])));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const O h = narrow<O>(v[e]);
        __stcs(reinterpret_cast<unsigned short*>(p + e),
               *reinterpret_cast<const unsigned short*>(&h));
      }
    }
  } else if constexpr (sizeof(O) == 4 && VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      __stcs(reinterpret_cast<float4*>(p + e), make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
    }
  } else if constexpr (sizeof(O) == 8 && VEC % 2 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 2) {
      __stcs(reinterpret_cast<double2*>(p + e), make_double2(v[e], v[e + 1]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) __stcs(p + e, O(v[e]));
  }
}

}  // namespace cask
