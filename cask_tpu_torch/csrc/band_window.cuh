// The window of a band SpMM, shared by the DIA and BDIA ring SpMM kernels
// (dia_spmm.cu, bdia_spmm.cu): each X row is read once per tile of output
// rows, not once per diagonal, and a block's values are staged in shared
// memory (stage_spans) before their products.
//
// A plan's offsets (a DIA plan's diagonals, a BDIA plan's block offsets) are
// walked in chunks: at most C consecutive entries whose offsets rise by one,
// the pieces of a band's runs.  A thread that owns R consecutive output rows
// i0 .. i0 + R − 1 needs, for a chunk of len offsets off, off + 1, ..., the X
// rows i0 + off + w for w in [0, R + len − 1): it loads each once into a
// register window and uses it for every row it reaches (row q and chunk entry
// dd meet at w = q + dd), R·len products from R + len − 1 loads where a kernel
// that loads per diagonal makes R·len loads.  A plan of scattered offsets
// (chunks of one) loads R rows for R products, as such a kernel does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "value_types.cuh"

namespace cask {

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// the length of the chunk that starts with o[0]: 1 + the number of the
// entries o[1], o[2], ... that continue its run (o[e] == o[0] + e), of the
// `avail` entries that are left in the plan
template <int C>
__device__ __forceinline__ int chunk_length(const int (&o)[C], int avail) {
  int len = 1;
#pragma unroll
  for (int e = 1; e < C; ++e) len += (len == e && e < avail && o[e] == o[0] + e);
  return len;
}

// N consecutive values from shared memory into working-type registers, with
// vector loads of up to 16 bytes (p aligned to the span's width, N values)
template <typename V, int N, typename A>
__device__ __forceinline__ void load_span_shared(const V* p, A (&out)[N]) {
  constexpr int kBytes = N * sizeof(V) < 16 ? N * static_cast<int>(sizeof(V)) : 16;
  constexpr int kPer = kBytes / static_cast<int>(sizeof(V));  // values a load
#pragma unroll
  for (int s = 0; s < N; s += kPer) {
    alignas(16) V buf[kPer];
    if constexpr (kBytes == 16) {
      *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(p + s);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(p + s);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<unsigned*>(buf) = *reinterpret_cast<const unsigned*>(p + s);
    } else {
      *reinterpret_cast<unsigned short*>(buf) = *reinterpret_cast<const unsigned short*>(p + s);
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) out[s + e] = A(widen(buf[e]));
  }
}

// Stage n_spans spans of `len` values into shared memory, span s from
// src(s) to dst + s·len, the values at or past `limit` of each span as zero;
// the block's threads (`tid` of kThreads) share the work.  With `vec` (every
// src(s) 16-byte aligned and len·sizeof(V) a multiple of 16) in 16-byte
// cp.async copies (L2 only; a copy past `limit` reads nothing and writes
// zeros, so `limit` must be a multiple of 16 bytes of values), which the
// caller waits for (cp_async_wait_all); otherwise value by value.
template <int kThreads, typename V, typename Src>
__device__ __forceinline__ void stage_spans(V* dst, Src src, int n_spans, int len, int limit,
                                            bool vec, int tid) {
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(V));
    const int chunks = len / kPer;
    for (int q = tid; q < n_spans * chunks; q += kThreads) {
      const int s = q / chunks, e = (q - s * chunks) * kPer;
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + s * len + e));
      const int bytes = e < limit ? 16 : 0;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src(s) + (e < limit ? e : 0)), "r"(bytes) : "memory");
    }
  } else {
    for (int q = tid; q < n_spans * len; q += kThreads) {
      const int s = q / len, e = q - s * len;
      dst[q] = e < limit ? __ldg(src(s) + e) : V{};
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace cask
