// DIA SpMV on Hopper (sm_90a): y = A·x for a DiaMatrix, natural-order x in
// and natural-order y out.
//
// Replaces the TPU kernels (cask_tpu/ops/pallas/dia_kernels.py)
//   :176  dia_spmv_pallas_padded       (B8: one-shot, resident or windowed x)
//   :336  dia_spmv_pallas_layout       (B9: the chainable solver layout)
//   :511  dia_spmv_pallas_interleaved  (B10: lanes hold contiguous segments)
//   :650  dia_spmv_pallas_il_stream    (B11: the same, x chunk-prefetched)
// All four compute
//   y[i] = Σ_d vals[d, i] · x[i + offsets[d]],   0 <= i < m,
// from the packed vals (ndiags, m_pad) that dia_plan builds.  They differ
// only in how the TPU lays x out in VMEM (lane rolls and selects, segment
// carry corrections, windowed or chunked DMA); natural-order loads replace
// all of it here.  The COO remainder is added outside the kernel, as on the
// TPU.
//
// What bounds it: HBM bandwidth.  Each stored value is read once and used
// for one FMA (2 flops per 4 bytes in f32, far below the card's balance), so
// the bytes are ndiags·m_pad values plus x and y once each.
//
// What the design does about it:
// - One thread per output row i.  For a fixed diagonal d, adjacent threads
//   read adjacent vals[d, i], so every warp's value load is 128 contiguous
//   bytes (f32): the value stream is fully coalesced.  Values are loaded with
//   __ldcs (evict-first), since each is read once, so they do not push x out
//   of L2.
// - x goes through the read-only path (__ldg).  Adjacent rows read adjacent
//   x[i + off], so each diagonal's x reads coalesce too, and the ndiags reads
//   of one x element by different rows hit L1/L2: x crosses HBM about once.
// - The offsets are a small int32 device array that the plan builds once;
//   every thread of a warp reads the same one (a broadcast load, L1-resident),
//   so the kernel takes any diagonal count and needs no second route.
// - x is read only where 0 <= i + off < n: structural zeros cover the value,
//   not the index.  Rows m <= i < m_pad are never written, and m != n works.
// - Sums are taken in the working type (float for f32, double for f64), in
//   offsets order, the order of the plain PyTorch twin.
// - Half values (or a half x), the reference's half value paths: values
//   and x are each H or f32 for one half type H (bf16 or f16), at least one
//   H, widened exactly to f32 in registers and summed in f32.  y is the
//   reference's output type O: f32, but f16 for f16 values and x, the f32
//   sum rounded once at the store.  The value stream halves (a warp's load
//   is 64 contiguous bytes, whole 32-byte sectors).  Two rows a thread
//   (their values as one __nv_bfloat162) measured no faster on the 4M-row
//   stencil.

#include <cuda_runtime.h>
#include <stdint.h>

#include "value_types.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// V: value type; X: x type; O: output type, summed in its working type A
template <typename V, typename X, typename O>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const V* __restrict__ vals, const int* __restrict__ offsets,
                int ndiag, const X* __restrict__ x, O* __restrict__ y,
                int64_t m, int64_t n, int64_t m_pad) {
  using A = typename cask::Work<O>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const V* v = vals + i;
  A acc = A(0);
#pragma unroll 4
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    const A a = A(cask::widen(__ldcs(v + static_cast<int64_t>(d) * m_pad)));
    const A xv = (j >= 0 && j < n) ? A(cask::widen(__ldg(x + j))) : A(0);
    acc = fma_t(a, xv, acc);
  }
  y[i] = cask::narrow<O>(acc);
}

template <typename V, typename X, typename O>
int launch(const V* vals, const int* offsets, int ndiag, const X* x, O* y,
           int64_t m, int64_t n, int64_t m_pad, void* stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (ndiag < 1 || m < 1 || n < 1 || m_pad < m || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dia_spmv_kernel<V, X, O><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      vals, offsets, ndiag, x, y, m, n, m_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/dia_kernels.py).
// All pointers are device pointers (`offsets`: ndiag int32); the launch goes
// on `stream` and does not synchronise.  Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" {

int cask_dia_spmv_f32(const float* vals, const int* offsets, int ndiag,
                      const float* x, float* y, long long m, long long n,
                      long long m_pad, void* stream) {
  return launch<float, float, float>(vals, offsets, ndiag, x, y, m, n, m_pad, stream);
}

int cask_dia_spmv_f64(const double* vals, const int* offsets, int ndiag,
                      const double* x, double* y, long long m, long long n,
                      long long m_pad, void* stream) {
  return launch<double, double, double>(vals, offsets, ndiag, x, y, m, n, m_pad, stream);
}

// Half values with an x of the same half type or f32, or f32 values with a
// half x: f32 sums; y f32, or f16 for f16 values and x.  The name gives the
// value and x types.
#define CASK_DIA_SPMV(NAME, V, X, O)                                                      \
  int NAME(const V* vals, const int* offsets, int ndiag, const X* x, O* y, long long m,   \
           long long n, long long m_pad, void* stream) {                                 \
    return launch<V, X, O>(vals, offsets, ndiag, x, y, m, n, m_pad, stream);              \
  }
CASK_DIA_SPMV(cask_dia_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16, float)
CASK_DIA_SPMV(cask_dia_spmv_bf16_f32, __nv_bfloat16, float, float)
CASK_DIA_SPMV(cask_dia_spmv_f32_bf16, float, __nv_bfloat16, float)
CASK_DIA_SPMV(cask_dia_spmv_f16_f16, __half, __half, __half)
CASK_DIA_SPMV(cask_dia_spmv_f16_f32, __half, float, float)
CASK_DIA_SPMV(cask_dia_spmv_f32_f16, float, __half, float)
#undef CASK_DIA_SPMV

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
