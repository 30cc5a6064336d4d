// DIA SpMM on Hopper (sm_90a): Y = A·X for a DiaMatrix, with X (n, k) and
// Y (m, k) dense, row-major, in natural order, for any k >= 1.
//
// Replaces the TPU kernels (cask_tpu/ops/pallas/dia_kernels.py)
//   :789   dia_spmm_pallas_padded          (B12: resident or windowed X)
//   :1023  dia_spmm_pallas_ring_padded     (B13: X read once through a ring)
//   :1148  dia_spmm_pallas_kt_padded       (B14: k <= 64, X transposed)
//   :1314  dia_spmm_pallas_ring_mxu_padded (B15: near band as a bf16 matmul)
// All four compute
//   Y[i, :] = Σ_d vals[d, i] · X[i + offsets[d], :],   0 <= i < m,
// from the packed vals (ndiags, m_pad) that dia_plan builds.  They differ
// only in how the TPU stages X in VMEM (lane padding of k, a transposed
// layout for narrow k, a 4-bank ring, a banded MXU product).  B15 is
// bf16-class on its near band; this kernel is exact-class everywhere, as
// the JAX package's DIA SpMM is: plain FP32 or FP64 FMAs, no tensor cores,
// no TF32.  The COO remainder is added outside the kernel.
//
// What bounds it: HBM bandwidth.  2·k flops per stored value, but the bytes
// are vals (ndiags·m_pad) + X (n·k) + Y (m·k) once each; at k = 32 and five
// diagonals that is 5·32·2 flops per (5 + 64)·4 bytes, about 1.2 flops per
// byte, far below the card's FP32 balance.
//
// What the design does about it:
// - A block of 256 threads covers R rows × k columns.  Each row's TPR
//   threads (a power of two up to 32, the least that covers k) own
//   column chunks of that row: 16-byte vector loads (float4 / double2) when
//   k is a multiple of the vector width and X, Y are 16-byte aligned, scalar
//   loads otherwise.  A row's X[j, :] is contiguous and adjacent rows read
//   adjacent X rows, so X loads and Y stores coalesce.
// - vals[d, i] is one address for all TPR threads of row i: the warp loads
//   it once and broadcasts it, so each value crosses HBM once.
// - X[i + off] is re-read by the ndiags rows that need it within a window
//   of |off| rows, which L2 holds, so X crosses HBM about once.  Y is
//   written once with streaming stores (__stcs).
// - The offsets are a small int32 device array that the plan builds once,
//   read as a broadcast; any diagonal count is taken.
// - X is read only where 0 <= i + off < n.  Rows m <= i < m_pad are never
//   written, and m != n works.
// - Sums are taken in the working type, in offsets order, the order of the
//   plain PyTorch twin.
// - bf16 and f16 (value_types.cuh), the reference's half value paths and
//   their fully-half chains (dia_kernels.py:1026-1033): values and X are
//   each H or f32 for one half type H, at least one H, widened exactly in
//   registers and summed in f32; Y is f32 or H (by default f16 for f16
//   values and X, else f32), H rounded once at the store.  A half X row
//   moves in 16-byte vectors of 8 where k is a multiple of 8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "value_types.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// V: value type; X: X type; O: output type, summed in its working type A
template <typename V, typename X, typename O, int VEC, int TPR>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const V* __restrict__ vals, const int* __restrict__ offsets,
                int ndiag, const X* __restrict__ Xm, O* __restrict__ Y,
                int64_t m, int64_t n, int64_t m_pad, int k) {
  using A = typename cask::Work<O>::type;
  constexpr int kRows = kThreads / TPR;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / TPR;
  if (i >= m) return;
  const int lane = threadIdx.x % TPR;
  const int nvec = k / VEC;
  const V* v = vals + i;
  for (int c = lane; c < nvec; c += TPR) {
    A acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = A(0);
    for (int d = 0; d < ndiag; ++d) {
      const int64_t j = i + __ldg(offsets + d);
      if (j < 0 || j >= n) continue;
      const A a = A(cask::widen(__ldg(v + static_cast<int64_t>(d) * m_pad)));
      A xv[VEC];
      cask::load_vec<X, VEC>(Xm + j * k + static_cast<int64_t>(c) * VEC, xv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fma_t(a, xv[e], acc[e]);
    }
    cask::store_vec<O, VEC>(Y + i * k + static_cast<int64_t>(c) * VEC, acc);
  }
}

template <typename V, typename X, typename O, int VEC, int TPR>
int launch_tpr(const V* vals, const int* offsets, int ndiag, const X* Xm, O* Y,
               int64_t m, int64_t n, int64_t m_pad, int k, cudaStream_t s) {
  constexpr int kRows = kThreads / TPR;
  const int64_t blocks = (m + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dia_spmm_kernel<V, X, O, VEC, TPR><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      vals, offsets, ndiag, Xm, Y, m, n, m_pad, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, typename O, int VEC>
int launch_vec(const V* vals, const int* offsets, int ndiag, const X* Xm, O* Y,
               int64_t m, int64_t n, int64_t m_pad, int k, cudaStream_t s) {
  const int nvec = k / VEC;
  if (nvec <= 1) return launch_tpr<V, X, O, VEC, 1>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
  if (nvec <= 2) return launch_tpr<V, X, O, VEC, 2>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
  if (nvec <= 4) return launch_tpr<V, X, O, VEC, 4>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
  if (nvec <= 8) return launch_tpr<V, X, O, VEC, 8>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
  if (nvec <= 16) return launch_tpr<V, X, O, VEC, 16>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
  return launch_tpr<V, X, O, VEC, 32>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
}

template <typename V, typename X, typename O>
int launch(const V* vals, const int* offsets, int ndiag, const X* Xm, O* Y,
           int64_t m, int64_t n, int64_t m_pad, int k, int vec, void* stream) {
  constexpr int kVec = 16 / sizeof(X);
  if (ndiag < 1 || m < 1 || n < 1 || k < 1 || m_pad < m || (vec && k % kVec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_vec<V, X, O, kVec>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
  return launch_vec<V, X, O, 1>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, s);
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/dia_kernels.py).
// All pointers are device pointers (`offsets`: ndiag int32); `vec` = 1 asks
// for 16-byte loads and stores, which needs k a multiple of 16 bytes and X, Y
// 16-byte aligned (the wrapper checks).  The launch goes on `stream` and does
// not synchronise.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" {

int cask_dia_spmm_f32(const float* vals, const int* offsets, int ndiag,
                      const float* X, float* Y, long long m, long long n,
                      long long m_pad, int k, int vec, void* stream) {
  return launch<float, float, float>(vals, offsets, ndiag, X, Y, m, n, m_pad, k, vec, stream);
}

int cask_dia_spmm_f64(const double* vals, const int* offsets, int ndiag,
                      const double* X, double* Y, long long m, long long n,
                      long long m_pad, int k, int vec, void* stream) {
  return launch<double, double, double>(vals, offsets, ndiag, X, Y, m, n, m_pad, k, vec,
                                        stream);
}

// Half values and/or X (the other of the same half type or f32): f32 sums;
// Y f32 or that half type.  The name gives the value, X and Y types.
#define CASK_DIA_SPMM(NAME, V, X, O)                                                      \
  int NAME(const V* vals, const int* offsets, int ndiag, const X* Xm, O* Y, long long m, \
           long long n, long long m_pad, int k, int vec, void* stream) {                 \
    return launch<V, X, O>(vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, vec, stream);    \
  }
CASK_DIA_SPMM(cask_dia_spmm_bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, float)
CASK_DIA_SPMM(cask_dia_spmm_bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16)
CASK_DIA_SPMM(cask_dia_spmm_bf16_f32_f32, __nv_bfloat16, float, float)
CASK_DIA_SPMM(cask_dia_spmm_bf16_f32_bf16, __nv_bfloat16, float, __nv_bfloat16)
CASK_DIA_SPMM(cask_dia_spmm_f32_bf16_f32, float, __nv_bfloat16, float)
CASK_DIA_SPMM(cask_dia_spmm_f32_bf16_bf16, float, __nv_bfloat16, __nv_bfloat16)
CASK_DIA_SPMM(cask_dia_spmm_f16_f16_f32, __half, __half, float)
CASK_DIA_SPMM(cask_dia_spmm_f16_f16_f16, __half, __half, __half)
CASK_DIA_SPMM(cask_dia_spmm_f16_f32_f32, __half, float, float)
CASK_DIA_SPMM(cask_dia_spmm_f16_f32_f16, __half, float, __half)
CASK_DIA_SPMM(cask_dia_spmm_f32_f16_f32, float, __half, float)
CASK_DIA_SPMM(cask_dia_spmm_f32_f16_f16, float, __half, __half)
#undef CASK_DIA_SPMM

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
