// BSR SpMM on Hopper (sm_90a): Y = A·X for an ELL-packed BSR plan
// (BsrSpmmKernel), with X (n, k) and Y (m, k) dense and row-major, any k >= 1.
//
// Replaces the TPU kernel
//   cask_tpu/ops/pallas/bsr_kernels.py:91  BsrSpmmKernel (B7; kernel body _kernel :47)
// which computes, for group t of G block rows, block row g of the group,
// element row r and ELL slot s < K,
//   Y[(t·G + g)·br + r, :] = Σ_s Σ_c vals[t, g·br + r, s·bc + c]
//                                    · X[cols[(t·G + g)·K + s]·bc + c, :]
// from the plan's packed vals (T, G·br, K·bc) and cols (T·G·K,).  The TPU
// kernel DMAs the K referenced X block rows into a VMEM panel and issues one
// (br, K·bc) @ (K·bc, k) MXU product per block row.  Padded slots hold zero
// values and column 0, so they add nothing; X rows n <= row < n_pad read as
// zero (bsr_kernels.py:139-140).
//
// What bounds it: HBM bytes.  The values are read once and do 2·k flops each;
// X rows are gathered by cols (each X row is referenced by the few block rows
// around it, which L2 serves) and Y is written once.  At k = 128 on the
// 1M-row FEM matrix that is about 1.2 GB against 5.4 GFLOP, far below the
// card's FP32 balance.
//
// What the design does about it:
// - One CTA per group of G block rows (G·32 threads); warp g takes block row
//   t·G + g and its lanes run over k, with 16-byte vector loads and stores
//   when k and the pointers allow, scalar ones otherwise.
// - The K referenced X block rows are gathered by cols straight into
//   registers: each warp loads each X element it needs exactly once (a
//   coalesced row load) and uses it for all br output rows of its block row,
//   which accumulate together (RB rows per warp; a block size above 8
//   spreads its rows over gridDim.y).  A shared-memory panel, the TPU's
//   VMEM staging, would add a copy: no X element is read by two warps of a
//   CTA, and within a warp each lane reads only its own columns.
// - A value vals[t, row, w] is one address for all lanes (a broadcast load);
//   the group's values are contiguous, so they cross HBM once.
// - Sums are taken in the working type (FP32 for f32, FP64 for f64), in slot
//   order, the order of the plain PyTorch twin's product.
//
// Half values or X (bf16 or f16, with the other the same half type or f32):
// each widens exactly to f32 as it loads, the sums are f32, and Y takes the
// values' type as in the reference (bsr_kernels.py:161): a half Y, even
// beside an f32 X, is each f32 sum rounded once at the store.  A half X
// moves 4 columns a lane in each 8-byte load, so a warp spans 128 columns:
// with 16-byte loads of 8, half of each warp would idle at k = 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "value_types.cuh"

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// V: value type, X: X type, O: output type (the values' type); sums in
// O's working type
template <typename V, typename X, typename O, int VEC, int RB>
__global__ void __launch_bounds__(256)
bsr_spmm_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
                const X* __restrict__ Xm, O* __restrict__ Y, int G, int K, int br, int bc,
                int64_t m, int64_t n, int64_t nbr, int k) {
  using T = typename cask::Work<O>::type;
  const int64_t t = blockIdx.x;
  const int g = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t bi = t * G + g;  // block row
  if (bi >= nbr) return;
  const int r0 = blockIdx.y * RB;
  const int kb = K * bc;
  // vals[t, g·br + r, s·bc + c] lives at ((t·G + g)·br + r)·K·bc + s·bc + c
  const V* v = vals + (bi * br + r0) * kb;
  const int* cb = cols + bi * K;
  const int nvec = k / VEC;

  for (int cv = lane; cv < nvec; cv += kWarp) {
    T acc[RB][VEC];
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = T(0);
    for (int s = 0; s < K; ++s) {
      const int64_t xrow0 = static_cast<int64_t>(__ldg(cb + s)) * bc;
      for (int c = 0; c < bc; ++c) {
        const int64_t xr = xrow0 + c;
        if (xr >= n) continue;  // the zero pad rows n <= row < n_pad
        T xv[VEC];
        cask::load_vec<X, VEC>(Xm + xr * k + static_cast<int64_t>(cv) * VEC, xv);
        const V* vw = v + s * bc + c;
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          if (r0 + q < br) {
            const T a = T(cask::widen(__ldg(vw + static_cast<int64_t>(q) * kb)));
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[q][e] = fma_t(a, xv[e], acc[q][e]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int64_t row = bi * br + r0 + q;
      if (r0 + q < br && row < m) {
        cask::store_vec<O, VEC>(Y + row * k + static_cast<int64_t>(cv) * VEC, acc[q]);
      }
    }
  }
}

template <typename V, typename X, typename O, int VEC, int RB>
int launch_rb(const V* vals, const int* cols, const X* Xm, O* Y, int64_t T_groups, int G,
              int K, int br, int bc, int64_t m, int64_t n, int64_t nbr, int k,
              cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(T_groups), static_cast<unsigned>((br + RB - 1) / RB));
  bsr_spmm_kernel<V, X, O, VEC, RB><<<grid, G * kWarp, 0, s>>>(vals, cols, Xm, Y, G, K, br, bc,
                                                               m, n, nbr, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, typename O, int VEC>
int launch_vec(const V* vals, const int* cols, const X* Xm, O* Y, int64_t T_groups, int G,
               int K, int br, int bc, int64_t m, int64_t n, int64_t nbr, int k,
               cudaStream_t s) {
  if (br <= 1) return launch_rb<V, X, O, VEC, 1>(vals, cols, Xm, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  if (br <= 2) return launch_rb<V, X, O, VEC, 2>(vals, cols, Xm, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  if (br <= 4) return launch_rb<V, X, O, VEC, 4>(vals, cols, Xm, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  return launch_rb<V, X, O, VEC, 8>(vals, cols, Xm, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
}

// the output takes the values' type (the reference's out_shape)
template <typename V, typename X>
int dispatch(const void* vals_p, const int* cols, const void* X_p, void* Y_p,
             long long T_groups, int G, int K, int br, int bc, long long m, long long n,
             long long nbr, int k, int vec, void* stream) {
  // a lane's columns: 16 bytes of an f32 or f64 X row, 8 of a half one (4
  // columns: 8 of them would leave half of a warp idle at k = 128)
  constexpr int kVec = sizeof(X) == 2 ? 4 : 16 / static_cast<int>(sizeof(X));
  if (T_groups < 1 || T_groups > 0x7fffffff || G < 1 || G > 8 || K < 1 || br < 1 ||
      bc < 1 || k < 1 || nbr > T_groups * G || (br + 7) / 8 > 65535 || (vec && k % kVec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const V* vals = static_cast<const V*>(vals_p);
  const X* Xm = static_cast<const X*>(X_p);
  V* Y = static_cast<V*>(Y_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_vec<V, X, V, kVec>(vals, cols, Xm, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  return launch_vec<V, X, V, 1>(vals, cols, Xm, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/bsr_kernels.py).
// All pointers are device pointers (`cols`: T·G·K int32 block-column ids).
// One entry per type combination, cask_bsr_spmm_<values>_<X>
// (cask_bsr_spmm_f32 / _f64 for one f32 or f64 type); Y has the values'
// type.  `vec` = 1 asks for vector loads of X (16 bytes, 8 for a half X)
// and stores of Y, which needs k·size a multiple of 16 bytes for X and Y
// and both 16-byte aligned (the wrapper checks).  The launch goes on
// `stream` and does not synchronise.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" {

#define CASK_BSR_SPMM(name, V, X)                                                             \
  int name(const void* vals, const int* cols, const void* X_, void* Y, long long T_groups,    \
           int G, int K, int br, int bc, long long m, long long n, long long nbr, int k,      \
           int vec, void* stream) {                                                           \
    return dispatch<V, X>(vals, cols, X_, Y, T_groups, G, K, br, bc, m, n, nbr, k, vec,       \
                          stream);                                                            \
  }

CASK_BSR_SPMM(cask_bsr_spmm_f32, float, float)
CASK_BSR_SPMM(cask_bsr_spmm_f64, double, double)
CASK_BSR_SPMM(cask_bsr_spmm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
CASK_BSR_SPMM(cask_bsr_spmm_bf16_f32, __nv_bfloat16, float)
CASK_BSR_SPMM(cask_bsr_spmm_f32_bf16, float, __nv_bfloat16)
CASK_BSR_SPMM(cask_bsr_spmm_f16_f16, __half, __half)
CASK_BSR_SPMM(cask_bsr_spmm_f16_f32, __half, float)
CASK_BSR_SPMM(cask_bsr_spmm_f32_f16, float, __half)

#undef CASK_BSR_SPMM

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
