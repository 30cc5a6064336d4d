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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, T (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  } else {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    out[0] = q.x; out[1] = q.y;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
}

template <typename T, int VEC, int RB>
__global__ void __launch_bounds__(256)
bsr_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                const T* __restrict__ X, T* __restrict__ Y, int G, int K, int br, int bc,
                int64_t m, int64_t n, int64_t nbr, int k) {
  const int64_t t = blockIdx.x;
  const int g = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t bi = t * G + g;  // block row
  if (bi >= nbr) return;
  const int r0 = blockIdx.y * RB;
  const int kb = K * bc;
  // vals[t, g·br + r, s·bc + c] lives at ((t·G + g)·br + r)·K·bc + s·bc + c
  const T* v = vals + (bi * br + r0) * kb;
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
        load_vec<T, VEC>(X + xr * k + static_cast<int64_t>(cv) * VEC, xv);
        const T* vw = v + s * bc + c;
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          if (r0 + q < br) {
            const T a = __ldg(vw + static_cast<int64_t>(q) * kb);
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
        store_vec<T, VEC>(Y + row * k + static_cast<int64_t>(cv) * VEC, acc[q]);
      }
    }
  }
}

template <typename T, int VEC, int RB>
int launch_rb(const T* vals, const int* cols, const T* X, T* Y, int64_t T_groups, int G,
              int K, int br, int bc, int64_t m, int64_t n, int64_t nbr, int k,
              cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(T_groups), static_cast<unsigned>((br + RB - 1) / RB));
  bsr_spmm_kernel<T, VEC, RB><<<grid, G * kWarp, 0, s>>>(vals, cols, X, Y, G, K, br, bc, m,
                                                         n, nbr, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const T* vals, const int* cols, const T* X, T* Y, int64_t T_groups, int G,
               int K, int br, int bc, int64_t m, int64_t n, int64_t nbr, int k,
               cudaStream_t s) {
  if (br <= 1) return launch_rb<T, VEC, 1>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  if (br <= 2) return launch_rb<T, VEC, 2>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  if (br <= 4) return launch_rb<T, VEC, 4>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  return launch_rb<T, VEC, 8>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
}

template <typename T>
int dispatch(const T* vals, const int* cols, const T* X, T* Y, long long T_groups, int G,
             int K, int br, int bc, long long m, long long n, long long nbr, int k, int vec,
             void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (T_groups < 1 || T_groups > 0x7fffffff || G < 1 || G > 8 || K < 1 || br < 1 ||
      bc < 1 || k < 1 || nbr > T_groups * G || (br + 7) / 8 > 65535 || (vec && k % kVec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_vec<T, kVec>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
  return launch_vec<T, 1>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, s);
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/bsr_kernels.py).
// All pointers are device pointers (`cols`: T·G·K int32 block-column ids);
// `vec` = 1 asks for 16-byte loads and stores, which needs k a multiple of 16
// bytes and X, Y 16-byte aligned (the wrapper checks).  The launch goes on
// `stream` and does not synchronise.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" {

int cask_bsr_spmm_f32(const float* vals, const int* cols, const float* X, float* Y,
                      long long T_groups, int G, int K, int br, int bc, long long m,
                      long long n, long long nbr, int k, int vec, void* stream) {
  return dispatch<float>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, vec, stream);
}

int cask_bsr_spmm_f64(const double* vals, const int* cols, const double* X, double* Y,
                      long long T_groups, int G, int K, int br, int bc, long long m,
                      long long n, long long nbr, int k, int vec, void* stream) {
  return dispatch<double>(vals, cols, X, Y, T_groups, G, K, br, bc, m, n, nbr, k, vec,
                          stream);
}

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
