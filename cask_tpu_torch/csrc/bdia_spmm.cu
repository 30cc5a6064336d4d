// BDIA SpMM on Hopper (sm_90a): Y = A·X for a BdiaMatrix, with X (n, k) and
// Y (m, k) dense, row-major, in natural order, for any k >= 1.
//
// Replaces the TPU kernel
//   cask_tpu/ops/pallas/bdia_kernels.py:607  bdia_spmm_pallas_ring  (B4)
// which computes, for each kept block offset d and column component c (the
// plan's pairs j = dpos(d)·bc + c) and block element row r,
//   Y[i·br + r, :] += vals[r, t, j, s, l] · X[(i + d)·bc + c, :],
//   i = (t·ts + s)·128 + l,
// from the packed (br, T, npairs, ts, 128) values that bdia_plan builds (the
// array the BDIA SpMV kernel reads).  The TPU kernel de-interleaves X into
// per-component strips held in a 4-bank VMEM ring so each X row crosses HBM
// once; on Hopper natural-order X rows are read directly.  The COO
// remainder is added outside the kernel.
//
// What bounds it: HBM bytes.  Every stored value is read once and does 2·k
// flops; X and Y cross HBM about once each.  At k = 128 on the 1M-row FEM
// matrix that is about 1.2 GB against 5.4 GFLOP, far below the card's FP32
// balance.
//
// What the design does about it:
// - One warp per block row; its lanes run over k, with 16-byte vector loads
//   and stores (float4 / double2) when k is a multiple of the vector width
//   and X, Y are 16-byte aligned, scalar ones otherwise.  An X row is one
//   coalesced warp load, and a block row's Y rows are coalesced stores.
// - All br output rows of a block row accumulate together in registers
//   (RB rows per warp, a template parameter; a block size above 8 spreads
//   its rows over gridDim.y), so each X row is loaded once per block row,
//   not once per component.
// - A value vals[r, ..., i] is one address for all lanes (a broadcast load);
//   the 8 warps of a CTA take 8 neighbouring block rows, whose values sit in
//   one 32-byte sector, so the value stream crosses HBM about once.
// - X rows outside [0, n) are skipped (they read as zero); rows i·br + r at
//   or beyond m are not written, so rectangular plans work either way.
// - Sums are taken in the output type's working type, in the plan's pair
//   order, the order of the plain PyTorch twin.
// - bf16 and f16 (value_types.cuh), the reference's half value paths and
//   their fully-half chains (bdia_kernels.py:607-611): values and X are
//   each H or f32 for one half type H, at least one H, widened exactly in
//   registers and summed in f32; Y is f32 or H (by default f16 for f16
//   values and X, else f32), H rounded once at the store.  A half X row
//   moves in 8-byte vectors of 4 (16-byte ones of 8 would leave half of a
//   row's warp idle at k = 128).

#include <cuda_runtime.h>
#include <stdint.h>

#include "value_types.cuh"

namespace {

constexpr int kMaxDiags = 80;  // block offsets a plan may hold (the pair cap)
constexpr int kThreads = 256;
constexpr int kWarp = 32;

struct DiagOffsets {
  int d[kMaxDiags];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// V: value type; X: X type; O: output type, summed in its working type A
template <typename V, typename X, typename O, int VEC, int RB>
__global__ void __launch_bounds__(kThreads)
bdia_spmm_kernel(const V* __restrict__ vals, const X* __restrict__ Xm, O* __restrict__ Y,
                 const DiagOffsets offs, int ndiag, int br, int bc, int64_t m, int64_t n,
                 int64_t nbr, int n_tiles, int tile, int k) {
  using A = typename cask::Work<O>::type;
  constexpr int kRows = kThreads / kWarp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kWarp;
  if (i >= nbr) return;
  const int lane = threadIdx.x % kWarp;
  const int r0 = blockIdx.y * RB;
  const int64_t t = i / tile;
  const int npairs = ndiag * bc;
  // vals[r, t, j, s, l] lives at ((r·T + t)·npairs + j)·tile + (i − t·tile)
  const int64_t r_stride = static_cast<int64_t>(n_tiles) * npairs * tile;
  const V* v = vals + (static_cast<int64_t>(r0) * n_tiles + t) * npairs * tile + (i - t * tile);
  const int nvec = k / VEC;

  for (int cv = lane; cv < nvec; cv += kWarp) {
    A acc[RB][VEC];
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = A(0);
    for (int dp = 0; dp < ndiag; ++dp) {
      const int64_t col0 = (i + offs.d[dp]) * bc;
      for (int c = 0; c < bc; ++c) {
        const int64_t col = col0 + c;
        if (col < 0 || col >= n) continue;
        A xv[VEC];
        cask::load_vec<X, VEC>(Xm + col * k + static_cast<int64_t>(cv) * VEC, xv);
        const V* vj = v + static_cast<int64_t>(dp * bc + c) * tile;
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          if (r0 + q < br) {
            const A a = A(cask::widen(__ldg(vj + q * r_stride)));
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[q][e] = fma_t(a, xv[e], acc[q][e]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int64_t row = i * br + r0 + q;
      if (r0 + q < br && row < m) {
        cask::store_vec<O, VEC>(Y + row * k + static_cast<int64_t>(cv) * VEC, acc[q]);
      }
    }
  }
}

template <typename V, typename X, typename O, int VEC, int RB>
int launch_rb(const V* vals, const X* Xm, O* Y, const DiagOffsets& offs, int ndiag, int br,
              int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles, int tile, int k,
              cudaStream_t s) {
  constexpr int kRows = kThreads / kWarp;
  const int64_t blocks = (nbr + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((br + RB - 1) / RB));
  bdia_spmm_kernel<V, X, O, VEC, RB><<<grid, kThreads, 0, s>>>(
      vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, typename O, int VEC>
int launch_vec(const V* vals, const X* Xm, O* Y, const DiagOffsets& offs, int ndiag, int br,
               int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles, int tile, int k,
               cudaStream_t s) {
  if (br <= 1) return launch_rb<V, X, O, VEC, 1>(vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k, s);
  if (br <= 2) return launch_rb<V, X, O, VEC, 2>(vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k, s);
  if (br <= 4) return launch_rb<V, X, O, VEC, 4>(vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k, s);
  return launch_rb<V, X, O, VEC, 8>(vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k, s);
}

template <typename V, typename X, typename O>
int dispatch(const V* vals, const X* Xm, O* Y, const int* offsets, int ndiag, int br, int bc,
             int64_t m, int64_t n, int64_t nbr, int n_tiles, int tile, int k, int vec,
             void* stream) {
  // a lane's X chunk: 16 bytes, but 4 half values (8 bytes), so that the 32
  // lanes of a row's warp still cover k = 128
  constexpr int kVec = sizeof(X) == 2 ? 4 : 16 / static_cast<int>(sizeof(X));
  if (ndiag < 1 || ndiag > kMaxDiags || br < 1 || bc < 1 || nbr < 1 || n_tiles < 1 ||
      tile < 1 || nbr > static_cast<int64_t>(n_tiles) * tile || k < 1 || (vec && k % kVec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DiagOffsets offs = {};
  for (int q = 0; q < ndiag; ++q) offs.d[q] = offsets[q];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_vec<V, X, O, kVec>(vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k, s);
  return launch_vec<V, X, O, 1>(vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k, s);
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/bdia_kernels.py).
// Pointers are device pointers except `offsets` (host, ndiag ints); `vec` = 1
// asks for 16-byte X loads and Y stores, which needs k a multiple of 16 bytes
// of the value type and X, Y 16-byte aligned (the wrapper checks).  The launch
// goes on `stream` and does not synchronise.  Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" {

int cask_bdia_spmm_f32(const float* vals, const float* X, float* Y, const int* offsets,
                       int ndiag, int br, int bc, long long m, long long n, long long nbr,
                       int n_tiles, int tile, int k, int vec, void* stream) {
  return dispatch<float, float, float>(vals, X, Y, offsets, ndiag, br, bc, m, n, nbr, n_tiles,
                                       tile, k, vec, stream);
}

int cask_bdia_spmm_f64(const double* vals, const double* X, double* Y, const int* offsets,
                       int ndiag, int br, int bc, long long m, long long n, long long nbr,
                       int n_tiles, int tile, int k, int vec, void* stream) {
  return dispatch<double, double, double>(vals, X, Y, offsets, ndiag, br, bc, m, n, nbr,
                                          n_tiles, tile, k, vec, stream);
}

// f32 values and X, f64 output and sums (accum_dtype=float64)
int cask_bdia_spmm_f32_f64(const float* vals, const float* X, double* Y, const int* offsets,
                           int ndiag, int br, int bc, long long m, long long n,
                           long long nbr, int n_tiles, int tile, int k, int vec,
                           void* stream) {
  return dispatch<float, float, double>(vals, X, Y, offsets, ndiag, br, bc, m, n, nbr, n_tiles,
                                        tile, k, vec, stream);
}

// Half values and/or X (the other of the same half type or f32): f32 sums;
// Y f32 or that half type.  The name gives the value, X and Y types.
#define CASK_BDIA_SPMM(NAME, V, X, O)                                                      \
  int NAME(const V* vals, const X* Xm, O* Y, const int* offsets, int ndiag, int br, int bc, \
           long long m, long long n, long long nbr, int n_tiles, int tile, int k, int vec,  \
           void* stream) {                                                                  \
    return dispatch<V, X, O>(vals, Xm, Y, offsets, ndiag, br, bc, m, n, nbr, n_tiles, tile, \
                             k, vec, stream);                                               \
  }
CASK_BDIA_SPMM(cask_bdia_spmm_bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, float)
CASK_BDIA_SPMM(cask_bdia_spmm_bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16)
CASK_BDIA_SPMM(cask_bdia_spmm_bf16_f32_f32, __nv_bfloat16, float, float)
CASK_BDIA_SPMM(cask_bdia_spmm_bf16_f32_bf16, __nv_bfloat16, float, __nv_bfloat16)
CASK_BDIA_SPMM(cask_bdia_spmm_f32_bf16_f32, float, __nv_bfloat16, float)
CASK_BDIA_SPMM(cask_bdia_spmm_f32_bf16_bf16, float, __nv_bfloat16, __nv_bfloat16)
CASK_BDIA_SPMM(cask_bdia_spmm_f16_f16_f32, __half, __half, float)
CASK_BDIA_SPMM(cask_bdia_spmm_f16_f16_f16, __half, __half, __half)
CASK_BDIA_SPMM(cask_bdia_spmm_f16_f32_f32, __half, float, float)
CASK_BDIA_SPMM(cask_bdia_spmm_f16_f32_f16, __half, float, __half)
CASK_BDIA_SPMM(cask_bdia_spmm_f32_f16_f32, float, __half, float)
CASK_BDIA_SPMM(cask_bdia_spmm_f32_f16_f16, float, __half, __half)
#undef CASK_BDIA_SPMM

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
