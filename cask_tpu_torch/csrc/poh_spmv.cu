// POH SpMV on Hopper (sm_90a): y = A·x on the panel one-hot pack (PohMatrix).
//
// Replaces the TPU kernel
//   cask_tpu/ops/pallas/poh_kernels.py:388  poh_spmv_pallas (B16; body _poh_kernel :311)
// which computes, for every tile t and slot j of the pack,
//   y[panel[t]·R + rloc[t, j]] += vals[t, j] · x[wlo[t]·C + cloc[t, j]]
// (rows >= m dropped, x read as 0 at columns >= n; padding slots hold value 0
// at cloc = rloc = 0).  The TPU has no usable deep gather, so the reference
// builds one-hot matrices from iota compares and gathers and scatters with
// bf16 hi/lo MXU products.  Hopper has real gathers: this kernel is a plain
// gather / scatter with FP32 (or FP64) FMAs, so its result is exact-class.
//
// What bounds it: HBM bytes.  Each slot moves 4 + 4 + 4 bytes (f32 value,
// cloc, rloc) for 2 flops; x is read through the read-only path and stays in
// L2 (4 MB at 1M columns), so the slot stream is the cost.  What held an
// earlier kernel at 0.28 of HBM was the collision handling before each shared
// atomic (a __match_any_sync and a shuffle tree on every slot: 355 µs against
// 159 with plain racy adds in kernel_probe.py --poh-spmv on the 1M-row power
// law, NVIDIA H100 80GB HBM3 at 700 W) and uneven blocks (a hub panel's
// 52-tile blocks against the median 13).
//
// What the design does about it:
// - Work pieces of about equal tile count (the plan's spmv_pieces, built
//   once with it: runs of at most ceil(ntiles / (16·132)) tiles of one
//   panel), largest first, one block each.
// - The block accumulates its panel's rows in an R-entry shared-memory
//   accumulator (R = 4096: 16 KB f32, 32 KB f64; above 48 KB the launch opts
//   in to more), then adds each nonzero row sum to y (zeroed by the wrapper)
//   with one global atomic: at most R atomics per block against T·tiles
//   slots.
// - Collisions are paid for only where they occur: each panel's two
//   heaviest rows (the plan's heavy_row table, built with it) sum in
//   registers per thread and reach the accumulator once per warp at the
//   end; every other slot goes straight to a shared atomic, with no match.
//   A power-law hub row fills up to 65 % of its panel's slots and the next
//   up to 32 %, and their atomics on one address serialise (1719 µs at 1M
//   rows with plain atomics and no match in the probe, 352 µs with the
//   heaviest row alone in registers); past the second row no
//   row of the power law holds more than 7 % of a panel's slots, two lanes
//   of a warp.
// - Slot loads are coalesced (lane i of a warp on slot i of a run of 32)
//   and streamed (evict-first, ld.global.cs), so they do not push x out of
//   L2; each thread loads U = 4 slots before it gathers, so several loads
//   are in flight.  Lanes on consecutive slots gather x at nearby columns
//   (a tile's slots are sorted by column), so a warp's gathers share
//   sectors: with four consecutive slots a thread (16-byte slot loads) they
//   spread over four times the sectors and cost 100 µs more in the probe.
//   Padding slots (value 0) are skipped: their shared atomics would all hit
//   row 0.
// - Indices are checked (0 <= rloc < R, 0 <= col < n), so a corrupt pack
//   cannot write outside the accumulator.
// Sums are taken in the working type; the atomics make their order vary
// from run to run (f32: within 1e-5 normwise of the plain twin).
//
// Half values or x (bf16 or f16, with the other the same half type or f32;
// the reference's single-pass branch, poh_kernels.py:440): each widens
// exactly to f32 as it loads, the products and sums are f32 and y is f32,
// as the reference's promote(values, x, f32).  A half slot is 10 bytes in
// place of 12.

#include <cuda_runtime.h>
#include <stdint.h>

#include "poh_common.cuh"
#include "value_types.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // slots in flight per thread
constexpr int kHeavy = 2;   // heavy rows per panel, summed in registers

template <typename A>
__device__ __forceinline__ void red_shared(A* p, A v) {
  atomicAdd(p, v);  // the result unused: a reduction, no return trip
}

template <typename V, typename X, typename A>
__global__ void __launch_bounds__(kThreads)
poh_spmv_kernel(const V* __restrict__ vals, const int* __restrict__ cloc,
                const int* __restrict__ rloc, const int* __restrict__ wlo,
                const int* __restrict__ pieces, const int* __restrict__ heavy,
                const X* __restrict__ x, A* __restrict__ y, int R, int C, int T_slots,
                int64_t m, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* acc = reinterpret_cast<A*>(smem_raw);
  const int I = __ldg(pieces + 4 * blockIdx.x);
  const int ta = __ldg(pieces + 4 * blockIdx.x + 1);
  const int tb = __ldg(pieces + 4 * blockIdx.x + 2);
  if (ta >= tb) return;  // nothing to add: y is zeroed by the wrapper
  // the panel's two heaviest rows, -1 for none
  const int h0 = __ldg(heavy + kHeavy * I), h1 = __ldg(heavy + kHeavy * I + 1);

  for (int r = threadIdx.x; r < R; r += kThreads) acc[r] = A(0);
  __syncthreads();

  A heavy_sum = A(0), heavy_sum1 = A(0);
  for (int t = ta; t < tb; ++t) {
    const int64_t base = static_cast<int64_t>(t) * T_slots;
    const int64_t col0 = static_cast<int64_t>(__ldg(wlo + t)) * C;
    for (int j0 = 0; j0 < T_slots; j0 += kThreads * kUnroll) {
      A v[kUnroll];
      int c[kUnroll], r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads + threadIdx.x;
        v[u] = A(0);
        c[u] = 0;
        r[u] = -1;
        if (j < T_slots) {
          v[u] = A(cask::widen(__ldcs(vals + base + j)));
          c[u] = __ldcs(cloc + base + j);
          r[u] = __ldcs(rloc + base + j);
        }
      }
      A xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t col = col0 + c[u];
        xv[u] = (v[u] != A(0) && col >= 0 && col < n) ? A(cask::widen(__ldg(x + col))) : A(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const A prod = v[u] * xv[u];
        if (r[u] == h0) {
          heavy_sum += prod;
        } else if (r[u] == h1) {
          heavy_sum1 += prod;
        } else if (v[u] != A(0) && r[u] >= 0 && r[u] < R) {
          red_shared(acc + r[u], prod);
        }
      }
    }
  }
  // the heavy rows: one shared atomic each per warp
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    heavy_sum += __shfl_xor_sync(0xffffffffu, heavy_sum, o);
    heavy_sum1 += __shfl_xor_sync(0xffffffffu, heavy_sum1, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (h0 >= 0 && h0 < R && heavy_sum != A(0)) red_shared(acc + h0, heavy_sum);
    if (h1 >= 0 && h1 < R && heavy_sum1 != A(0)) red_shared(acc + h1, heavy_sum1);
  }
  __syncthreads();

  // flush the nonzero row sums into y
  const int64_t row0 = static_cast<int64_t>(I) * R;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const A s = acc[r];
    if (s != A(0) && row0 + r < m) atomicAdd(y + row0 + r, s);
  }
}

template <typename V, typename X, typename A>
int launch(const void* vals, const int* cloc, const int* rloc, const int* wlo,
           const int* pieces, const int* heavy, const void* x, void* y, int n_pieces, int R,
           int C, int T_slots, long long m, long long n, void* stream) {
  const long long smem = static_cast<long long>(R) * sizeof(A);
  if (n_pieces < 1 || R < 1 || C < 1 || T_slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = poh::allow_smem(poh_spmv_kernel<V, X, A>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  poh_spmv_kernel<V, X, A><<<n_pieces, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vals), cloc, rloc, wlo, pieces, heavy, static_cast<const X*>(x),
      static_cast<A*>(y), R, C, T_slots, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/poh_kernels.py).
// All pointers are device pointers: vals/cloc/rloc (ntiles·T_slots), wlo
// (ntiles,), pieces (n_pieces, 4) rows (panel, first tile, end tile, cut) and
// heavy (n_panels, 2) int32 (-1: none); x (n,); y (m,),
// which must be zeroed before the launch (the kernel adds into it).  One
// entry per type combination, cask_poh_spmv_<values>_<x> (cask_poh_spmv_f32 /
// _f64 for one f32 or f64 type): y is f64 for f64, else f32 (the reference's
// promote(values, x, f32)).  The launch goes on `stream` and does not
// synchronise.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" {

#define CASK_POH_SPMV(name, V, X, A)                                                          \
  int name(const void* vals, const int* cloc, const int* rloc, const int* wlo,                \
           const int* pieces, const int* heavy, const void* x, void* y, int n_pieces, int R,  \
           int C, int T_slots, long long m, long long n, void* stream) {                      \
    return launch<V, X, A>(vals, cloc, rloc, wlo, pieces, heavy, x, y, n_pieces, R, C,        \
                           T_slots, m, n, stream);                                            \
  }

CASK_POH_SPMV(cask_poh_spmv_f32, float, float, float)
CASK_POH_SPMV(cask_poh_spmv_f64, double, double, double)
CASK_POH_SPMV(cask_poh_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16, float)
CASK_POH_SPMV(cask_poh_spmv_bf16_f32, __nv_bfloat16, float, float)
CASK_POH_SPMV(cask_poh_spmv_f32_bf16, float, __nv_bfloat16, float)
CASK_POH_SPMV(cask_poh_spmv_f16_f16, __half, __half, float)
CASK_POH_SPMV(cask_poh_spmv_f16_f32, __half, float, float)
CASK_POH_SPMV(cask_poh_spmv_f32_f16, float, __half, float)

#undef CASK_POH_SPMV

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
