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
// L2 (4 MB at 1M columns), so the slot stream is the cost.
//
// What the design does about it:
// - Tiles of one panel are contiguous (panel is non-decreasing), and the
//   plan's panel_ptr gives each panel's tile run.  A CTA takes 1/splits of
//   one panel's run: panels hold very different tile counts on power-law
//   matrices (62 to 259 at 1M rows), so splitting each panel keeps the
//   heaviest CTA small against the work per SM, where one CTA per panel
//   would leave the heaviest panel running alone at the end.
// - The CTA accumulates its rows in an R-entry shared-memory accumulator
//   with shared-memory atomics (R = 4096: 16 KB f32, 32 KB f64; above 48 KB
//   the launch opts in to more), then adds each nonzero row sum to y
//   (zeroed by the wrapper) with one global atomic: at most R atomics per
//   CTA against T·tiles slots.
// - Before its shared atomic, a warp sums the slots of one row among its 32
//   lanes (__match_any_sync and a shuffle tree), so one lane adds per row:
//   a power-law hub row fills most of its panel's slots, and their atomics
//   on one address serialised (1743 µs at 1M rows without this, on an
//   H100 80GB HBM3 at 700 W).
// - Slot loads are coalesced and streamed (evict-first, ld.global.cs), so
//   they do not push x out of L2; each thread loads U slots before it
//   gathers, so several loads are in flight.  Padding slots (value 0) are
//   skipped: their shared atomics would all hit row 0.
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

using poh::reduce_peers;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // slots in flight per thread

template <typename V, typename X, typename A>
__global__ void __launch_bounds__(kThreads)
poh_spmv_kernel(const V* __restrict__ vals, const int* __restrict__ cloc,
                const int* __restrict__ rloc, const int* __restrict__ wlo,
                const int* __restrict__ panel_ptr, const X* __restrict__ x,
                A* __restrict__ y, int splits, int R, int C, int T_slots, int64_t m,
                int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* acc = reinterpret_cast<A*>(smem_raw);
  const int I = blockIdx.x / splits;
  const int piece = blockIdx.x % splits;
  const int t_lo = __ldg(panel_ptr + I);
  const int nt = __ldg(panel_ptr + I + 1) - t_lo;
  const int ta = t_lo + static_cast<int>(static_cast<int64_t>(nt) * piece / splits);
  const int tb = t_lo + static_cast<int>(static_cast<int64_t>(nt) * (piece + 1) / splits);
  if (ta == tb) return;  // nothing to add: y is zeroed by the wrapper

  for (int r = threadIdx.x; r < R; r += kThreads) acc[r] = A(0);
  __syncthreads();

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
        r[u] = 0;
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
        // key: the row, or a key of its own for a padding or out-of-range slot
        const bool live = v[u] != A(0) && r[u] >= 0 && r[u] < R;
        const int key = live ? r[u] : -1 - static_cast<int>(threadIdx.x & 31);
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        A prod[1] = {v[u] * xv[u]};
        reduce_peers(peers, prod);
        if (live && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
          atomicAdd(acc + key, prod[0]);
        }
      }
    }
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(I) * R;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const A s = acc[r];
    if (s != A(0) && row0 + r < m) atomicAdd(y + row0 + r, s);
  }
}

template <typename V, typename X, typename A>
int launch(const void* vals, const int* cloc, const int* rloc, const int* wlo,
           const int* panel_ptr, const void* x, void* y, int n_panels, int splits, int R, int C,
           int T_slots, long long m, long long n, void* stream) {
  const long long smem = static_cast<long long>(R) * sizeof(A);
  if (n_panels < 1 || splits < 1 || R < 1 || C < 1 || T_slots < 1 ||
      static_cast<long long>(n_panels) * splits > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = poh::allow_smem(poh_spmv_kernel<V, X, A>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  poh_spmv_kernel<V, X, A>
      <<<n_panels * splits, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(vals), cloc, rloc, wlo, panel_ptr, static_cast<const X*>(x),
          static_cast<A*>(y), splits, R, C, T_slots, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/poh_kernels.py).
// All pointers are device pointers: vals/cloc/rloc (ntiles·T_slots), wlo
// (ntiles,) and panel_ptr (n_panels + 1,) int32; x (n,); y (m,), which must be
// zeroed before the launch (the kernel adds into it).  One entry per type
// combination, cask_poh_spmv_<values>_<x> (cask_poh_spmv_f32 / _f64 for one
// f32 or f64 type): y is f64 for f64, else f32 (the reference's
// promote(values, x, f32)).  The launch goes on `stream` and does not
// synchronise.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" {

#define CASK_POH_SPMV(name, V, X, A)                                                          \
  int name(const void* vals, const int* cloc, const int* rloc, const int* wlo,                \
           const int* panel_ptr, const void* x, void* y, int n_panels, int splits, int R,     \
           int C, int T_slots, long long m, long long n, void* stream) {                      \
    return launch<V, X, A>(vals, cloc, rloc, wlo, panel_ptr, x, y, n_panels, splits, R, C,    \
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
