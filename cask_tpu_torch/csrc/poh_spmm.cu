// POH SpMM on Hopper (sm_90a): Y = A·X on the panel one-hot pack (PohMatrix),
// with X (n, k) and Y (m, k) dense and row-major, any k >= 1.
//
// Replaces the TPU kernel
//   cask_tpu/ops/pallas/poh_kernels.py:538  poh_spmm_pallas (B17; body _poh_spmm_kernel :462)
// which computes, for every tile t, slot j and column c < k,
//   Y[panel[t]·R + rloc[t, j], c] += vals[t, j] · X[wlo[t]·C + cloc[t, j], c]
// (rows >= m dropped, X rows >= n read as 0; padding slots hold value 0).  The
// reference gathers and scatters with one-hot MXU products (bf16 hi/lo
// pairs) and takes k <= 64 per call, a VMEM bound.  This kernel gathers X
// rows directly and sums with FP32 (or FP64) FMAs: exact-class, any k.
//
// What bounds it: bytes.  The function needs the slot arrays once (12 bytes
// per f32 slot), X once and Y once; at k = 32 each slot gathers 128 bytes of
// X, and X (134 MB at 1M rows) does not fit in L2, so the X gathers, at
// 32-byte sector granularity, are the real stream.
//
// What the design does about it:
// - One CTA per (panel, chunk of KC columns).  The panel's R × KC partial
//   sums live in shared memory (KC chosen so they take at most 64 KB: at
//   R = 4096, 4 f32 or 2 f64 columns), filled with shared-memory atomics.
//   R·k does not fit in shared memory at k = 32 (512 KB), hence the column
//   chunks.  At the end the CTA stores its block of Y: every row of the
//   panel below m and every column of the chunk, zeros included, so Y needs
//   no zeroing and no global atomics.
// - The column chunks of one panel are neighbouring blocks (the chunk index
//   varies fastest), so they run at about the same time and the panel's
//   slot arrays come from HBM once and from L2 for the other chunks.
// - Slot loads are coalesced; each slot's KC X values are contiguous in a
//   row of X.  Padding slots (value 0) add nothing.
// - Before the shared atomics, a warp sums the KC products of the slots of
//   one row among its 32 lanes (__match_any_sync and a shuffle tree), so
//   one lane adds per row: a power-law hub row fills most of its panel's
//   slots, and their atomics on one address serialised (19.1 ms at 1M rows,
//   k = 32, without this, on an H100 80GB HBM3 at 700 W).
// - Indices are checked (0 <= rloc < R, 0 <= col < n).
// Unlike SpMV, one CTA per panel: a panel's tile count varies (62 to 259 at
// 1M rows), but with k/KC chunks per panel there are several CTAs per SM to
// balance.  Sums are in the working type, in an order that the shared
// atomics vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "poh_common.cuh"

namespace {

using poh::reduce_peers;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kChunkBudget = 64 * 1024;  // shared bytes the KC choice aims under

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
poh_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ cloc,
                const int* __restrict__ rloc, const int* __restrict__ wlo,
                const int* __restrict__ panel_ptr, const T* __restrict__ X,
                T* __restrict__ Y, int kchunks, int R, int C, int T_slots, int64_t m,
                int64_t n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // acc[r·KC + c]
  const int I = blockIdx.x / kchunks;
  const int c0 = (blockIdx.x % kchunks) * KC;
  const int ta = __ldg(panel_ptr + I);
  const int tb = __ldg(panel_ptr + I + 1);

  for (int i = threadIdx.x; i < R * KC; i += kThreads) acc[i] = T(0);
  __syncthreads();

  for (int t = ta; t < tb; ++t) {
    const int64_t base = static_cast<int64_t>(t) * T_slots;
    const int64_t col0 = static_cast<int64_t>(__ldg(wlo + t)) * C;
    for (int j0 = 0; j0 < T_slots; j0 += kThreads * kUnroll) {
      T v[kUnroll];
      int64_t col[kUnroll];
      int r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads + threadIdx.x;
        v[u] = T(0);
        col[u] = 0;
        r[u] = 0;
        if (j < T_slots) {
          v[u] = __ldg(vals + base + j);
          col[u] = col0 + __ldg(cloc + base + j);
          r[u] = __ldg(rloc + base + j);
        }
        if (col[u] < 0 || col[u] >= n || r[u] < 0 || r[u] >= R) v[u] = T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // key: the row, or a key of its own for a padding or out-of-range slot
        const bool live = v[u] != T(0);
        const int key = live ? r[u] : -1 - static_cast<int>(threadIdx.x & 31);
        T prod[KC];
        const T* xr = X + col[u] * k + c0;
#pragma unroll
        for (int c = 0; c < KC; ++c) prod[c] = (live && c0 + c < k) ? v[u] * __ldg(xr + c) : T(0);
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        reduce_peers(peers, prod);
        if (live && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
#pragma unroll
          for (int c = 0; c < KC; ++c) atomicAdd(acc + key * KC + c, prod[c]);
        }
      }
    }
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(I) * R;
  for (int i = threadIdx.x; i < R * KC; i += kThreads) {
    const int r = i / KC, c = i % KC;
    if (row0 + r < m && c0 + c < k) Y[(row0 + r) * k + c0 + c] = acc[i];
  }
}

template <typename T, int KC>
int launch_kc(const T* vals, const int* cloc, const int* rloc, const int* wlo,
              const int* panel_ptr, const T* X, T* Y, int n_panels, int R, int C,
              int T_slots, long long m, long long n, int k, cudaStream_t s) {
  const int kchunks = (k + KC - 1) / KC;
  const long long smem = static_cast<long long>(R) * KC * sizeof(T);
  if (static_cast<long long>(n_panels) * kchunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = poh::allow_smem(poh_spmm_kernel<T, KC>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  poh_spmm_kernel<T, KC><<<n_panels * kchunks, kThreads, smem, s>>>(
      vals, cloc, rloc, wlo, panel_ptr, X, Y, kchunks, R, C, T_slots, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* vals, const int* cloc, const int* rloc, const int* wlo,
             const int* panel_ptr, const T* X, T* Y, int n_panels, int R, int C, int T_slots,
             long long m, long long n, int k, void* stream) {
  if (n_panels < 1 || R < 1 || C < 1 || T_slots < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest power-of-two chunk, up to 16 columns, whose partial sums fit
  // the budget and that k fills at least half of
  const long long row_bytes = static_cast<long long>(R) * sizeof(T);
  int kc = 16;
  while (kc > 1 && (kc * row_bytes > kChunkBudget || kc / 2 >= k)) kc /= 2;
  switch (kc) {
    case 16: return launch_kc<T, 16>(vals, cloc, rloc, wlo, panel_ptr, X, Y, n_panels, R, C, T_slots, m, n, k, s);
    case 8: return launch_kc<T, 8>(vals, cloc, rloc, wlo, panel_ptr, X, Y, n_panels, R, C, T_slots, m, n, k, s);
    case 4: return launch_kc<T, 4>(vals, cloc, rloc, wlo, panel_ptr, X, Y, n_panels, R, C, T_slots, m, n, k, s);
    case 2: return launch_kc<T, 2>(vals, cloc, rloc, wlo, panel_ptr, X, Y, n_panels, R, C, T_slots, m, n, k, s);
    default: return launch_kc<T, 1>(vals, cloc, rloc, wlo, panel_ptr, X, Y, n_panels, R, C, T_slots, m, n, k, s);
  }
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/poh_kernels.py).
// All pointers are device pointers: vals/cloc/rloc (ntiles·T_slots), wlo
// (ntiles,) and panel_ptr (n_panels + 1,) int32; X (n, k) and Y (m, k)
// row-major.  Every element of Y is written.  The launch goes on `stream`
// and does not synchronise.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" {

int cask_poh_spmm_f32(const float* vals, const int* cloc, const int* rloc, const int* wlo,
                      const int* panel_ptr, const float* X, float* Y, int n_panels, int R,
                      int C, int T_slots, long long m, long long n, int k, void* stream) {
  return dispatch<float>(vals, cloc, rloc, wlo, panel_ptr, X, Y, n_panels, R, C, T_slots, m,
                         n, k, stream);
}

int cask_poh_spmm_f64(const double* vals, const int* cloc, const int* rloc, const int* wlo,
                      const int* panel_ptr, const double* X, double* Y, int n_panels, int R,
                      int C, int T_slots, long long m, long long n, int k, void* stream) {
  return dispatch<double>(vals, cloc, rloc, wlo, panel_ptr, X, Y, n_panels, R, C, T_slots, m,
                          n, k, stream);
}

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
