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
// What bounds it: the X gathers.  The function needs the slot arrays once
// (12 bytes per f32 slot), X once and Y once, but each nonzero reads its own
// X row (128 bytes at k = 32 f32), from rows all over X, which (134 MB at 1M
// rows) does not fit in L2: 3 GB of gathered rows on the 1M-row power law.
// The card serves such gathers at its best as whole rows, many in flight.
//
// What the design does about it:
// - Lanes over columns, whole rows: a block takes KC columns (up to 32 f32
//   or 16 f64, 128 bytes of an X row) and a group of KC lanes takes one
//   slot, each lane one column, so a slot's gather is one coalesced run of
//   its X row, read once for all KC columns.
// - Row parts: the block's R × KC partial sums live in shared memory, in
//   what the queues leave of the 227 KB, so a wide KC splits the panel's
//   rows into `parts` (3 at R = 4096, KC = 32 f32).  Each part's block walks all the
//   slots of its piece and keeps those of its rows; the parts and column
//   chunks of one piece are neighbouring blocks, so the slot stream comes
//   from HBM once and from L2 for the others, and every X row is gathered
//   by one block per column chunk.
// - Many gathers in flight: a warp takes 128 slots at a time (one load per
//   lane and array, coalesced), keeps the live ones of its rows in a queue
//   in shared memory (ballots, no atomics), and then gathers up to U queue
//   entries per group at once; the next 128 slots load meanwhile.  No block
//   barrier stands between the batches of a warp.
// - Each group sums the entries of one row within its run of the queue in
//   registers before one shared-memory atomic (a power-law hub row fills
//   most of its panel's slots).
// - Work is cut into pieces: runs of at most about the mean tile count of
//   one panel (spmm_pieces in ops/kernels/poh_kernels.py, computed once per
//   plan on the host), so a hub panel's 4x the mean tiles do not run alone
//   at the end.  An uncut panel stores its block of Y (every row below m
//   and column of the chunk, zeros included).  The pieces of a cut panel
//   add their nonzero partial sums into Y with global atomics; the wrapper
//   zeroes Y when the plan has cut panels.
// - Indices are checked (0 <= rloc < R, 0 <= col < n): a slot outside is
//   dropped.
// Sums are in the working type, in an order that the atomics vary from run
// to run.
//
// Half values or X (bf16 or f16, with the other the same half type or f32;
// the reference's single-pass branch, poh_kernels.py:562): the kernel is
// the same, templated on the value, X and working types.  Each value and
// X element widens exactly to f32 as it loads, the queue, the partial sums
// and Y are f32 (the reference's promote(values, X, f32)), and a group
// gathers 2 bytes of each X row per lane: 64 bytes a slot at k = 32, half
// the f32 kernel's gathered bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "poh_common.cuh"
#include "value_types.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 128;             // slots a warp sifts at a time
constexpr int kPerLane = kBatch / 32;

template <typename V, typename X_t, typename T, int KC>
__global__ void __launch_bounds__(kThreads, 1)
poh_spmm_kernel(const V* __restrict__ vals, const int* __restrict__ cloc,
                const int* __restrict__ rloc, const int* __restrict__ wlo,
                const int* __restrict__ pieces, const X_t* __restrict__ X, T* __restrict__ Y,
                int parts, int kchunks, int R, int RP, int C, int T_slots, int64_t m, int64_t n,
                int k, int acc_bytes) {
  constexpr int G = 32 / KC;  // groups of KC lanes in a warp, one queue entry each
  // queue entries a group gathers at once: as many as 64 registers a
  // thread hold without spilling
  constexpr int U = sizeof(T) == 4 && KC > 1 ? 8 : 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);         // acc[(row - rp0)·KC + column]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's queue of live slots: value, row within the part, X row
  T* qv = reinterpret_cast<T*>(smem_raw + acc_bytes) + warp * kBatch;
  int* qr = reinterpret_cast<int*>(smem_raw + acc_bytes + kWarps * kBatch * sizeof(T)) +
            warp * kBatch;
  int* qc = qr + kWarps * kBatch;

  const int chunk = blockIdx.x % kchunks;
  const int part = (blockIdx.x / kchunks) % parts;
  const int piece = blockIdx.x / (kchunks * parts);
  const int I = __ldg(pieces + 4 * piece);
  const int ta = __ldg(pieces + 4 * piece + 1);
  const int tb = __ldg(pieces + 4 * piece + 2);
  const bool cut = __ldg(pieces + 4 * piece + 3) != 0;
  const int c0 = chunk * KC;
  const int rp0 = part * RP;
  const int rows = max(0, min(R, rp0 + RP) - rp0);  // this part's rows

  const int grp = lane / KC;  // the lane's group
  const int cl = lane % KC;   // and its column in the chunk
  const bool col_ok = c0 + cl < k;
  const unsigned below = (1u << lane) - 1u;

  for (int i = threadIdx.x; i < rows * KC; i += kThreads) acc[i] = T(0);
  __syncthreads();

  // batches of kBatch slots (T_slots is a multiple of kBatch: a batch lies
  // in one tile); warp w takes batches w, w + kWarps, ...
  const int per_tile = T_slots / kBatch;
  const int nb = (tb - ta) * per_tile;
  const int64_t base = static_cast<int64_t>(ta) * T_slots;
  T v[kPerLane];
  int r[kPerLane], c[kPerLane];
  int64_t col0 = 0;
  auto fetch = [&](int b) {
    if (b >= nb) return;
    const int64_t s = base + static_cast<int64_t>(b) * kBatch + lane;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      v[i] = T(cask::widen(__ldg(vals + s + 32 * i)));
      r[i] = __ldg(rloc + s + 32 * i);
      c[i] = __ldg(cloc + s + 32 * i);
    }
    col0 = static_cast<int64_t>(__ldg(wlo + ta + b / per_tile)) * C;
  };

  fetch(warp);
  for (int b = warp; b < nb; b += kWarps) {
    // sift: the batch's live slots of this part, in slot order, to the queue
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int64_t col = col0 + c[i];
      const bool live = v[i] != T(0) && r[i] >= rp0 && r[i] < rp0 + rows && col >= 0 && col < n;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int pos = cnt + __popc(mask & below);
        qv[pos] = v[i];
        qr[pos] = r[i] - rp0;
        qc[pos] = static_cast<int>(col);
      }
      cnt += __popc(mask);
    }
    __syncwarp();
    fetch(b + kWarps);  // the next batch's slots load while this one gathers

    for (int s0 = 0; s0 < cnt; s0 += G * U) {
      const int e0 = s0 + grp * U;  // the group's run of the queue
      T x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // all U gathers in flight together
        const int e = e0 + u;
        x[u] = e < cnt && col_ok
                   ? T(cask::widen(__ldg(X + static_cast<int64_t>(qc[e]) * k + c0 + cl)))
                   : T(0);
      }
      // a run of one row is summed in registers and added once it ends; no
      // branch leaves the loop, so the entries' loads and products overlap
      int key = -1;
      T sum = T(0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u;
        const bool ok = e < cnt;
        const int row = ok ? qr[e] : -1;
        if (row != key && key >= 0 && col_ok) atomicAdd(acc + key * KC + cl, sum);
        sum = row != key ? T(0) : sum;
        key = row;
        if (ok) sum += qv[e] * x[u];
      }
      if (key >= 0 && col_ok) atomicAdd(acc + key * KC + cl, sum);
    }
    __syncwarp();  // the queue is read before the next batch overwrites it
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(I) * R + rp0;
  for (int i = threadIdx.x; i < rows * KC; i += kThreads) {
    const int rr = i / KC, cc = i % KC;
    if (row0 + rr >= m || c0 + cc >= k) continue;
    T* y = Y + (row0 + rr) * k + c0 + cc;
    if (!cut) {
      *y = acc[i];
    } else if (acc[i] != T(0)) {
      atomicAdd(y, acc[i]);
    }
  }
}

template <typename V, typename X, typename T, int KC>
int launch_kc(const V* vals, const int* cloc, const int* rloc, const int* wlo, const int* pieces,
              const X* Xm, T* Y, int n_pieces, int R, int C, int T_slots, long long m,
              long long n, int k, cudaStream_t s) {
  // the partial sums take what the queues leave of a block's shared memory
  const long long queues = static_cast<long long>(kWarps) * kBatch * (sizeof(T) + 8);
  const long long budget = (poh::kMaxSmem - queues) / 128 * 128;
  const long long row_bytes = static_cast<long long>(KC) * sizeof(T);
  const int parts = static_cast<int>((R * row_bytes + budget - 1) / budget);
  const int RP = (R + parts - 1) / parts;
  const int kchunks = (k + KC - 1) / KC;
  const int acc_bytes = static_cast<int>((RP * row_bytes + 127) / 128 * 128);
  const long long smem = acc_bytes + queues;
  if (static_cast<long long>(n_pieces) * parts * kchunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = poh::allow_smem(poh_spmm_kernel<V, X, T, KC>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  poh_spmm_kernel<V, X, T, KC><<<n_pieces * parts * kchunks, kThreads, smem, s>>>(
      vals, cloc, rloc, wlo, pieces, Xm, Y, parts, kchunks, R, RP, C, T_slots, m, n, k,
      acc_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, typename T>
int dispatch(const void* vals_p, const int* cloc, const int* rloc, const int* wlo,
             const int* pieces, const void* X_p, void* Y_p, int n_pieces, int R, int C,
             int T_slots, long long m, long long n, int k, void* stream) {
  if (n_pieces < 1 || R < 1 || C < 1 || T_slots < 1 || T_slots % kBatch || k < 1 ||
      n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const V* vals = static_cast<const V*>(vals_p);
  const X* Xm = static_cast<const X*>(X_p);
  T* Y = static_cast<T*>(Y_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the narrowest power-of-two chunk that holds k, up to 128 bytes of an X
  // row and 32 columns (32 f32 or half, 16 f64); wider k takes several chunks
  int kc = 1;
  while (kc < k && kc < 32 && kc * static_cast<int>(sizeof(X)) < 128) kc *= 2;
  if constexpr (sizeof(X) <= 4) {
    if (kc == 32) return launch_kc<V, X, T, 32>(vals, cloc, rloc, wlo, pieces, Xm, Y, n_pieces, R, C, T_slots, m, n, k, s);
  }
  switch (kc) {
    case 16: return launch_kc<V, X, T, 16>(vals, cloc, rloc, wlo, pieces, Xm, Y, n_pieces, R, C, T_slots, m, n, k, s);
    case 8: return launch_kc<V, X, T, 8>(vals, cloc, rloc, wlo, pieces, Xm, Y, n_pieces, R, C, T_slots, m, n, k, s);
    case 4: return launch_kc<V, X, T, 4>(vals, cloc, rloc, wlo, pieces, Xm, Y, n_pieces, R, C, T_slots, m, n, k, s);
    case 2: return launch_kc<V, X, T, 2>(vals, cloc, rloc, wlo, pieces, Xm, Y, n_pieces, R, C, T_slots, m, n, k, s);
    default: return launch_kc<V, X, T, 1>(vals, cloc, rloc, wlo, pieces, Xm, Y, n_pieces, R, C, T_slots, m, n, k, s);
  }
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/poh_kernels.py).
// All pointers are device pointers: vals/cloc/rloc (ntiles·T_slots), wlo
// (ntiles,) and pieces (n_pieces, 4) int32 rows (panel, first tile, end
// tile, cut); X (n, k) and Y (m, k) row-major.  One entry per type
// combination, cask_poh_spmm_<values>_<X> (cask_poh_spmm_f32 / _f64 for one
// f32 or f64 type): Y is f64 for f64, else f32.  Every piece of a panel
// covers the panel's rows; Y must be zeroed when some piece is cut, and
// every element of Y is written otherwise.  T_slots is a multiple of 128.
// The launch goes on `stream` and does not synchronise.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" {

#define CASK_POH_SPMM(name, V, X, T)                                                          \
  int name(const void* vals, const int* cloc, const int* rloc, const int* wlo,                \
           const int* pieces, const void* X_, void* Y, int n_pieces, int R, int C,            \
           int T_slots, long long m, long long n, int k, void* stream) {                      \
    return dispatch<V, X, T>(vals, cloc, rloc, wlo, pieces, X_, Y, n_pieces, R, C, T_slots,   \
                             m, n, k, stream);                                                \
  }

CASK_POH_SPMM(cask_poh_spmm_f32, float, float, float)
CASK_POH_SPMM(cask_poh_spmm_f64, double, double, double)
CASK_POH_SPMM(cask_poh_spmm_bf16_bf16, __nv_bfloat16, __nv_bfloat16, float)
CASK_POH_SPMM(cask_poh_spmm_bf16_f32, __nv_bfloat16, float, float)
CASK_POH_SPMM(cask_poh_spmm_f32_bf16, float, __nv_bfloat16, float)
CASK_POH_SPMM(cask_poh_spmm_f16_f16, __half, __half, float)
CASK_POH_SPMM(cask_poh_spmm_f16_f32, __half, float, float)
CASK_POH_SPMM(cask_poh_spmm_f32_f16, float, __half, float)

#undef CASK_POH_SPMM

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
