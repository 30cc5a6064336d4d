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
// What the design does about it (PERF.md §5.11 takes it apart): a kernel
// that gives each block row a warp and loads each value with a scalar
// broadcast load (80 a block row on the 4×4 FEM plan) and each X row once
// per slot and component, one at a time, is held by its loads' latency,
// the value loads and the X loads about equally.  The staged kernel
// (bsr_spmm_staged_kernel), for X rows in 16-byte vectors and a bc of 1, 2,
// 4 or 8:
// - A block of 256 threads (64 for a half X) takes kTeams·turns
//   consecutive block rows and first stages their values (a block row's
//   br × K·bc values are contiguous in the pack) and their cols in shared
//   memory, the values with 16-byte cp.async copies (band_window.cuh).  A
//   row's bc values of a slot then come in one shared-memory vector read, a
//   broadcast to the team.
// - A team of lanes takes every kTeams-th of the block's rows in turn, so
//   at each turn the teams work on kTeams consecutive block rows, which
//   share the X rows of their near block columns in L1 (the probe measured
//   this faster than consecutive block rows a team).  Its lanes run over k,
//   16 bytes of an X row each: 4 f32 or 2 f64 columns, and 8 half columns,
//   so that a half X row is a 16-lane team's 128 columns, two block rows a
//   warp, in half the load instructions of an f32 row.
// - bc is a compile-time constant: the X rows of a slot's bc components
//   are loaded together, then used for every output row.
// A plan whose block rows do not fit kStageBytes, an X whose rows are not
// whole 16-byte vectors or a bc outside 1, 2, 4 and 8 take bsr_spmm_kernel:
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
// beside an f32 X, is each f32 sum rounded once at the store.  In
// bsr_spmm_kernel a half X moves 4 columns a lane in each 8-byte load, so a
// warp spans 128 columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_window.cuh"
#include "value_types.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kStageBytes = 48 * 1024;  // the most a staged block holds
constexpr int kMaxTurns = 4;  // block rows a team takes in turn, at most

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// the staged kernel's layout for an X type: 16 bytes of a row a lane, a
// team of lanes that spans 128 columns (a warp for an f64 X), and a block
// of 256 threads, 64 for a half X (the probe measured 64 fastest there and
// 256 for an f32 X); at most 128 registers a thread
template <typename X>
struct Team {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(X));
  static constexpr int kLanes = 128 / kVec < kWarp ? 128 / kVec : kWarp;
  static constexpr int kThreads = sizeof(X) == 2 ? 64 : 256;
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kTeams = kThreads / kLanes;
};

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

// V: value type, X: X type, O: output type (the values' type), summed in
// its working type A; BR: output rows of a block a thread sums (a block
// size above BR spreads its rows over gridDim.y); BC: the plan's bc.  The
// block takes kTeams·turns block rows from b0 on; team g those at
// b0 + u·kTeams + g, u < turns.  Shared memory holds their values,
// [block row][r < nr][slot·BC + c], then their cols, [block row][slot].
template <typename V, typename X, typename O, int BR, int BC>
__global__ void __launch_bounds__(Team<X>::kThreads, Team<X>::kMinBlocks)
bsr_spmm_staged_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
                       const X* __restrict__ Xm, O* __restrict__ Y, int K, int br,
                       int64_t m, int64_t n, int64_t nbr, int64_t packed, int k, int turns,
                       bool vals_vec) {
  using A = typename cask::Work<O>::type;
  constexpr int VEC = Team<X>::kVec;
  constexpr int kThreads = Team<X>::kThreads;
  constexpr int kA = static_cast<int>(sizeof(A) / 4);
  // X rows held at once: a slot's bc, CB components at a time (at most 32
  // registers)
  constexpr int CB = BC * VEC * kA <= 32 ? BC : 32 / (VEC * kA);
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.y * BR;
  const int nr = br - r0 < BR ? br - r0 : BR;  // rows of a block this block sums
  const int64_t kb = static_cast<int64_t>(K) * BC;
  const int len = nr * static_cast<int>(kb);  // staged values of a block row
  const int rows = Team<X>::kTeams * turns;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int n_rows = packed - b0 < rows ? static_cast<int>(packed - b0) : rows;
  V* vs = reinterpret_cast<V*>(smem);
  int* cs = reinterpret_cast<int*>(smem + (static_cast<size_t>(rows) * len * sizeof(V) + 15) / 16 * 16);
  cask::stage_spans<kThreads>(
      vs, [&](int s) { return vals + ((b0 + s) * br + r0) * kb; }, n_rows, len, len, vals_vec,
      threadIdx.x);
  for (int q = threadIdx.x; q < n_rows * K; q += kThreads) cs[q] = __ldg(cols + b0 * K + q);
  cask::cp_async_wait_all();
  __syncthreads();

  const int team = threadIdx.x / Team<X>::kLanes;
  const int lane = threadIdx.x % Team<X>::kLanes;
  const int nvec = k / VEC;
  for (int u = 0; u < turns; ++u) {
    const int tb = u * Team<X>::kTeams + team;  // the block row, within the block
    const int64_t bi = b0 + tb;
    if (bi >= nbr) break;
    const V* vb = vs + tb * len;
    const int* cb = cs + tb * K;
    for (int cv = lane; cv < nvec; cv += Team<X>::kLanes) {
      const X* xc = Xm + static_cast<int64_t>(cv) * VEC;
      A acc[BR][VEC];
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = A(0);
      for (int s = 0; s < K; ++s) {
#pragma unroll
        for (int c0 = 0; c0 < BC; c0 += CB) {
          // X rows cols[s]·BC + c0 + c; the zero pad rows n <= row < n_pad as 0
          const int64_t xrow0 = static_cast<int64_t>(cb[s]) * BC + c0;
          A xv[CB][VEC];
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            if (xrow0 + c < n) {
              cask::load_vec<X, VEC>(xc + (xrow0 + c) * k, xv[c]);
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) xv[c][e] = A(0);
            }
          }
#pragma unroll
          for (int r = 0; r < BR; ++r) {
            if (r < nr) {
              A a[CB];
              cask::load_span_shared<V, CB>(vb + r * kb + s * BC + c0, a);
#pragma unroll
              for (int c = 0; c < CB; ++c)
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[r][e] = fma_t(a[c], xv[c][e], acc[r][e]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int64_t row = bi * br + r0 + r;
        if (r < nr && row < m) {
          cask::store_vec<O, VEC>(Y + row * k + static_cast<int64_t>(cv) * VEC, acc[r]);
        }
      }
    }
  }
}

// the staged kernel, if the plan's block rows fit kStageBytes (the most
// block rows a team takes in turn that fit, up to kMaxTurns); returns -1
// where they do not
template <typename V, typename X, typename O, int BR, int BC>
int launch_staged(const V* vals, const int* cols, const X* Xm, O* Y, int64_t packed, int K,
                  int br, int64_t m, int64_t n, int64_t nbr, int k, cudaStream_t s) {
  const int nr = br < BR ? br : BR;
  const size_t row_bytes = static_cast<size_t>(nr) * K * BC * sizeof(V);
  int turns = kMaxTurns;
  auto bytes = [&](int t) {
    const size_t rows = static_cast<size_t>(Team<X>::kTeams) * t;
    return (rows * row_bytes + 15) / 16 * 16 + rows * K * sizeof(int);
  };
  while (turns > 1 && bytes(turns) > kStageBytes) turns /= 2;
  if (bytes(turns) > kStageBytes) return -1;
  const int64_t rows = static_cast<int64_t>(Team<X>::kTeams) * turns;
  const int64_t blocks = (nbr + rows - 1) / rows;
  if (blocks > 0x7fffffff) return -1;
  // every block row's span starts 16-byte aligned and is whole 16-byte pieces
  const size_t kb_bytes = static_cast<size_t>(K) * BC * sizeof(V);
  const bool vals_vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0 && (br * kb_bytes) % 16 == 0 &&
                        (br <= BR || kb_bytes % 16 == 0);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((br + BR - 1) / BR));
  bsr_spmm_staged_kernel<V, X, O, BR, BC><<<grid, Team<X>::kThreads, bytes(turns), s>>>(
      vals, cols, Xm, Y, K, br, m, n, nbr, packed, k, turns, vals_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, typename O, int BR>
int launch_staged_bc(const V* vals, const int* cols, const X* Xm, O* Y, int64_t packed, int K,
                     int br, int bc, int64_t m, int64_t n, int64_t nbr, int k, cudaStream_t s) {
  if (bc == 1) return launch_staged<V, X, O, BR, 1>(vals, cols, Xm, Y, packed, K, br, m, n, nbr, k, s);
  if (bc == 2) return launch_staged<V, X, O, BR, 2>(vals, cols, Xm, Y, packed, K, br, m, n, nbr, k, s);
  if (bc == 4) return launch_staged<V, X, O, BR, 4>(vals, cols, Xm, Y, packed, K, br, m, n, nbr, k, s);
  if (bc == 8) return launch_staged<V, X, O, BR, 8>(vals, cols, Xm, Y, packed, K, br, m, n, nbr, k, s);
  return -1;
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
  if (vec && k % Team<X>::kVec == 0) {
    const int64_t packed = T_groups * G;  // block rows in the pack
    int err = -1;
    if (br <= 1) err = launch_staged_bc<V, X, V, 1>(vals, cols, Xm, Y, packed, K, br, bc, m, n, nbr, k, s);
    else if (br <= 2) err = launch_staged_bc<V, X, V, 2>(vals, cols, Xm, Y, packed, K, br, bc, m, n, nbr, k, s);
    else if (br <= 4) err = launch_staged_bc<V, X, V, 4>(vals, cols, Xm, Y, packed, K, br, bc, m, n, nbr, k, s);
    else err = launch_staged_bc<V, X, V, 8>(vals, cols, Xm, Y, packed, K, br, bc, m, n, nbr, k, s);
    if (err >= 0) return err;
  }
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
