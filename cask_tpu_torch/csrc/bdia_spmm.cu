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
// balance.  A kernel that walks the pairs one X row at a time, each followed
// by br one-value loads and its dependent products, keeps one load in
// flight a warp and is held by latency, not bytes.
//
// What the design does about it (PERF.md §5.9-5.10 take it apart):
// - A block covers 8·RB consecutive block rows inside one tile of the
//   pack; it stages their values, vals[r, t, j, those rows] for its output
//   rows r and every pair j (contiguous spans), in shared memory with
//   16-byte cp.async copies before any product, so each value crosses HBM
//   once and the products read it as a broadcast from shared memory.
// - A warp owns RB of the block rows × the block's rows (at most 8, a block
//   size above 8 spreads its rows over gridDim.y); its lanes run over k,
//   one column vector each (16 bytes of f32 or f64, 8 bytes of a half X:
//   4 values), so an X row is one coalesced warp load.  The RB·br sums stay
//   in registers: RB = 4 for 4×4 blocks (block_rows sizes it).
// - The plan's block offsets are walked in chunks of at most two
//   consecutive offsets (band_window.cuh; the FEM plan's −512 | −1, 0 | 1 |
//   512).  For each chunk of len offsets and each column component c the
//   window of RB + len − 1 X rows ((i0 + off + w)·bc + c) is loaded once
//   into registers, and every block row it reaches uses it.
// - X rows outside [0, n) read as zero, as in the twin's zero-padded X;
//   rows i·br + r at or beyond m are not written, so rectangular plans work
//   either way.
// - Sums are taken in the output type's working type, chunk by chunk in
//   the plan's offset order, a chunk's pairs component by component (the
//   twin's pair order within each component).
// - bf16 and f16 (value_types.cuh), the reference's half value paths and
//   their fully-half chains (bdia_kernels.py:607-611): values and X are
//   each H or f32 for one half type H, at least one H, widened exactly in
//   registers and summed in f32; Y is f32 or H (by default f16 for f16
//   values and X, else f32), H rounded once at the store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_window.cuh"
#include "value_types.cuh"

namespace {

constexpr int kMaxDiags = 80;  // block offsets a plan may hold (the pair cap)
constexpr int kThreads = 256;
constexpr int kWarp = 32;

struct DiagOffsets {
  int d[kMaxDiags];
};

// block offsets a chunk takes at most
constexpr int kChunk = 2;

// block rows a warp owns: the most (a power of two, at most 8) whose RB·BR
// (at most 16) output rows of VEC sums and window of RB + kChunk − 1 column
// vectors fit 84 registers, and whose block's staged values (8·RB block
// rows × BR rows × at most 80 pairs) fit 40 KB of shared memory
template <int BR, int VEC, typename A, typename V>
__host__ __device__ constexpr int block_rows() {
  constexpr int a = static_cast<int>(sizeof(A) / 4);
  int r = 8;
  while (r > 1 && (r * BR > 16 || (r * BR + r + kChunk - 1) * VEC * a > 84 ||
                   r * BR * static_cast<int>(sizeof(V)) > 64)) {
    r /= 2;
  }
  return r;
}

// V: value type; X: X type; O: output type, summed in its working type A;
// BR: output rows of a block a thread sums (a block size above BR spreads
// its rows over gridDim.y).  A block covers kTile = kWarps·RB consecutive
// block rows (inside one tile of the pack); their values for its BR rows
// and every pair are staged in shared memory first.
template <typename V, typename X, typename O, int VEC, int BR>
__global__ void __launch_bounds__(kThreads, 2)
bdia_spmm_kernel(const V* __restrict__ vals, const X* __restrict__ Xm, O* __restrict__ Y,
                 const DiagOffsets offs, int ndiag, int br, int bc, int64_t m, int64_t n,
                 int64_t nbr, int n_tiles, int tile, int k, bool vals_vec) {
  using A = typename cask::Work<O>::type;
  constexpr int RB = block_rows<BR, VEC, A, V>();
  constexpr int C = kChunk;
  constexpr int W = RB + C - 1;  // window rows of a full chunk, per component
  constexpr int kWarps = kThreads / kWarp;
  constexpr int kTile = kWarps * RB;
  extern __shared__ __align__(16) unsigned char smem[];
  V* sv = reinterpret_cast<V*>(smem);  // [r][j][kTile]
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int warp = threadIdx.x / kWarp;
  const int64_t i0 = b0 + warp * RB;
  const int lane = threadIdx.x % kWarp;
  const int r0 = blockIdx.y * BR;
  const int nr = br - r0 < BR ? br - r0 : BR;  // rows of the block this block sums
  const int64_t t = b0 / tile;
  const int npairs = ndiag * bc;
  // vals[r, t, j, s, l] lives at ((r·T + t)·npairs + j)·tile + (i − t·tile)
  const int64_t r_stride = static_cast<int64_t>(n_tiles) * npairs * tile;
  const V* v0 = vals + (static_cast<int64_t>(r0) * n_tiles + t) * npairs * tile + (b0 - t * tile);
  cask::stage_spans<kThreads>(
      sv, [&](int s) { return v0 + (s / npairs) * r_stride + static_cast<int64_t>(s % npairs) * tile; },
      nr * npairs, kTile, kTile, vals_vec, threadIdx.x);
  cask::cp_async_wait_all();
  __syncthreads();
  if (i0 >= nbr) return;
  const int nvec = k / VEC;

  for (int cv = lane; cv < nvec; cv += kWarp) {
    const X* xc = Xm + static_cast<int64_t>(cv) * VEC;
    A acc[RB][BR][VEC];
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[q][r][e] = A(0);
    for (int dp = 0; dp < ndiag;) {
      int o[C];
#pragma unroll
      for (int e = 0; e < C; ++e) o[e] = dp + e < ndiag ? offs.d[dp + e] : 0;
      const int len = cask::chunk_length<C>(o, ndiag - dp);
      for (int c = 0; c < bc; ++c) {
        // the window: X rows (i0 + o[0] + w)·bc + c, w < RB + len − 1
        A xw[W][VEC];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int64_t col = (i0 + o[0] + w) * bc + c;
          if (w < RB + len - 1 && col >= 0 && col < n) {
            cask::load_vec<X, VEC>(xc + col * k, xw[w]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) xw[w][e] = A(0);
          }
        }
#pragma unroll
        for (int dd = 0; dd < C; ++dd) {
          if (dd < len) {
            const V* vj = sv + ((dp + dd) * bc + c) * kTile + warp * RB;
#pragma unroll
            for (int r = 0; r < BR; ++r) {
              if (r < nr) {
                A v[RB];
                cask::load_span_shared<V, RB>(vj + r * npairs * kTile, v);
#pragma unroll
                for (int q = 0; q < RB; ++q)
#pragma unroll
                  for (int e = 0; e < VEC; ++e)
                    acc[q][r][e] = cask::fma_t(v[q], xw[q + dd][e], acc[q][r][e]);
              }
            }
          }
        }
      }
      dp += len;
    }
#pragma unroll
    for (int q = 0; q < RB; ++q) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int64_t row = (i0 + q) * br + r0 + r;
        if (i0 + q < nbr && r < nr && row < m) {
          cask::store_vec<O, VEC>(Y + row * k + static_cast<int64_t>(cv) * VEC, acc[q][r]);
        }
      }
    }
  }
}

template <typename V, typename X, typename O, int VEC, int BR>
int launch_rb(const V* vals, const X* Xm, O* Y, const DiagOffsets& offs, int ndiag, int br,
              int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles, int tile, int k,
              cudaStream_t s) {
  constexpr int RB = block_rows<BR, VEC, typename cask::Work<O>::type, V>();
  constexpr int kTile = kThreads / kWarp * RB;
  const int64_t blocks = (nbr + kTile - 1) / kTile;
  if (blocks > 0x7fffffff || tile % kTile) return static_cast<int>(cudaErrorInvalidValue);
  // every span vals[r, t, j, kTile rows] starts at a multiple of kTile
  // elements, kTile·sizeof(V) a multiple of 16 bytes
  const bool vals_vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                        (kTile * sizeof(V)) % 16 == 0;
  const int rows = br < BR ? br : BR;
  const size_t smem = static_cast<size_t>(rows) * ndiag * bc * kTile * sizeof(V);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((br + BR - 1) / BR));
  bdia_spmm_kernel<V, X, O, VEC, BR><<<grid, kThreads, smem, s>>>(
      vals, Xm, Y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, k, vals_vec);
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
