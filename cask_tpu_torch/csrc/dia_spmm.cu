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
// byte, far below the card's FP32 balance.  A kernel that loads X[i + off]
// once per row and diagonal moves ndiags X rows per output row through L2:
// on the FEM matrix's 29 diagonals at k = 128 that is 15.6 GB a call, and
// the L2, not HBM, sets its time.
//
// What the design does about it (PERF.md §5.9-5.10 take it apart):
// - A block covers kTile = (256 / TPR)·8 consecutive rows.  It stages their
//   values, vals[d, r0 : r0 + kTile] (contiguous per diagonal), in shared
//   memory with 16-byte cp.async copies, up to 32 KB of diagonals at a time,
//   and loads its first X window while they arrive: each value crosses HBM
//   once and the products read it with 16-byte shared loads, one address
//   for a row group.
// - Each thread owns kRows = 8 consecutive rows × one column vector (16
//   bytes of f32 or f64, 8 bytes of a half X: 4 values) and walks the plan's
//   diagonals in chunks of consecutive offsets (band_window.cuh; at most 8,
//   4 for f64).  For a chunk of len diagonals it loads the window of
//   kRows + len − 1 X rows once into registers and makes all kRows·len
//   products from it: on the FEM plan (runs of 7, 15 and 7 offsets) 57 X
//   loads per 8 rows where a load per diagonal makes 232.  Scattered offsets
//   make chunks of one: 8 loads for 8 products, no more than before.
// - A row group's TPR threads (a power of two up to 32, the least that
//   covers k) own its column vectors: an X row is one coalesced load of the
//   group; Y is written once with streaming stores (__stcs).  Vector loads
//   and stores where k is a multiple of the vector width and X, Y are
//   16-byte aligned, scalar ones otherwise.
// - The offsets are a small int32 device array that the plan builds once,
//   read as a broadcast; any diagonal count is taken, in any order (a chunk
//   is a stretch of entries whose offsets rise by one).
// - X rows outside [0, n) read as zero, as in the twin's zero-padded X.  Rows
//   m <= i < m_pad are never written, and m != n works.
// - Sums are taken in the working type, in offsets order, the order of the
//   plain PyTorch twin.
// - bf16 and f16 (value_types.cuh), the reference's half value paths and
//   their fully-half chains (dia_kernels.py:1026-1033): values and X are
//   each H or f32 for one half type H, at least one H, widened exactly in
//   registers and summed in f32; Y is f32 or H (by default f16 for f16
//   values and X, else f32), H rounded once at the store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_window.cuh"
#include "value_types.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // consecutive rows a thread owns
constexpr int kStageBytes = 32 * 1024;  // shared memory for a block's staged values

// diagonals a chunk takes at most: the window, (kRows + C − 1) column
// vectors, and the kRows sums stay within 128 registers (two blocks an SM)
template <typename A>
__host__ __device__ constexpr int chunk_cap() {
  return sizeof(A) == 8 ? 4 : 8;
}

// V: value type; X: X type; O: output type, summed in its working type A.
// A block covers kTile = (kThreads / TPR)·kRows consecutive rows; its values
// vals[d, r0 : r0 + kTile] are staged in shared memory, stage_diags
// diagonals at a time.
template <typename V, typename X, typename O, int VEC, int TPR>
__global__ void __launch_bounds__(kThreads, 2)
dia_spmm_kernel(const V* __restrict__ vals, const int* __restrict__ offsets,
                int ndiag, const X* __restrict__ Xm, O* __restrict__ Y,
                int64_t m, int64_t n, int64_t m_pad, int k, bool vals_vec, int stage_diags) {
  using A = typename cask::Work<O>::type;
  constexpr int C = chunk_cap<A>();
  constexpr int W = kRows + C - 1;  // window rows of a full chunk
  constexpr int kTile = kThreads / TPR * kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  V* sv = reinterpret_cast<V*>(smem);  // [stage_diags][kTile]
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int g = threadIdx.x / TPR;  // the thread's rows: r0 + g·kRows + [0, kRows)
  const int64_t i0 = r0 + g * kRows;
  const int lane = threadIdx.x % TPR;
  const int nvec = k / VEC;
  const int limit = static_cast<int>(m_pad - r0 < kTile ? m_pad - r0 : kTile);
  const V* vt = vals + r0;
  // every thread runs every loop: the staging is the block's, with barriers
  for (int c0 = 0; c0 < nvec; c0 += TPR) {
    const int c = c0 + lane;
    const bool live = i0 < m && c < nvec;
    const X* xc = Xm + static_cast<int64_t>(c) * VEC;
    A acc[kRows][VEC];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = A(0);
    for (int db = 0; db < ndiag; db += stage_diags) {
      const int de = db + stage_diags < ndiag ? db + stage_diags : ndiag;
      __syncthreads();  // the last stage's readers are done with it
      cask::stage_spans<kThreads>(
          sv, [&](int s) { return vt + static_cast<int64_t>(db + s) * m_pad; }, de - db, kTile,
          limit, vals_vec, threadIdx.x);
      // the chunk of consecutive offsets from entry d (at most C, inside the
      // stage) and its window: X rows i0 + o[0] + w, w < kRows + len − 1,
      // each loaded once; the first is loaded while the values are copied
      int d = db, len = 0;
      A xw[W][VEC];
      auto load_chunk = [&]() {
        int o[C];
#pragma unroll
        for (int e = 0; e < C; ++e) o[e] = d + e < de ? __ldg(offsets + d + e) : 0;
        len = cask::chunk_length<C>(o, de - d);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int64_t j = i0 + o[0] + w;
          if (w < kRows + len - 1 && j >= 0 && j < n) {
            cask::load_vec<X, VEC>(xc + j * k, xw[w]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) xw[w][e] = A(0);
          }
        }
      };
      if (live) load_chunk();
      cask::cp_async_wait_all();
      __syncthreads();
      if (!live) continue;
      for (;;) {
        const V* vd = sv + (d - db) * kTile + g * kRows;
#pragma unroll
        for (int dd = 0; dd < C; ++dd) {
          if (dd < len) {
            A v[kRows];
            cask::load_span_shared<V, kRows>(vd + dd * kTile, v);
#pragma unroll
            for (int q = 0; q < kRows; ++q)
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[q][e] = cask::fma_t(v[q], xw[q + dd][e], acc[q][e]);
          }
        }
        d += len;
        if (d >= de) break;
        load_chunk();
      }
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (i0 + q < m) {
          cask::store_vec<O, VEC>(Y + (i0 + q) * k + static_cast<int64_t>(c) * VEC, acc[q]);
        }
      }
    }
  }
}

template <typename V, typename X, typename O, int VEC, int TPR>
int launch_tpr(const V* vals, const int* offsets, int ndiag, const X* Xm, O* Y,
               int64_t m, int64_t n, int64_t m_pad, int k, cudaStream_t s) {
  constexpr int kTile = kThreads / TPR * kRows;
  const int64_t blocks = (m + kTile - 1) / kTile;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // a block's span of values, vals[d, r0 : r0 + kTile] with r0 a multiple of
  // kTile, is 16-byte aligned when the rows are (kTile·2 bytes >= 16)
  const bool vals_vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0 && m_pad % kRows == 0;
  const int per_stage = kStageBytes / (kTile * static_cast<int>(sizeof(V)));
  const int stage_diags = ndiag < per_stage ? ndiag : (per_stage > 0 ? per_stage : 1);
  const size_t smem = static_cast<size_t>(stage_diags) * kTile * sizeof(V);
  dia_spmm_kernel<V, X, O, VEC, TPR><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      vals, offsets, ndiag, Xm, Y, m, n, m_pad, k, vals_vec, stage_diags);
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
  // a column vector: 16 bytes, but 4 half values (8 bytes), so that the
  // window's registers are those of f32
  constexpr int kVec = sizeof(X) == 2 ? 4 : 16 / static_cast<int>(sizeof(X));
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
// for vector loads and stores, which needs k a multiple of 16 bytes and X, Y
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
