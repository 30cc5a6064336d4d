// BDIA SpMV on Hopper (sm_90a): y = A·x for a BdiaMatrix, natural-order x
// in and natural-order y out.
//
// Replaces the TPU kernels
//   cask_tpu/ops/pallas/bdia_kernels.py:bdia_spmv_pallas_fused     (one-shot)
//   cask_tpu/ops/pallas/bdia_kernels.py:bdia_spmv_pallas_resident  (solver)
// Both compute, for each kept block offset d and block element (r, c),
//   y[i·br + r] += vals[r, t, j, s, l] · x[(i + d)·bc + c],
//   i = (t·ts + s)·128 + l,  j = dpos(d)·bc + c,
// from the packed vals array that bdia_plan builds.  The COO remainder is
// added outside the kernel, as on the TPU.
//
// What bounds it: the value stream.  Every stored slot of vals is read
// exactly once (4 B each in f32), plus x and y once each; there are two
// flops per value, far below the card's FLOP/byte balance, so the kernel is
// HBM-bandwidth bound.
//
// What the design does about it (PERF.md §5.11 takes it apart):
// - One thread per block row i computes all of that row's br outputs in
//   registers.  For fixed (r, t, j), vals is contiguous in l, so the 32
//   threads of a warp (consecutive i) read 128 contiguous bytes: the value
//   stream is fully coalesced.  Values are loaded with __ldcs (evict-first),
//   since each is read once, so they do not push x out of L2.
// - The TPU kernel de-interleaves x into per-component segments with exact
//   MXU permutation matmuls; here a thread reads x[(i+d)·bc + c] directly.
//   Where bc is 1, 2, 4 or 8, n a multiple of bc and x aligned for a vector
//   of bc, each block of x lies wholly inside [0, n) or wholly outside, and
//   a thread takes it in one vector load or as zero, with no branch to a
//   scalar path (a kernel that kept one measured 18 % slower in f32);
//   otherwise one scalar load a component.  One scalar x load a pair held
//   the value stream back, in half values most (PERF.md §5.11): a block's
//   vector takes the FEM plan from 39.2 to 33.5 µs in f32 and from 29.9 to
//   23.0 µs for bf16 values.  Staging a block's values in shared memory
//   with 16-byte cp.async copies, as the SpMM kernels do, measured within
//   2 µs of that either way for half values and slower for f32.
//   Neighbouring threads read neighbouring blocks of x, which the L1/L2
//   caches serve; x is read from HBM about once.
// - The block offsets ride in a by-value kernel parameter (constant bank),
//   broadcast to every thread.  At most kMaxDiags of them.
// - x is read only where 0 <= (i+d)·bc + c < n: the structural zeros in
//   vals cover the value, but the index would leave the array.
// - Rows are handled RB at a time (RB in {1, 2, 4, 8}, chosen >= br up to
//   8); a block size above 8 spreads its rows over gridDim.y.  Loops over
//   RB are unrolled, so the accumulators stay in registers.
// - Sums are taken in the working type (float for f32, double for f64) in
//   the plan's pair order, the order of the plain PyTorch twin.
// - Half values (or a half x) are the reference's half value paths: values
//   and x are each H or f32 for one half type H (bf16 or f16), at least one
//   H, widened exactly to f32 in registers (value_types.cuh) and summed in
//   f32.  y is the reference's output type O: f32, but f16 for f16 values
//   and x, the f32 sum rounded once at the store.  A warp's value load is
//   then 64 bytes, still whole 32-byte sectors.  Two block rows a thread
//   (one __nv_bfloat162 load for both) measured slower on the FEM headline:
//   262,144 block rows then fill only half of the card's thread slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include "value_types.cuh"

namespace {

constexpr int kMaxDiags = 80;  // the plan's pair limit (_MAX_PAIRS)
constexpr int kThreads = 256;

struct DiagOffsets {
  int d[kMaxDiags];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// N consecutive elements of global memory into working-type registers
// through the read-only path, in vector loads of up to 16 bytes (p aligned
// to min(16, N·sizeof(X)) bytes)
template <typename X, int N, typename A>
__device__ __forceinline__ void load_block(const X* p, A (&out)[N]) {
  constexpr int kBytes = N * sizeof(X) < 16 ? N * static_cast<int>(sizeof(X)) : 16;
  constexpr int kPer = kBytes / static_cast<int>(sizeof(X));  // elements a load
#pragma unroll
  for (int s = 0; s < N; s += kPer) {
    alignas(16) X buf[kPer];
    if constexpr (kBytes == 16) {
      *reinterpret_cast<uint4*>(buf) = __ldg(reinterpret_cast<const uint4*>(p + s));
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(buf) = __ldg(reinterpret_cast<const uint2*>(p + s));
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<unsigned*>(buf) = __ldg(reinterpret_cast<const unsigned*>(p + s));
    } else {
      *reinterpret_cast<unsigned short*>(buf) =
          __ldg(reinterpret_cast<const unsigned short*>(p + s));
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) out[s + e] = A(cask::widen(buf[e]));
  }
}

// V: value type; X: x type; O: output type, summed in its working type A
// (float, or double for f64); BC: the plan's bc where a block of x is one
// vector (see above), else 0
template <typename V, typename X, typename O, int RB, int BC>
__global__ void __launch_bounds__(kThreads)
bdia_spmv_kernel(const V* __restrict__ vals, const X* __restrict__ x,
                 O* __restrict__ y, const DiagOffsets offs, int ndiag, int br,
                 int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles,
                 int tile) {
  using A = typename cask::Work<O>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nbr) return;
  const int r0 = blockIdx.y * RB;
  const int64_t t = i / tile;
  const int npairs = ndiag * bc;
  // vals[r, t, j, s, l] lives at ((r·T + t)·npairs + j)·tile + (i − t·tile)
  const int64_t r_stride = static_cast<int64_t>(n_tiles) * npairs * tile;
  const V* v = vals + (static_cast<int64_t>(r0) * n_tiles + t) * npairs * tile
               + (i - t * tile);

  A acc[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) acc[k] = A(0);

  for (int dp = 0; dp < ndiag; ++dp) {
    const int64_t col0 = (i + offs.d[dp]) * bc;
    if constexpr (BC > 0) {
      A xb[BC];
      if (col0 >= 0 && col0 < n) {
        load_block<X, BC>(x + col0, xb);
      } else {
#pragma unroll
        for (int c = 0; c < BC; ++c) xb[c] = A(0);
      }
#pragma unroll
      for (int c = 0; c < BC; ++c) {
        const V* vj = v + static_cast<int64_t>(dp * bc + c) * tile;
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          if (r0 + k < br) acc[k] = fma_t(A(cask::widen(__ldcs(vj + k * r_stride))), xb[c], acc[k]);
        }
      }
    } else {
      for (int c = 0; c < bc; ++c) {
        const int64_t col = col0 + c;
        const A xv = (col >= 0 && col < n) ? A(cask::widen(__ldg(x + col))) : A(0);
        const V* vj = v + static_cast<int64_t>(dp * bc + c) * tile;
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          if (r0 + k < br) acc[k] = fma_t(A(cask::widen(__ldcs(vj + k * r_stride))), xv, acc[k]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int64_t row = i * br + r0 + k;
    if (r0 + k < br && row < m) y[row] = cask::narrow<O>(acc[k]);
  }
}

template <typename V, typename X, typename O, int RB, int BC>
int launch(const V* vals, const X* x, O* y, const DiagOffsets& offs, int ndiag,
           int br, int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles,
           int tile, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nbr + kThreads - 1) / kThreads),
                  static_cast<unsigned>((br + RB - 1) / RB));
  bdia_spmv_kernel<V, X, O, RB, BC><<<grid, kThreads, 0, stream>>>(
      vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile);
  return static_cast<int>(cudaGetLastError());
}

// a block of x as one vector where it lies wholly inside [0, n) or wholly
// outside (n a multiple of bc) and x is aligned for it
template <typename V, typename X, typename O, int RB>
int launch_bc(const V* vals, const X* x, O* y, const DiagOffsets& offs, int ndiag, int br,
              int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles, int tile,
              cudaStream_t s) {
  const size_t align = bc * sizeof(X) < 16 ? bc * sizeof(X) : 16;
  const bool whole = n % bc == 0 && reinterpret_cast<uintptr_t>(x) % align == 0;
  if (whole && bc == 1) return launch<V, X, O, RB, 1>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  if (whole && bc == 2) return launch<V, X, O, RB, 2>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  if (whole && bc == 4) return launch<V, X, O, RB, 4>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  if (whole && bc == 8) return launch<V, X, O, RB, 8>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  return launch<V, X, O, RB, 0>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
}

template <typename V, typename X, typename O>
int dispatch(const V* vals, const X* x, O* y, const int* offsets, int ndiag,
             int br, int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles,
             int tile, void* stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || br < 1 || bc < 1 || nbr < 1 ||
      n_tiles < 1 || tile < 1 || nbr > static_cast<int64_t>(n_tiles) * tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DiagOffsets offs = {};
  for (int k = 0; k < ndiag; ++k) offs.d[k] = offsets[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br <= 1) return launch_bc<V, X, O, 1>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  if (br <= 2) return launch_bc<V, X, O, 2>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  if (br <= 4) return launch_bc<V, X, O, 4>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  return launch_bc<V, X, O, 8>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/bdia_kernels.py).
// Pointers are device pointers except `offsets` (host, ndiag ints); the
// launch goes on `stream` and does not synchronise.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" {

int cask_bdia_spmv_f32(const float* vals, const float* x, float* y,
                       const int* offsets, int ndiag, int br, int bc,
                       long long m, long long n, long long nbr, int n_tiles,
                       int tile, void* stream) {
  return dispatch<float, float, float>(vals, x, y, offsets, ndiag, br, bc, m, n, nbr, n_tiles,
                                       tile, stream);
}

int cask_bdia_spmv_f64(const double* vals, const double* x, double* y,
                       const int* offsets, int ndiag, int br, int bc,
                       long long m, long long n, long long nbr, int n_tiles,
                       int tile, void* stream) {
  return dispatch<double, double, double>(vals, x, y, offsets, ndiag, br, bc, m, n, nbr,
                                          n_tiles, tile, stream);
}

// Half values with an x of the same half type or f32, or f32 values with a
// half x: f32 sums; y f32, or f16 for f16 values and x.  The name gives the
// value and x types.
#define CASK_BDIA_SPMV(NAME, V, X, O)                                                          \
  int NAME(const V* vals, const X* x, O* y, const int* offsets, int ndiag, int br, int bc,      \
           long long m, long long n, long long nbr, int n_tiles, int tile, void* stream) {     \
    return dispatch<V, X, O>(vals, x, y, offsets, ndiag, br, bc, m, n, nbr, n_tiles, tile,     \
                             stream);                                                          \
  }
CASK_BDIA_SPMV(cask_bdia_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16, float)
CASK_BDIA_SPMV(cask_bdia_spmv_bf16_f32, __nv_bfloat16, float, float)
CASK_BDIA_SPMV(cask_bdia_spmv_f32_bf16, float, __nv_bfloat16, float)
CASK_BDIA_SPMV(cask_bdia_spmv_f16_f16, __half, __half, __half)
CASK_BDIA_SPMV(cask_bdia_spmv_f16_f32, __half, float, float)
CASK_BDIA_SPMV(cask_bdia_spmv_f32_f16, float, __half, float)
#undef CASK_BDIA_SPMV

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
