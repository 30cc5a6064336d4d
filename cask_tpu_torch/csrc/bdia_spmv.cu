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
// What the design does about it:
// - One thread per block row i computes all of that row's br outputs in
//   registers.  For fixed (r, t, j), vals is contiguous in l, so the 32
//   threads of a warp (consecutive i) read 128 contiguous bytes: the value
//   stream is fully coalesced.  Values are loaded with __ldcs (evict-first),
//   since each is read once, so they do not push x out of L2.
// - The TPU kernel de-interleaves x into per-component segments with exact
//   MXU permutation matmuls; here a thread reads x[(i+d)·bc + c] directly.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDiags = 80;  // the plan's pair limit (_MAX_PAIRS)
constexpr int kThreads = 256;

struct DiagOffsets {
  int d[kMaxDiags];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
bdia_spmv_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                 T* __restrict__ y, const DiagOffsets offs, int ndiag, int br,
                 int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles,
                 int tile) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nbr) return;
  const int r0 = blockIdx.y * RB;
  const int64_t t = i / tile;
  const int npairs = ndiag * bc;
  // vals[r, t, j, s, l] lives at ((r·T + t)·npairs + j)·tile + (i − t·tile)
  const int64_t r_stride = static_cast<int64_t>(n_tiles) * npairs * tile;
  const T* v = vals + (static_cast<int64_t>(r0) * n_tiles + t) * npairs * tile
               + (i - t * tile);

  T acc[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) acc[k] = T(0);

  for (int dp = 0; dp < ndiag; ++dp) {
    const int64_t col0 = (i + offs.d[dp]) * bc;
    for (int c = 0; c < bc; ++c) {
      const int64_t col = col0 + c;
      const T xv = (col >= 0 && col < n) ? __ldg(x + col) : T(0);
      const T* vj = v + static_cast<int64_t>(dp * bc + c) * tile;
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        if (r0 + k < br) acc[k] = fma_t(__ldcs(vj + k * r_stride), xv, acc[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int64_t row = i * br + r0 + k;
    if (r0 + k < br && row < m) y[row] = acc[k];
  }
}

template <typename T, int RB>
int launch(const T* vals, const T* x, T* y, const DiagOffsets& offs, int ndiag,
           int br, int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles,
           int tile, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nbr + kThreads - 1) / kThreads),
                  static_cast<unsigned>((br + RB - 1) / RB));
  bdia_spmv_kernel<T, RB><<<grid, kThreads, 0, stream>>>(
      vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* vals, const T* x, T* y, const int* offsets, int ndiag,
             int br, int bc, int64_t m, int64_t n, int64_t nbr, int n_tiles,
             int tile, void* stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || br < 1 || bc < 1 || nbr < 1 ||
      n_tiles < 1 || tile < 1 || nbr > static_cast<int64_t>(n_tiles) * tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DiagOffsets offs = {};
  for (int k = 0; k < ndiag; ++k) offs.d[k] = offsets[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br <= 1) return launch<T, 1>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  if (br <= 2) return launch<T, 2>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  if (br <= 4) return launch<T, 4>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
  return launch<T, 8>(vals, x, y, offs, ndiag, br, bc, m, n, nbr, n_tiles, tile, s);
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
  return dispatch<float>(vals, x, y, offsets, ndiag, br, bc, m, n, nbr, n_tiles,
                         tile, stream);
}

int cask_bdia_spmv_f64(const double* vals, const double* x, double* y,
                       const int* offsets, int ndiag, int br, int bc,
                       long long m, long long n, long long nbr, int n_tiles,
                       int tile, void* stream) {
  return dispatch<double>(vals, x, y, offsets, ndiag, br, bc, m, n, nbr,
                          n_tiles, tile, stream);
}

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
