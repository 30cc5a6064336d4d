// Slab SpMM on Hopper (sm_90a): Y = A·X for a BdiaSlabs plan, one dense
// (g·br × W) @ (W × k) product per tile of g block rows, X and Y dense and
// row-major, for any k >= 1.
//
// Replaces the TPU kernels (cask_tpu/ops/pallas/bdia_slab.py)
//   :290  bdia_spmm_slab_padded  (B5: one BlockSpec fetch per window segment)
//   :518  _slab_ring_call        (B6: a revolving VMEM bank ring; the entries
//                                 bdia_spmm_slab_ring :505 and
//                                 bdia_spmm_slab_ring_padded :494)
// Both compute, for body tile t and slab row q = g·br + r,
//   Y[t·gb_r + q, :] = Σ_w slabs[t·gb_r + q, w] · Xwin_t[w, :],
// where the window Xwin_t stacks, in this order (bdia_slab.py:466-491):
//   the bc X rows before the tile's core (pre-halo), the bc rows after it
//   (post-halo), the gb_c core rows, then one gb_c segment per far offset d
//   starting at X row (t·g + d)·bc.
// They differ only in how the TPU delivers the window into VMEM; here every
// window row is read from X directly, rows outside the frame as zero (the
// ring's bank fill, :429-431).  Far offsets are arbitrary (no g | d).  The
// COO remainder is added outside the kernel.
//
// Two frames, one kernel: the natural frame (x_rows = n, tile0 = 0, y_rows =
// m) and the padded chain layout of BdiaSlabs.to_padded (x_rows = the
// frame's rows, tile0 = pad_tiles; the wrapper zeroes the pad tiles of Y).
//
// What bounds it: operations.  The shear inflates the value stream to
// W slab columns per row (about 10x the stored entries for the FEM band), so
// at k = 128 the product is 2·rows·W·k flops against slab + X + Y bytes once
// each, above the card's FP32 balance.  It is exact-class: plain FP32 (or
// FP64) FMAs, no tensor cores and no TF32, because the reference's auto route
// runs this product at precision="highest" (ops/spmm.py:208).
//
// What the design does about it: a register-blocked product.
// - One CTA of 256 threads per (tile, 64 slab rows, 128 columns).  Each
//   thread accumulates a 4 × 8 micro-tile in registers (16 × 16 threads).
// - W is covered in chunks of kBK = 16: per chunk the CTA stages the slab
//   chunk (transposed, so a thread's 4 rows are one 16-byte load) and the
//   matching window rows in shared memory, then runs 16 × 32 FMAs a thread.
//   Shared memory is (kBK·(kBM + 4) + kBK·kBN) elements whatever the window
//   count: a plan with any number of far offsets (W = 2·bc + gb_c·(1 + nfar))
//   runs, with no budget to pick and nothing dropped.
// - A thread's 8 columns are two runs of 4 (tx·4 and 64 + tx·4), so the
//   window reads are 16-byte shared loads without bank conflicts and the Y
//   stores of a row are contiguous.
// - Slab and X loads are coalesced along w and along k respectively; a
//   window row's X index is worked out per load from (w, tile, offsets).
// - The far offsets ride in a by-value parameter (at most kMaxFar).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // slab rows per CTA
constexpr int kBN = 128;  // columns per CTA
constexpr int kBK = 16;   // window rows per shared-memory chunk
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 8;    // columns per thread (two runs of 4)
constexpr int kPad = 4;   // keeps the transposed slab stores off one bank
constexpr int kMaxFar = 64;

struct FarOffsets {
  int d[kMaxFar];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// four consecutive shared-memory values (16-byte aligned) as one or two
// vector loads
__device__ __forceinline__ void lds4(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void lds4(const double* p, double (&o)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// X row of window row w for a tile whose core starts at X row row0
__device__ __forceinline__ int64_t window_row(int w, int64_t row0, int bc, int gb_c,
                                              const FarOffsets& far) {
  if (w < bc) return row0 - bc + w;             // pre-halo
  if (w < 2 * bc) return row0 + gb_c + (w - bc);  // post-halo
  w -= 2 * bc;
  if (w < gb_c) return row0 + w;                // core
  w -= gb_c;
  const int f = w / gb_c;                       // far segment
  return row0 + static_cast<int64_t>(far.d[f]) * bc + (w - f * gb_c);
}

// T: slab and X type; O: output and accumulation type
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
slab_spmm_kernel(const T* __restrict__ S, const T* __restrict__ X, O* __restrict__ Y,
                 const FarOffsets far, int bc, int gb_r, int gb_c, int W,
                 int64_t x_rows, int64_t tile0, int64_t y_rows, int k) {
  __shared__ __align__(16) O As[kBK][kBM + kPad];  // slab chunk, As[w][row]
  __shared__ __align__(16) O Bs[kBK][kBN];         // window chunk, Bs[w][col]

  const int64_t t = blockIdx.x;
  const int r0 = blockIdx.y * kBM;
  const int c0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t frame_tile = tile0 + t;
  const int64_t row0 = frame_tile * gb_c;
  const T* St = S + t * gb_r * static_cast<int64_t>(W);

  O acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = O(0);

  for (int w0 = 0; w0 < W; w0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = e % kBK, m = e / kBK;
      const int row = r0 + m, w = w0 + kk;
      As[kk][m] = (row < gb_r && w < W) ? O(__ldg(St + static_cast<int64_t>(row) * W + w))
                                        : O(0);
    }
#pragma unroll
    for (int q = 0; q < kBK * kBN / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int col = e % kBN, kk = e / kBN;
      const int w = w0 + kk;
      O v = O(0);
      if (w < W && c0 + col < k) {
        const int64_t xr = window_row(w, row0, bc, gb_c, far);
        if (xr >= 0 && xr < x_rows) v = O(__ldg(X + xr * k + c0 + col));
      }
      Bs[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      O a[kTM], b0[4], b1[4];
      lds4(&As[kk][ty * kTM], a);
      lds4(&Bs[kk][tx * 4], b0);
      lds4(&Bs[kk][64 + tx * 4], b1);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fma_t(a[i], b0[e], acc[i][e]);
          acc[i][4 + e] = fma_t(a[i], b1[e], acc[i][4 + e]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = r0 + ty * kTM + i;
    const int64_t yr = frame_tile * gb_r + row;
    if (row >= gb_r || yr >= y_rows) continue;
    O* y = Y + yr * k;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < k) y[col] = acc[i][j];
    }
  }
}

template <typename T, typename O>
int launch(const T* S, const T* X, O* Y, const int* far_offsets, int nfar, int bc,
           int gb_r, int gb_c, int W, int64_t ntiles, int64_t x_rows, int64_t tile0,
           int64_t y_rows, int k, void* stream) {
  if (nfar < 0 || nfar > kMaxFar || bc < 1 || gb_r < 1 || gb_c < 1 || k < 1 ||
      W != 2 * bc + gb_c * (1 + nfar) || ntiles < 1 || ntiles > 0x7fffffff ||
      (gb_r + kBM - 1) / kBM > 65535 || (k + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FarOffsets far = {};
  for (int f = 0; f < nfar; ++f) far.d[f] = far_offsets[f];
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>((gb_r + kBM - 1) / kBM),
                  static_cast<unsigned>((k + kBN - 1) / kBN));
  slab_spmm_kernel<T, O><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      S, X, Y, far, bc, gb_r, gb_c, W, x_rows, tile0, y_rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes
// (cask_tpu_torch/ops/kernels/bdia_slab_kernels.py).  S, X and Y are device
// pointers; `far_offsets` is a host array of nfar block offsets.  Body tile t
// reads the frame's X rows around (tile0 + t)·gb_c (rows outside [0, x_rows)
// read as zero) and writes Y rows (tile0 + t)·gb_r + q below y_rows.  The
// launch goes on `stream` and does not synchronise.  Returns the cudaError_t
// of the launch (0 = cudaSuccess).
extern "C" {

int cask_slab_spmm_f32(const float* S, const float* X, float* Y, const int* far_offsets,
                       int nfar, int bc, int gb_r, int gb_c, int W, long long ntiles,
                       long long x_rows, long long tile0, long long y_rows, int k,
                       void* stream) {
  return launch<float, float>(S, X, Y, far_offsets, nfar, bc, gb_r, gb_c, W, ntiles, x_rows,
                              tile0, y_rows, k, stream);
}

int cask_slab_spmm_f64(const double* S, const double* X, double* Y, const int* far_offsets,
                       int nfar, int bc, int gb_r, int gb_c, int W, long long ntiles,
                       long long x_rows, long long tile0, long long y_rows, int k,
                       void* stream) {
  return launch<double, double>(S, X, Y, far_offsets, nfar, bc, gb_r, gb_c, W, ntiles,
                                x_rows, tile0, y_rows, k, stream);
}

// f32 slabs and X, f64 output and sums (accum_dtype=float64)
int cask_slab_spmm_f32_f64(const float* S, const float* X, double* Y,
                           const int* far_offsets, int nfar, int bc, int gb_r, int gb_c,
                           int W, long long ntiles, long long x_rows, long long tile0,
                           long long y_rows, int k, void* stream) {
  return launch<float, double>(S, X, Y, far_offsets, nfar, bc, gb_r, gb_c, W, ntiles,
                               x_rows, tile0, y_rows, k, stream);
}

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
