// Lane-bucketed ELL (LELL) group sums on Hopper (sm_90a): the packed part of
// y = A·x for a LellMatrix (grouped tier, G = groups) or a ChunkedLell (hub
// tier, G = 1).
//
// Replaces the TPU kernel
//   cask_tpu/ops/pallas/lell_kernels.py:377  lell_spmv_pallas and :365
//   _lell_lane_sums, through _lell_call :319 (B18; body _lell_kernel :288)
// which computes, with B = 128 / G lanes per group,
//   out[s, g] = Σ_ℓ Σ_{b<B} vals[ℓ, s, g·B + b] · x[idx[ℓ, s, g·B + b]·B + b]
// for every slot row s and group g, x read as 0 at index >= n.  The TPU
// kernel replicates x into a bucket layout (x2[r, l] = x[r·B + l % B]) and
// gathers with take_along_axis, whose shape rule caps x at 4096 bucket rows
// (_SB_CAP, :316, :324-329: n <= 4096·B).  This kernel reads x directly, so
// it has no such cap, and sums with FP32 (or FP64) FMAs.
//
// What bounds it: HBM bytes.  Every slot moves its value and index (8 bytes
// f32) whether it holds an entry or padding, and slot fill is low on
// power-law graphs (about 0.19 at 1M rows); x stays in L2 (4 MB at 1M
// columns).
//
// What the design does about it:
// - One thread per (slot row, lane), 4 slot rows (512 threads) per block;
//   each thread walks the L layers, so its loads of one layer are coalesced
//   across the 128 lanes of a row and streamed (ld.global.cs), keeping x in
//   L2.  Padding slots (value 0) skip their x gather.
// - The B lanes of a group reduce with warp shuffles (B <= 32); above 32
//   (G = 2 and the hub tier's G = 1) the warps' sums meet in shared memory.
// - One store per (slot row, group): out is (S_pad, G), row-major.
// The hub tier's segment sum by slot2row and the COO remainder are plain
// PyTorch in the wrapper's callers, as they are XLA outside the reference's
// kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kRows = 4;  // slot rows per block
constexpr int kThreads = kLane * kRows;
constexpr int kWarp = 32;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lell_kernel(const T* __restrict__ vals, const int* __restrict__ idx, const T* __restrict__ x,
            T* __restrict__ out, int L, int64_t s_pad, int G, int64_t n) {
  __shared__ T part[kRows][kLane / kWarp];
  const int B = kLane / G;
  const int row_in_block = threadIdx.x / kLane;
  const int l = threadIdx.x % kLane;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRows + row_in_block;
  const int b = l % B;

  T acc = T(0);
  if (s < s_pad) {
    const int64_t plane = s_pad * kLane;
    const int64_t off = s * kLane + l;
    for (int ell = 0; ell < L; ++ell) {
      const T v = __ldcs(vals + ell * plane + off);
      if (v != T(0)) {
        const int64_t col = static_cast<int64_t>(__ldcs(idx + ell * plane + off)) * B + b;
        if (col >= 0 && col < n) acc = fma_t(v, __ldg(x + col), acc);
      }
    }
  }
  // group sum over B lanes: shuffles inside a warp, then across warps
  const int width = B < kWarp ? B : kWarp;
  for (int o = width / 2; o > 0; o /= 2) acc += __shfl_down_sync(0xffffffffu, acc, o, width);
  if (B <= kWarp) {
    if (b == 0 && s < s_pad) out[s * G + l / B] = acc;
    return;
  }
  const int warp = l / kWarp;
  if (l % kWarp == 0) part[row_in_block][warp] = acc;
  __syncthreads();
  if (b == 0 && s < s_pad) {
    T sum = T(0);
    for (int w = warp; w < warp + B / kWarp; ++w) sum += part[row_in_block][w];
    out[s * G + l / B] = sum;
  }
}

template <typename T>
int launch(const T* vals, const int* idx, const T* x, T* out, int L, long long s_pad, int G,
           long long n, void* stream) {
  if (L < 1 || s_pad < 1 || G < 1 || G > kLane || kLane % G != 0 ||
      (s_pad + kRows - 1) / kRows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((s_pad + kRows - 1) / kRows);
  lell_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(vals, idx, x, out,
                                                                            L, s_pad, G, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/lell_kernels.py).
// All pointers are device pointers: vals (L, s_pad, 128), idx (L, s_pad, 128)
// int32, x (n,), out (s_pad, G).  The launch goes on `stream` and does not
// synchronise.  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" {

int cask_lell_spmv_f32(const float* vals, const int* idx, const float* x, float* out, int L,
                       long long s_pad, int G, long long n, void* stream) {
  return launch<float>(vals, idx, x, out, L, s_pad, G, n, stream);
}

int cask_lell_spmv_f64(const double* vals, const int* idx, const double* x, double* out, int L,
                       long long s_pad, int G, long long n, void* stream) {
  return launch<double>(vals, idx, x, out, L, s_pad, G, n, stream);
}

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
