// Lane-bucketed ELL (LELL) SpMV on Hopper (sm_90a): the group sums of a packed
// tier, and y = A·x for a LellMatrix or a HybLell in two or three launches.
//
// Replaces the TPU kernel
//   cask_tpu/ops/pallas/lell_kernels.py:377  lell_spmv_pallas and :365
//   _lell_lane_sums, through _lell_call :319 (B18; body _lell_kernel :288)
// which computes, with B = 128 / G lanes per group,
//   out[s, g] = Σ_ℓ Σ_{b<B} vals[ℓ, s, g·B + b] · x[idx[ℓ, s, g·B + b]·B + b]
// for every slot row s and group g, x read as 0 at index >= n.  The TPU
// kernel replicates x into a bucket layout (x2[r, l] = x[r·B + l % B]) and
// gathers with take_along_axis, whose shape rule caps x at 4096 bucket rows
// (_SB_CAP, :316, :324-329: n <= 4096·B).  These kernels read x directly, so
// they have no such cap, and sum with FP32 (or FP64) FMAs.
//
// What bounds it: HBM bytes.  Every slot's value moves (padding too: slot
// fill is about 0.17 on the grouped tier of the 1M-row power law), and an
// index sector wherever a value of it is live; x stays in L2 (4 MB at 1M
// columns).  A thread that walks the L layers one after the other, each a
// value load, then an index load, then an x gather, waits on 3·L dependent
// round trips: such a kernel was bound by latency (0.35 of HBM).
//
// What the design does about it:
// - A warp per slot row, four consecutive lanes a thread: each layer's
//   values and indices come as one 16-byte load a thread (8 for half
//   values), 512 contiguous bytes a warp, streamed (ld.global.cs) so that
//   x stays in L2.
// - The chain is broken: a thread loads the values of all its layers at
//   once (up to 6 layers of the grouped tier at a time, 4 of the hub tier,
//   half that in f64), then the indices of the layers where one of its
//   values is live, then the x entries of its live slots: three round trips
//   in place of 3·L, with up to 6·16 bytes of values a thread in flight.
//   The tier kernels ask for 4 resident blocks an SM (__launch_bounds__
//   (256, 4), at most 64 registers): ptxas's code for that bound runs the
//   grouped tier of the 1M-row power law in 200 µs, against 223 without it
//   at the same 64-register ceiling and 205-208 asking for 2 or 5 blocks
//   (kernel_probe.py --lell, NVIDIA H100 80GB HBM3 at 700 W); 8 layers at a
//   time spill, 3 or 4 take longer (220, 241 µs).
// - Group sums: each thread adds its four lanes when they share a group
//   (B >= 4), then shuffles over the B/4 threads of the group; at B = 2 and
//   B = 1 a thread holds two or four groups.  A slot row is one warp, so no
//   shared memory is needed, at G = 1 neither.
// - lell_rows writes every row of y below m: row s·G + g from its slot row,
//   a zero for rows past the packed ones (trailing empty rows), so y needs
//   no zeroing.  lell_hub adds the hub tier's slot-row sums into y by
//   slot2row with global atomics, after summing each run of equal rows
//   among a block's eight slot rows (slot2row is sorted: a hub row owns
//   consecutive slot rows), and, in blocks past the hub tier's, the COO
//   remainder's products, one atomic each.  So HybLell.spmv is two launches
//   (three for an f16 · f16 y with a hub tier or remainder: the sums go into
//   an f32 y, and lell_round rounds it once).
// - Indices are checked (0 <= column < n, 0 <= row < m), so a corrupt pack
//   cannot read or write out of bounds.
//
// Half values or x (bf16 or f16, with the other the same half type or
// f32): each widens exactly to f32 as it loads and the sums are f32.  The
// output takes the reference's type: f32, but f16 for f16 values and x,
// where the reference's accumulator is f16 itself (lell_kernels.py:353):
// the port rounds its f32 sum once, at the store.  A half slot moves 2
// bytes of value in place of 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "value_types.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kWarp = 32;         // threads of a slot row: 4 lanes each
constexpr int kRowsPerBlock = 8;  // slot rows (warps) per block
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kMinBlocks = 4;  // resident blocks an SM asked for: at most 64 registers

// layers whose loads a thread has in flight at once, grouped and hub tier
// (the plans' default max_layers = 6 and chunk_layers = 4), half in f64
template <typename T>
constexpr int kRowsChunk = sizeof(T) == 8 ? 3 : 6;
template <typename T>
constexpr int kHubChunk = sizeof(T) == 8 ? 2 : 4;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// acc[j] += Σ_ℓ vals[ℓ, s, l + j] · x[idx[ℓ, s, l + j]·B + (l + j) % B] over
// the tier's L layers, for the four lanes l .. l + 3 of slot row s (off = s·128
// + l), K layers at a time: their values, then their live indices, then their
// x entries, each batch in flight together
template <int K, typename V, typename X, typename T>
__device__ __forceinline__ void lane_sums(const V* __restrict__ vals, const int* __restrict__ idx,
                                          const X* __restrict__ x, int L, int64_t plane,
                                          int64_t off, int l, int B, int64_t n, T (&acc)[4]) {
  for (int e0 = 0; e0 < L; e0 += K) {
    T v[K][4];
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (e0 + e < L) {
        cask::load4_cs(vals + (e0 + e) * plane + off, v[e]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[e][j] = T(0);
      }
    }
    int c[K][4];
#pragma unroll
    for (int e = 0; e < K; ++e) {  // past L the values are 0: no load
      if (v[e][0] != T(0) || v[e][1] != T(0) || v[e][2] != T(0) || v[e][3] != T(0)) {
        cask::load4i_cs(idx + (e0 + e) * plane + off, c[e]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[e][j] = 0;
      }
    }
#pragma unroll
    for (int e = 0; e < K; ++e) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = static_cast<int64_t>(c[e][j]) * B + ((l + j) & (B - 1));
        if (v[e][j] != T(0) && col >= 0 && col < n) {
          acc[j] = fma_t(v[e][j], T(cask::widen(__ldg(x + col))), acc[j]);
        }
      }
    }
  }
}

// out[s·G + g] for every row s·G + g < rows_out: the group sums of slot row
// s < s_pad, zero past it.  One warp per slot row.
template <typename V, typename X, typename O>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lell_rows_kernel(const V* __restrict__ vals, const int* __restrict__ idx, const X* __restrict__ x,
                 O* __restrict__ out, int L, int64_t s_pad, int G, int64_t n, int64_t rows_out) {
  using T = typename cask::Work<O>::type;
  const int B = kLane / G;
  const int t = threadIdx.x % kWarp;
  const int l = 4 * t;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  if (s < s_pad) {
    lane_sums<kRowsChunk<T>>(vals, idx, x, L, s_pad * kLane, s * kLane + l, l, B, n, acc);
  }
  const int64_t row0 = s * G;
  if (B >= 4) {
    // the four lanes share a group; then the B/4 threads of the group
    T sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    for (int o = B / 8; o > 0; o /= 2) sum += __shfl_down_sync(0xffffffffu, sum, o, B / 4);
    const int64_t row = row0 + l / B;
    if ((t & (B / 4 - 1)) == 0 && row < rows_out) out[row] = cask::narrow<O>(sum);
  } else if (B == 2) {
    const T sums[2] = {acc[0] + acc[1], acc[2] + acc[3]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (row0 + 2 * t + j < rows_out) out[row0 + 2 * t + j] = cask::narrow<O>(sums[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (row0 + l + j < rows_out) out[row0 + l + j] = cask::narrow<O>(acc[j]);
    }
  }
}

// y[slot2row[s]] += the sum of hub slot row s (all 128 lanes, B = 128), in
// blocks [0, hub_blocks); y[rem_row[e]] += rem_data[e] · x[rem_col[e]] in
// the blocks after them, a thread per remainder entry
template <typename V, typename X, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lell_hub_kernel(const V* __restrict__ vals, const int* __restrict__ idx,
                const int* __restrict__ slot2row, int L, int64_t s_pad, int hub_blocks,
                const V* __restrict__ rem_data, const int* __restrict__ rem_row,
                const int* __restrict__ rem_col, int64_t n_rem, const X* __restrict__ x,
                T* __restrict__ y, int64_t m, int64_t n) {
  __shared__ T s_sum[kRowsPerBlock];
  __shared__ int s_row[kRowsPerBlock];
  if (static_cast<int>(blockIdx.x) >= hub_blocks) {
    const int64_t e =
        static_cast<int64_t>(blockIdx.x - hub_blocks) * kThreads + threadIdx.x;
    if (e < n_rem) {
      const int r = __ldg(rem_row + e), c = __ldg(rem_col + e);
      if (r >= 0 && r < m && c >= 0 && c < n) {
        atomicAdd(y + r, T(cask::widen(__ldg(rem_data + e))) * T(cask::widen(__ldg(x + c))));
      }
    }
    return;
  }
  const int t = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + w;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  if (s < s_pad) {
    lane_sums<kHubChunk<T>>(vals, idx, x, L, s_pad * kLane, s * kLane + 4 * t, 4 * t, kLane, n,
                            acc);
  }
  T sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  for (int o = kWarp / 2; o > 0; o /= 2) sum += __shfl_down_sync(0xffffffffu, sum, o);
  if (t == 0) {
    s_sum[w] = sum;
    s_row[w] = s < s_pad ? __ldg(slot2row + s) : -1;
  }
  __syncthreads();
  // one atomic per run of equal rows among the block's slot rows
  if (threadIdx.x < kRowsPerBlock) {
    const int r = s_row[threadIdx.x];
    if (r >= 0 && r < m && (threadIdx.x == 0 || s_row[threadIdx.x - 1] != r)) {
      T tot = T(0);
      for (int k = threadIdx.x; k < kRowsPerBlock && s_row[k] == r; ++k) tot += s_sum[k];
      if (tot != T(0)) atomicAdd(y + r, tot);
    }
  }
}

// out[i] = acc[i] rounded once to O, for i < m
template <typename O>
__global__ void __launch_bounds__(kThreads)
lell_round_kernel(const float* __restrict__ acc, O* __restrict__ out, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < m) out[i] = cask::narrow<O>(acc[i]);
}

bool bad_tier(int L, long long s_pad, int G) {
  return L < 0 || s_pad < 0 || G < 1 || G > kLane || (G & (G - 1)) != 0;
}

template <typename V, typename X, typename O>
int launch_rows(const void* vals, const int* idx, const void* x, void* out, int L,
                long long s_pad, int G, long long n, long long rows_out, void* stream) {
  if (bad_tier(L, s_pad, G) || rows_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long slot_rows = (rows_out + G - 1) / G;
  const long long blocks = (slot_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  lell_rows_kernel<V, X, O><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vals), idx, static_cast<const X*>(x), static_cast<O*>(out), L, s_pad,
      G, n, rows_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, typename T>
int launch_hub(const void* vals, const int* idx, const int* slot2row, int L, long long s_pad,
               const void* rem_data, const int* rem_row, const int* rem_col, long long n_rem,
               const void* x, void* y, long long m, long long n, void* stream) {
  if (bad_tier(L, s_pad, 1) || n_rem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long hub_blocks = (s_pad + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = hub_blocks + (n_rem + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  lell_hub_kernel<V, X, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vals), idx, slot2row, L, s_pad, static_cast<int>(hub_blocks),
      static_cast<const V*>(rem_data), rem_row, rem_col, n_rem, static_cast<const X*>(x),
      static_cast<T*>(y), m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/lell_kernels.py).
// All pointers are device pointers: vals (L, s_pad, 128) and idx (L, s_pad,
// 128) int32, both 16-byte aligned; x (n,).  One entry per type combination
// and kernel, named by the values' and x's types (<t>: f32 / f64 for one f32
// or f64 type, else <values>_<x>):
// - cask_lell_spmv_<t>: the group sums out (s_pad, G) of one tier, in the
//   reference's type (_out_dtype, lell_kernels.py:359): f32 where either
//   side is bf16 or one is f32, f16 for f16 values and x (summed in f32,
//   rounded once).
// - cask_lell_rows_<t>: the same sums as the first m rows of y (length m,
//   every row written, zeros past the tier's rows); cask_lell_rows_f16_f16_f32
//   writes them in f32.
// - cask_lell_hub_<t>: adds a hub tier (G = 1, slot2row (s_pad,) int32) and
//   a COO remainder (rem_data of the values' type, rem_row, rem_col int32)
//   into y of the sum type (f64 for f64, else f32) with atomics.
// - cask_lell_round_f16: y_f16[i] = the f32 y_acc[i] rounded once, i < m.
// Each launch goes on `stream` and does not synchronise.  Each returns the
// cudaError_t of its launch (0 = cudaSuccess).
extern "C" {

#define CASK_LELL_SPMV(name, V, X, O)                                                         \
  int name(const void* vals, const int* idx, const void* x, void* out, int L,                 \
           long long s_pad, int G, long long n, void* stream) {                               \
    return launch_rows<V, X, O>(vals, idx, x, out, L, s_pad, G, n, s_pad * G, stream);        \
  }
#define CASK_LELL_ROWS(name, V, X, O)                                                         \
  int name(const void* vals, const int* idx, const void* x, void* y, int L, long long s_pad,  \
           int G, long long m, long long n, void* stream) {                                   \
    return launch_rows<V, X, O>(vals, idx, x, y, L, s_pad, G, n, m, stream);                  \
  }
#define CASK_LELL_HUB(name, V, X, T)                                                          \
  int name(const void* vals, const int* idx, const int* slot2row, int L, long long s_pad,     \
           const void* rem_data, const int* rem_row, const int* rem_col, long long n_rem,     \
           const void* x, void* y, long long m, long long n, void* stream) {                  \
    return launch_hub<V, X, T>(vals, idx, slot2row, L, s_pad, rem_data, rem_row, rem_col,     \
                               n_rem, x, y, m, n, stream);                                    \
  }
#define CASK_LELL_ALL(t, V, X, O, T)                                                          \
  CASK_LELL_SPMV(cask_lell_spmv_##t, V, X, O)                                                 \
  CASK_LELL_ROWS(cask_lell_rows_##t, V, X, O)                                                 \
  CASK_LELL_HUB(cask_lell_hub_##t, V, X, T)

CASK_LELL_ALL(f32, float, float, float, float)
CASK_LELL_ALL(f64, double, double, double, double)
CASK_LELL_ALL(bf16_bf16, __nv_bfloat16, __nv_bfloat16, float, float)
CASK_LELL_ALL(bf16_f32, __nv_bfloat16, float, float, float)
CASK_LELL_ALL(f32_bf16, float, __nv_bfloat16, float, float)
CASK_LELL_ALL(f16_f16, __half, __half, __half, float)
CASK_LELL_ALL(f16_f32, __half, float, float, float)
CASK_LELL_ALL(f32_f16, float, __half, float, float)
CASK_LELL_ROWS(cask_lell_rows_f16_f16_f32, __half, __half, float)

#undef CASK_LELL_ALL
#undef CASK_LELL_HUB
#undef CASK_LELL_ROWS
#undef CASK_LELL_SPMV

int cask_lell_round_f16(const void* acc, void* out, long long m, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  lell_round_kernel<__half><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<__half*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
