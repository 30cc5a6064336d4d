// Unpreconditioned CG's vector updates on Hopper (sm_90a), in two fused passes:
//   cg_update_xr: alpha = rz / pAp;  x += alpha·p;  r -= alpha·ap;  rz_new = r·r
//   cg_update_p:  beta = rz_new / rz;  p = r + beta·p
// x, r and p are updated in place.
//
// Replaces no TPU kernel.  The reference (cask_tpu/solvers/krylov.py cg) runs
// its loop as one lax.while_loop, in which XLA fuses these element-wise
// operations by itself.  The port runs them eagerly, where each axpy was a
// multiply into a temporary and then an add: five passes over the vectors
// instead of three, and each 0-d division a launch of its own.
//
// What bounds it: HBM bandwidth.  Every element is touched once per pass for
// two or three flops.  cg_update_xr reads x, p, r, ap and writes x, r (6
// passes where the unfused lines made 10, dot included); cg_update_p reads r,
// p and writes p (3 where they made 5).
//
// What the design does about it:
// - Loads and stores are 16 bytes a thread (float4, double2) where every
//   vector starts 16-byte aligned, with a scalar loop for the tail (or the
//   whole vector where one is not aligned).
// - A block takes one contiguous tile of kUnroll × 256 vectors of each array
//   and loads all of them before it computes, and the grid has a block a
//   tile (up to a cap the wrapper sets), so blocks retire and the next ones
//   start behind them.  At 134,217,728 f64 rows (NVIDIA H100 80GB HBM3) this
//   reads 91.4 % of the bound, as torch.add does; a grid that filled each SM
//   once and strode over the vectors read 85.4 %, plain loads against
//   __ldcs/__stcs hints gave 2.3 points of that, tiles the rest.
// - alpha and beta are formed from the 0-d device scalars in every block:
//   no launch for the division and no host sync.
// - Each product and sum rounds as the unfused PyTorch lines round it
//   (__dmul_rn / __dadd_rn, which the compiler never contracts into an FMA),
//   so x, r and p equal theirs bit for bit given the same alpha and beta.
// - r·r is summed in the working type into one partial per block; the last
//   block to finish (a counter taken with atomicAdd, after a fence) adds the
//   partials in a fixed order.  The counter is zeroed on the stream before
//   each launch (a 4-byte memset), so no launch depends on how the one before
//   it ended.  No float atomics: the sum is the same on every run with the
//   same length on the same card.
//   It is not cuBLAS's order, so rz_new differs from torch.vdot(r, r) in
//   the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors of each array a thread loads before it computes
constexpr int kTile = kThreads * kUnroll;  // vectors a block takes in one turn

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// The vector's components as an array, for a loop over them.
template <typename T>
__device__ __forceinline__ T* comp(typename Vec<T>::type& v) { return reinterpret_cast<T*>(&v); }

// x += alpha·p, r -= alpha·ap for one element; returns r's new value.
template <typename T>
__device__ __forceinline__ T step_xr(T& x, T p, T& r, T ap, T alpha) {
  x = add_rn(x, mul_rn(alpha, p));
  r = sub_rn(r, mul_rn(alpha, ap));
  return r;
}

// The block's sum of v, in a fixed order (warp shuffles, then the warps' sums
// by warp 0); thread 0 holds it.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : T(0);
  if (warp == 0) {
#pragma unroll
    for (int o = kThreads / 64; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_sums may be reused by a second call
  return v;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
cg_update_xr_kernel(T* __restrict__ x, const T* __restrict__ p, T* __restrict__ r,
                    const T* __restrict__ ap, const T* __restrict__ rz,
                    const T* __restrict__ pap, T* __restrict__ partials,
                    unsigned int* __restrict__ done, T* __restrict__ rz_new, int64_t n) {
  using V = typename Vec<T>::type;
  constexpr int kN = Vec<T>::n;
  const T alpha = div_rn(__ldg(rz), __ldg(pap));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = T(0);
  int64_t head = 0;  // elements done by the vector loop
  if (kVec) {
    const int64_t nv = n / kN;
    for (int64_t t = int64_t(blockIdx.x) * kTile; t < nv; t += int64_t(gridDim.x) * kTile) {
      V xv[kUnroll], rv[kUnroll], pv[kUnroll], av[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = t + u * kThreads + threadIdx.x;
        if (j < nv) {
          xv[u] = reinterpret_cast<const V*>(x)[j];
          rv[u] = reinterpret_cast<const V*>(r)[j];
          pv[u] = reinterpret_cast<const V*>(p)[j];
          av[u] = reinterpret_cast<const V*>(ap)[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = t + u * kThreads + threadIdx.x;
        if (j < nv) {
#pragma unroll
          for (int c = 0; c < kN; ++c) {
            const T rn = step_xr(comp<T>(xv[u])[c], comp<T>(pv[u])[c], comp<T>(rv[u])[c],
                                 comp<T>(av[u])[c], alpha);
            acc = fma_t(rn, rn, acc);
          }
          reinterpret_cast<V*>(x)[j] = xv[u];
          reinterpret_cast<V*>(r)[j] = rv[u];
        }
      }
    }
    head = nv * kN;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    T xi = x[i], ri = r[i];
    const T rn = step_xr(xi, p[i], ri, ap[i], alpha);
    acc = fma_t(rn, rn, acc);
    x[i] = xi;
    r[i] = ri;
  }

  const T block = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T total = T(0);
  for (int b0 = 0; b0 < static_cast<int>(gridDim.x); b0 += kThreads * kUnroll) {
    T part[kUnroll];  // loads first, then the adds in order
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * kThreads + threadIdx.x;
      part[u] = b < static_cast<int>(gridDim.x) ? __ldcg(partials + b) : T(0);  // from L2
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) total += part[u];
  }
  total = block_sum(total);
  if (threadIdx.x == 0) *rz_new = total;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
cg_update_p_kernel(T* __restrict__ p, const T* __restrict__ r,
                   const T* __restrict__ rz_new, const T* __restrict__ rz, int64_t n) {
  using V = typename Vec<T>::type;
  constexpr int kN = Vec<T>::n;
  const T beta = div_rn(__ldg(rz_new), __ldg(rz));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (kVec) {
    const int64_t nv = n / kN;
    for (int64_t t = int64_t(blockIdx.x) * kTile; t < nv; t += int64_t(gridDim.x) * kTile) {
      V pv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = t + u * kThreads + threadIdx.x;
        if (j < nv) {
          pv[u] = reinterpret_cast<const V*>(p)[j];
          rv[u] = reinterpret_cast<const V*>(r)[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = t + u * kThreads + threadIdx.x;
        if (j < nv) {
#pragma unroll
          for (int c = 0; c < kN; ++c) {
            comp<T>(pv[u])[c] = add_rn(comp<T>(rv[u])[c], mul_rn(beta, comp<T>(pv[u])[c]));
          }
          reinterpret_cast<V*>(p)[j] = pv[u];
        }
      }
    }
    head = nv * kN;
  }
  for (int64_t i = head + tid; i < n; i += stride) p[i] = add_rn(r[i], mul_rn(beta, p[i]));
}

// Blocks for n elements: one a tile (or a thread's element without the
// vector loads), at most `max_blocks`, at least 1.
int64_t grid_for(int64_t n, int per_block, int64_t max_blocks) {
  const int64_t tiles = (n + per_block - 1) / per_block;
  const int64_t blocks = tiles < max_blocks ? tiles : max_blocks;
  return blocks < 1 ? 1 : blocks;
}

template <typename T>
int update_xr(T* x, const T* p, T* r, const T* ap, const T* rz, const T* pap, T* partials,
              unsigned int* done, long long max_blocks, T* rz_new, long long n, int vec,
              void* stream) {
  if (n < 0 || max_blocks < 1 || max_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = grid_for(n, vec ? kTile * Vec<T>::n : kThreads, max_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(done, 0, sizeof(unsigned int), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  auto kernel = vec ? cg_update_xr_kernel<T, true> : cg_update_xr_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, p, r, ap, rz, pap, partials, done, rz_new, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_p(T* p, const T* r, const T* rz_new, const T* rz, long long max_blocks, long long n,
             int vec, void* stream) {
  if (n < 0 || max_blocks < 1 || max_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = grid_for(n, vec ? kTile * Vec<T>::n : kThreads, max_blocks);
  auto kernel = vec ? cg_update_p_kernel<T, true> : cg_update_p_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, r, rz_new, rz, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (cask_tpu_torch/ops/kernels/cg_kernels.py).
// All pointers are device pointers; rz, pap, rz_new are 0-d scalars on the
// device.  `max_blocks` caps the grid (a block a tile below it); `partials`
// holds `max_blocks` values of the working type and `done` one unsigned int,
// which is zeroed on `stream` before the launch; neither may be in use by a
// launch on another stream.
// `vec` is 1 where every vector starts 16-byte aligned.  The launch goes on
// `stream` and does not synchronise.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" {

int cask_cg_update_xr_f32(float* x, const float* p, float* r, const float* ap,
                          const float* rz, const float* pap, float* partials,
                          unsigned int* done, long long max_blocks, float* rz_new, long long n,
                          int vec, void* stream) {
  return update_xr<float>(x, p, r, ap, rz, pap, partials, done, max_blocks, rz_new, n, vec,
                          stream);
}

int cask_cg_update_xr_f64(double* x, const double* p, double* r, const double* ap,
                          const double* rz, const double* pap, double* partials,
                          unsigned int* done, long long max_blocks, double* rz_new,
                          long long n, int vec, void* stream) {
  return update_xr<double>(x, p, r, ap, rz, pap, partials, done, max_blocks, rz_new, n, vec,
                           stream);
}

int cask_cg_update_p_f32(float* p, const float* r, const float* rz_new, const float* rz,
                         long long max_blocks, long long n, int vec, void* stream) {
  return update_p<float>(p, r, rz_new, rz, max_blocks, n, vec, stream);
}

int cask_cg_update_p_f64(double* p, const double* r, const double* rz_new, const double* rz,
                         long long max_blocks, long long n, int vec, void* stream) {
  return update_p<double>(p, r, rz_new, rz, max_blocks, n, vec, stream);
}

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
