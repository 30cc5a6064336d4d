// Shared by the POH kernels (poh_spmv.cu, poh_spmm.cu): the warp's peer
// reduction before a shared-memory atomic, and the dynamic shared-memory
// opt-in.
#pragma once

#include <cuda_runtime.h>

namespace poh {

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may opt in to

// Sum x over each group of lanes that hold the same key (``peers``, from
// __match_any_sync); the group's lowest lane ends with the sum.  A log-depth
// tree over the peers, all 32 lanes shuffling in step (after NVIDIA's
// warp-aggregated atomics).  Rows of power-law graphs are very uneven: a hub
// row owns most slots of its panel, and without this its slots' shared
// atomics, one address for a whole warp, serialise.
template <typename T, int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, T (&x)[N]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  peers &= 0xfffffffeu << lane;                     // peers above it
  while (__any_sync(0xffffffffu, peers)) {
    const int next = __ffs(peers);  // 1 + the next peer above, 0 for none
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T t = __shfl_sync(0xffffffffu, x[i], next ? next - 1 : lane);
      if (next) x[i] += t;
    }
    peers &= __ballot_sync(0xffffffffu, !(rank & 1));  // odd ranks are folded in: drop them
    rank >>= 1;
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory: refuses more than
// kMaxSmem, and opts in above the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, long long smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace poh
