// Warp-level pre-sum of values bound for the same address, shared by the
// scatter kernels (csrc/interp_bwd.cu, csrc/plane_gather.cu).
#pragma once

#include <cuda_runtime.h>

namespace vhap {

constexpr unsigned kFullMask = 0xffffffffu;

// Segmented warp sum: after the call, the lowest lane of each group of
// lanes with equal `peers` (a __match_any_sync mask) holds the sum of the
// group's x. Every lane of the warp must call it (tree reduction over the
// peers, after E. Westphal, "Voting and shuffling to optimize atomic
// operations").
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, float (&x)[N]) {
  const int lane = threadIdx.x & 31;
  int rel_pos = __popc(peers & ((1u << lane) - 1u));   // peers below me
  peers &= 0xfffffffeu << lane;                          // peers above me
  while (__any_sync(kFullMask, peers)) {
    const int next = __ffs(peers);                       // 1-based; 0 = none
    const int src = next > 0 ? next - 1 : lane;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = __shfl_sync(kFullMask, x[i], src);
      if (next) x[i] += t;
    }
    // lanes at odd positions handed their sum down: drop them
    peers &= ~__ballot_sync(kFullMask, rel_pos & 1);
    rel_pos >>= 1;
  }
}

}  // namespace vhap
