// K6: per-pixel lookup of a face's table rows (forward) and its adjoint
// scatter into the per-face table (backward).
//
// Replaces the TPU kernels of vhap_tpu/ops/plane_pallas.py:
// _fwd_kernel (:75, launched by _pallas_fwd at :160) and _bwd_kernel (:90,
// launched by _plane_core_bwd at :191), under plane_gather_tiled (:229).
// The TPU resolves each pixel's face through its tile's face list with
// one-hot bf16 hi/lo matmuls (it has no cheap gather and no atomics) and
// patches background pixels to face 0 outside the kernel. On Hopper the
// function is a plain gather and its adjoint an atomic scatter:
//
//   forward   planes[b, c, p] = packed[b, c, max(tri_id[b, p] - 1, 0)]
//   backward  d_packed[b, c, max(tri_id[b, p] - 1, 0)] += g[b, c, p]
//
// for packed (B|1, C, F): a table of batch 1 is shared by every image (its
// batch stride is 0 and the backward sums every image into it). Background
// pixels (tri_id 0) read face 0's row and send their cotangent to face 0,
// the clamp of the XLA gather (vhap_tpu/ops/rasterize.py:468-479) that
// plane_gather_tiled reproduces (plane_pallas.py:261-264).
//
// Forward: one thread per pixel reads its face id once and copies the C
// rows; a warp writes 32 neighbouring pixels of a channel (coalesced), and
// the reads hit a table of a few MB that stays in L2. The output is a copy:
// bit for bit the plain torch.gather.
//
// Backward: one thread per pixel and channel chunk. Most of a head render
// is background (93 % of the bench's 16 x 512 x 512 canvas), and every
// background pixel adds into face 0's row, so a per-pixel atomicAdd would
// serialize millions of atomics on C addresses. Lanes of a warp that share
// a face first pre-sum with shuffles (grouped by __match_any_sync,
// reduce_peers below); a group's leader then adds into shared memory when
// its face is 0, else atomically into the table. Each block covers
// kPixPerThread * 256 pixels of one image, and adds its face-0 sums to the
// table once per channel at the end. Only the order of the float atomics
// differs from the plain scatter_add_.
//
// What bounds it on an H100: bytes. The forward reads tri_id (4 B a pixel)
// and writes C floats a pixel; the backward reads C cotangent floats and
// tri_id a pixel and writes the (B|1, C, F) table. Neither does arithmetic
// to speak of.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;   // backward: pixels per thread
constexpr int kChunk = 4;          // backward: channels pre-summed together

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

__global__ void plane_gather_fwd(const float* __restrict__ packed,  // (B|1, C, F)
                                 const int* __restrict__ tri_id,   // (B, HW)
                                 int C, int F, int HW, long long pstride,
                                 float* __restrict__ out) {        // (B, C, HW)
  const int b = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const int fid = max(tri_id[(size_t)b * HW + pix] - 1, 0);
  const float* src = packed + b * pstride + fid;
  float* dst = out + (size_t)b * C * HW + pix;
  for (int c = 0; c < C; ++c) dst[(size_t)c * HW] = __ldg(src + (size_t)c * F);
}

__global__ void plane_gather_bwd(const float* __restrict__ grad,   // (B, C, HW)
                                 const int* __restrict__ tri_id,   // (B, HW)
                                 int C, int F, int HW, long long pstride,
                                 float* __restrict__ d_packed) {   // (B|1, C, F)
  extern __shared__ float face0[];                  // C sums for face 0
  for (int c = threadIdx.x; c < C; c += blockDim.x) face0[c] = 0.0f;
  __syncthreads();

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int* tb = tri_id + (size_t)b * HW;
  const float* gb = grad + (size_t)b * C * HW;
  float* dp = d_packed + b * pstride;
  const int base = blockIdx.x * blockDim.x * kPixPerThread;

  // every lane of a warp runs every iteration (the shuffles need them all);
  // a lane past the image adds 0 to face 0
  for (int k = 0; k < kPixPerThread; ++k) {
    const int pix = base + k * blockDim.x + threadIdx.x;
    const bool live = pix < HW;
    const int fid = live ? max(tb[pix] - 1, 0) : 0;
    const unsigned peers = __match_any_sync(kFullMask, fid);
    const bool leader = __ffs(peers) - 1 == lane;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      float x[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int c = c0 + i;
        x[i] = (live && c < C) ? gb[(size_t)c * HW + pix] : 0.0f;
      }
      reduce_peers(peers, x);
      if (leader) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int c = c0 + i;
          if (c >= C) break;
          if (fid == 0) {
            atomicAdd(face0 + c, x[i]);
          } else {
            atomicAdd(dp + (size_t)c * F + fid, x[i]);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    atomicAdd(dp + (size_t)c * F, face0[c]);
}

}  // namespace

// packed (B|1, C, F) f32 (pbatch = its batch, 1 or B); tri_id (B, H*W) i32;
// out (B, C, H*W) f32.
extern "C" int vhap_plane_gather(const float* packed, const int* tri_id,
                                 int B, int pbatch, int C, int F, int HW,
                                 float* out, cudaStream_t stream) {
  if (B == 0 || C == 0 || HW == 0) return cudaSuccess;
  const long long pstride = pbatch == 1 ? 0 : (long long)C * F;
  dim3 grid((HW + kThreads - 1) / kThreads, B);
  plane_gather_fwd<<<grid, kThreads, 0, stream>>>(packed, tri_id, C, F, HW,
                                                  pstride, out);
  return cudaGetLastError();
}

// grad (B, C, H*W) f32, the cotangent of the forward's output; tri_id
// (B, H*W) i32; d_packed (B|1, C, F) f32 (pbatch = its batch), zeroed by
// the caller.
extern "C" int vhap_plane_gather_bwd(const float* grad, const int* tri_id,
                                     int B, int pbatch, int C, int F, int HW,
                                     float* d_packed, cudaStream_t stream) {
  if (B == 0 || C == 0 || HW == 0) return cudaSuccess;
  const long long pstride = pbatch == 1 ? 0 : (long long)C * F;
  const int per_block = kThreads * kPixPerThread;
  dim3 grid((HW + per_block - 1) / per_block, B);
  plane_gather_bwd<<<grid, kThreads, C * sizeof(float), stream>>>(
      grad, tri_id, C, F, HW, pstride, d_packed);
  return cudaGetLastError();
}
