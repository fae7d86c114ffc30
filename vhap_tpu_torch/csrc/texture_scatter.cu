// K4: texel-gradient scatter (the backward of the exact weighted fetch),
// with the uv-path weight gradient riding the same launch; and K8, the
// scatter of precomputed tap values (end of file).
//
// Replaces the TPU kernel _tile_kernel_wg
// (vhap_tpu/ops/texture_grad_pallas.py:338, launched by scatter_taps_wg at
// :413 from _wfe_bwd :747). The TPU has no atomics, so it bins taps per
// 16K-texel tile and scatters with one-hot bf16 hi/lo matmuls; Hopper adds
// in place, the form nvdiffrast uses. One thread per (b, p), with
// g = d out[b, p, :]:
//
//   dflat[idx[b, k, p], :] += wgt[b, k, p] * g          (float32 atomicAdd)
//   d_wgt[b, k, p]          = sum_c flat[idx[b, k, p], c] * g[c]
//
// for k < K. A tap of weight 0 adds nothing to dflat; its d_wgt is still
// formed (a bilinear or lod fraction of exactly 0 carries gradient to that
// fraction), as the XLA branch of _wfe_bwd (:763) does for every tap. A
// pixel whose cotangent is 0 in all channels (background: its albedo is
// composited away) writes d_wgt = 0 and reads neither idx nor texels.
//
// What bounds it on an H100: bytes, and the collisions of its atomics. It
// reads g (12 bytes a pixel) once, wgt, idx and the texels only for pixels
// with a cotangent, and writes d_wgt (K * 4 a pixel) and the
// 67 MB dflat (2048^2 * 4/3 texels x 3 channels; zeroed by the caller).
// Neighbouring pixels tap neighbouring texels, so many atomics of a warp
// hit the same address and serialize in L2; aggregating them per warp is
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kC = 3;   // texel channels

__global__ void weighted_fetch_bwd(const float* __restrict__ flat,   // (N, 3)
                                   const int* __restrict__ idx,      // (B, K, P)
                                   const float* __restrict__ wgt,    // (B, K, P)
                                   const float* __restrict__ g,      // (B, P, 3)
                                   int K, int P,
                                   float* __restrict__ dflat,        // (N, 3)
                                   float* __restrict__ d_wgt,        // (B, K, P)
                                   long long n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const long long b = q / P;
  const long long p = q - b * P;
  float gc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) gc[c] = g[q * kC + c];
  const bool live = gc[0] != 0.0f || gc[1] != 0.0f || gc[2] != 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long t = (b * K + k) * P + p;
    float dw = 0.0f;
    if (live) {
      const long long i = idx[t];
      const float* texel = flat + i * kC;
      dw = (texel[0] * gc[0] + texel[1] * gc[1]) + texel[2] * gc[2];
      const float w = wgt[t];
      if (w != 0.0f) {
#pragma unroll
        for (int c = 0; c < kC; ++c) atomicAdd(dflat + i * kC + c, w * gc[c]);
      }
    }
    d_wgt[t] = dw;
  }
}

// K8: dflat[idx[b, k, p], c] += vals[b, k, c, p], one thread per tap
// (b, k, p). Replaces the TPU kernel _tile_kernel
// (vhap_tpu/ops/texture_grad_pallas.py:313, launched by scatter_taps :271),
// which bins taps per texel tile and adds with one-hot bf16 hi/lo matmuls.
// K4 cannot serve: it forms wgt * g in the kernel from a per-tap weight and
// a per-pixel cotangent, and vals need not factor that way. A tap whose C
// values are all 0 reads nothing more and writes nothing; a live tap reads
// its index and issues one float32 atomicAdd per channel. Threads run along
// p, so a warp reads each channel row of vals coalesced.
__global__ void scatter_vals(const int* __restrict__ idx,     // (B, K, P)
                             const float* __restrict__ vals,  // (B, K, C, P)
                             int C, int P,
                             float* __restrict__ dflat,       // (N, C)
                             long long n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const long long bk = q / P;                 // b * K + k
  const long long p = q - bk * P;
  const float* v = vals + bk * C * P + p;
  bool live = false;
  for (int c = 0; c < C; ++c) live |= v[(long long)c * P] != 0.0f;
  if (!live) return;
  float* row = dflat + (long long)idx[q] * C;
  for (int c = 0; c < C; ++c) {
    const float x = v[(long long)c * P];
    if (x != 0.0f) atomicAdd(row + c, x);
  }
}

}  // namespace

// flat (N, 3) f32; idx (B, K, P) i32 in [0, N); wgt (B, K, P) f32; g
// (B, P, 3) f32; dflat (N, 3) f32 zeroed by the caller; d_wgt (B, K, P) f32.
extern "C" int vhap_weighted_fetch_bwd(const float* flat, const int* idx,
                                       const float* wgt, const float* g, int B,
                                       int K, int P, float* dflat,
                                       float* d_wgt, cudaStream_t stream) {
  const long long n = (long long)B * P;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  weighted_fetch_bwd<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       stream>>>(flat, idx, wgt, g, K, P, dflat, d_wgt, n);
  return cudaGetLastError();
}

// idx (B, K, P) i32 in [0, N); vals (B, K, C, P) f32; dflat (N, C) f32
// zeroed by the caller.
extern "C" int vhap_scatter_vals(const int* idx, const float* vals, int B,
                                 int K, int C, int P, float* dflat,
                                 cudaStream_t stream) {
  const long long n = (long long)B * K * P;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  scatter_vals<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 stream>>>(idx, vals, C, P, dflat, n);
  return cudaGetLastError();
}
