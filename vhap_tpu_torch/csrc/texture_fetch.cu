// K3: the fused trilinear sample (forward).
//
// Replaces the TPU kernel _gather_tile_kernel
// (vhap_tpu/ops/texture_grad_pallas.py:476, launched by gather_taps at :597
// from weighted_fetch_exact :711) together with the tap math the JAX
// package leaves to XLA (vhap_tpu/ops/texture.py:158-238). The TPU forms
// every pixel's 8 (index, weight) taps as (B, 8, P) arrays, because its
// gather is a one-hot MXU matmul over tile-binned taps; Hopper gathers
// directly, so one thread per pixel (b, p) forms its taps in registers
// (csrc/trilinear.cuh) and sums them:
//
//   out[b, p, :] = sum_k wgt_k * flat[idx_k, :]
//
// in float32, in tap order. A pixel outside the mask writes 0 and reads
// nothing more; a tap whose weight is 0 (the upper level's at an integer
// lod, a corner at a fraction of 0) fetches nothing.
//
// What bounds it on an H100: bytes. Per pixel it reads the mask (1 byte),
// and per covered pixel uv and uv_da (24 bytes, along p where they are the
// fused interpolation's planes) and writes 12 bytes. The texels are read
// at random from a 67 MB pyramid (2048^2 * 4/3 texels x 3 channels), more
// than the 50 MB L2, but neighbouring pixels tap neighbouring texels, so
// most 12-byte texel reads hit a line a neighbour already brought in.
//
// Also here: `trilinear_taps`, which writes the taps the kernels form as
// (B, 8, P) arrays, as ops/texture_fetch.trilinear_taps does; a check of
// the kernels' level and texel choice, on no path.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

using namespace vhap_tex;

__global__ void __launch_bounds__(256)
trilinear_sample_fwd(const float* __restrict__ flat,            // (N, 3)
                     const __grid_constant__ MipLevels lv,
                     const bool* __restrict__ mask,             // (B, P) or null
                     const float* __restrict__ uv, const PixelStrides su,
                     const float* __restrict__ da, const PixelStrides sd,
                     int P,
                     float* __restrict__ out,                   // (B, P, 3)
                     long long n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const long long b = q / P;
  const long long p = q - b * P;
  float acc[kC] = {0.0f, 0.0f, 0.0f};
  if (mask == nullptr || mask[q]) {
    float u, v, d[4];
    read_pixel(uv, su, da, sd, b, p, u, v, d);
    const Lod lod = form_lod(lv, d);
    const float s[2] = {1.0f - lod.f, lod.f};
    const int lvl[2] = {lod.l0, lod.l1};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const LevelTaps t = form_level(lv, lvl[a], u, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = t.b[j] * s[a];
        if (w != 0.0f) {
          const float* texel = flat + (long long)t.idx[j] * kC;
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[c] += w * texel[c];
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) out[q * kC + c] = acc[c];
}

__global__ void __launch_bounds__(256)
trilinear_taps(const __grid_constant__ MipLevels lv,
               const bool* __restrict__ mask,
               const float* __restrict__ uv, const PixelStrides su,
               const float* __restrict__ da, const PixelStrides sd, int P,
               int* __restrict__ idx,            // (B, 8, P)
               float* __restrict__ wgt,          // (B, 8, P)
               long long n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const long long b = q / P;
  const long long p = q - b * P;
  float u, v, d[4];
  read_pixel(uv, su, da, sd, b, p, u, v, d);
  const Lod lod = form_lod(lv, d);
  const float s[2] = {1.0f - lod.f, lod.f};
  const int lvl[2] = {lod.l0, lod.l1};
  const bool live = mask == nullptr || mask[q];
  for (int a = 0; a < 2; ++a) {
    const LevelTaps t = form_level(lv, lvl[a], u, v);
    for (int j = 0; j < 4; ++j) {
      const long long k = (b * 8 + a * 4 + j) * P + p;
      idx[k] = t.idx[j];
      wgt[k] = live ? t.b[j] * s[a] : 0.0f;
    }
  }
}

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// flat (N, 3) f32; levels (L, 3) host ints (offset, height, width); mask
// (B, P) bool or null; uv / uv_da f32 pixels through their (batch, pixel,
// channel) strides; out (B, P, 3) f32.
extern "C" int vhap_trilinear_sample(const float* flat, const int* levels,
                                     int n_levels, const bool* mask,
                                     const float* uv, long long uv_sb,
                                     long long uv_sp, long long uv_sc,
                                     const float* da, long long da_sb,
                                     long long da_sp, long long da_sc, int B,
                                     int P, float* out, cudaStream_t stream) {
  const long long n = (long long)B * P;
  if (n == 0) return cudaSuccess;
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  const int threads = 256;
  trilinear_sample_fwd<<<blocks(n, threads), threads, 0, stream>>>(
      flat, make_levels(levels, n_levels), mask, uv, {uv_sb, uv_sp, uv_sc},
      da, {da_sb, da_sp, da_sc}, P, out, n);
  return cudaGetLastError();
}

// As vhap_trilinear_sample; idx (B, 8, P) i32 and wgt (B, 8, P) f32 out.
extern "C" int vhap_trilinear_taps(const int* levels, int n_levels,
                                   const bool* mask, const float* uv,
                                   long long uv_sb, long long uv_sp,
                                   long long uv_sc, const float* da,
                                   long long da_sb, long long da_sp,
                                   long long da_sc, int B, int P, int* idx,
                                   float* wgt, cudaStream_t stream) {
  const long long n = (long long)B * P;
  if (n == 0) return cudaSuccess;
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  const int threads = 256;
  trilinear_taps<<<blocks(n, threads), threads, 0, stream>>>(
      make_levels(levels, n_levels), mask, uv, {uv_sb, uv_sp, uv_sc}, da,
      {da_sb, da_sp, da_sc}, P, idx, wgt, n);
  return cudaGetLastError();
}
