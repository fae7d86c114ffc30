// K4: the backward of the fused trilinear sample (K3, texture_fetch.cu);
// and K8, the scatter of precomputed tap values (end of file).
//
// Replaces the TPU kernel _tile_kernel_wg
// (vhap_tpu/ops/texture_grad_pallas.py:338, launched by scatter_taps_wg at
// :413 from _wfe_bwd :747) together with the autodiff of the tap math the
// JAX package leaves to XLA (vhap_tpu/ops/texture.py:158-238). The TPU has
// no atomics, so it bins taps per 16K-texel tile and scatters with one-hot
// bf16 hi/lo matmuls, and its weight gradient d_wgt (B, 8, P) goes back
// through XLA's tap math to uv and uv_da. Hopper adds in place, the form
// nvdiffrast uses, and keeps d_wgt in registers. One thread per pixel
// (b, p) with cotangent g = d out[b, p, :] forms its taps again
// (csrc/trilinear.cuh) and, for each tap k of weight w_k and texel T_k:
//
//   dflat[idx_k, :] += w_k * g          (float32 atomicAdd, w_k != 0)
//   G_k              = T_k . g          (every tap: a fraction of exactly 0
//                                        still carries gradient, as in the
//                                        XLA branch of _wfe_bwd, :763)
//
// then carries G through the chain rule line for line as
// ops/texture_fetch.trilinear_sample_bwd_plain writes it: the bilinear
// fractions to d_uv, the level share f to the lod, and the lod through
// log2, the max of the two footprints (a tie split half and half) and the
// clamps (gradient at their bounds, none below 1e-20) to d_uv_da. G and
// everything formed from it is float64, as the plain version computes it
// for a float64 texture and cotangent: on a smooth texture the two levels'
// samples nearly cancel in d f = (sample_1 - sample_0) . g, and neighbour
// texels in the fractions' adjoints, where float32 keeps ~1e-4 of the
// largest gradient. The taps themselves are the forward's float32 ones.
// d_uv and
// d_uv_da are written through strides of their own (plane layout for the
// fused interpolation's planes, which its backward reads as they are). A
// pixel outside the mask, or whose cotangent is 0 in all channels
// (background: its albedo is composited away), writes zeros and reads
// nothing more.
//
// The levels of at most kTopTexels texels (64 x 64 and smaller) take the
// most taps per texel: every live pixel at lod L - 1 adds its 4 corners
// into the one texel of the 1 x 1 level, millions of adds on one address,
// where a float32 running sum drifts by ~2e-5 of the sum. Their taps are
// summed in a float64 scratch (the wrapper's, its size from
// vhap_trilinear_sample_bwd_scratch) and folded into dflat after the pass;
// the other levels' taps add into dflat in float32.
//
// What bounds it on an H100: bytes, and the collisions of its atomics. It
// reads the mask and g (13 bytes a pixel) once, uv, uv_da and the 8 texels
// only for a live pixel, writes d_uv and d_uv_da (24 bytes a pixel) and the
// 67 MB dflat (2048^2 * 4/3 texels x 3 channels; zeroed by the caller).
// Neighbouring pixels tap neighbouring texels, so many atomics of a warp
// hit the same address and serialize in L2; aggregating them per warp is
// later work.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

using namespace vhap_tex;

constexpr double kLn2 = 0.693147180559945309;   // torch.log2's backward
constexpr long long kTopTexels = 4096;           // a level summed in float64

// The top levels: the first texel of the first level of at most
// kTopTexels texels, and the texels from there to the pyramid's end.
struct TopLevels {
  long long first, count;
};

TopLevels top_levels(const int* table, int n) {
  auto texels = [&](int l) { return (long long)table[3 * l + 1] * table[3 * l + 2]; };
  int l = n;
  while (l > 0 && texels(l - 1) <= kTopTexels) --l;
  const long long end = table[3 * (n - 1)] + texels(n - 1);
  const long long first = l < n ? table[3 * l] : end;
  return {first, end - first};
}

__global__ void __launch_bounds__(256)
trilinear_sample_bwd(const float* __restrict__ flat,            // (N, 3)
                     const __grid_constant__ MipLevels lv,
                     const bool* __restrict__ mask,             // (B, P) or null
                     const float* __restrict__ uv, const PixelStrides su,
                     const float* __restrict__ da, const PixelStrides sd,
                     const float* __restrict__ g,               // (B, P, 3)
                     int P,
                     float* __restrict__ dflat,                 // (N, 3)
                     double* __restrict__ top,                  // (N - top_first, 3)
                     long long top_first,
                     float* __restrict__ d_uv, const PixelStrides sgu,
                     float* __restrict__ d_da, const PixelStrides sgd,
                     long long n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const long long b = q / P;
  const long long p = q - b * P;
  double du = 0.0, dv = 0.0, dd[4] = {0.0, 0.0, 0.0, 0.0};
  float gc[kC] = {0.0f, 0.0f, 0.0f};
  if (mask == nullptr || mask[q]) {
#pragma unroll
    for (int c = 0; c < kC; ++c) gc[c] = g[q * kC + c];
  }
  if (gc[0] != 0.0f || gc[1] != 0.0f || gc[2] != 0.0f) {
    float u, v, d[4];
    read_pixel(uv, su, da, sd, b, p, u, v, d);
    const Lod lod = form_lod(lv, d);
    const float s[2] = {1.0f - lod.f, lod.f};
    const int lvl[2] = {lod.l0, lod.l1};
    double ds[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const LevelTaps t = form_level(lv, lvl[a], u, v);
      double G[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long id = t.idx[j];
        const float* texel = flat + id * kC;
        G[j] = ((double)texel[0] * gc[0] + (double)texel[1] * gc[1])
               + (double)texel[2] * gc[2];
        const float w = t.b[j] * s[a];
        if (w != 0.0f && id >= top_first) {
          double* row = top + (id - top_first) * kC;
#pragma unroll
          for (int c = 0; c < kC; ++c) atomicAdd(row + c, (double)(w * gc[c]));
        } else if (w != 0.0f) {
#pragma unroll
          for (int c = 0; c < kC; ++c) atomicAdd(dflat + id * kC + c, w * gc[c]);
        }
      }
      // d (bilinear weight) and d (level share)
      const double db0 = G[0] * s[a], db1 = G[1] * s[a];
      const double db2 = G[2] * s[a], db3 = G[3] * s[a];
      ds[a] = ((G[0] * t.b[0] + G[1] * t.b[1]) + G[2] * t.b[2]) + G[3] * t.b[3];
      const float ax = 1.0f - t.fx, ay = 1.0f - t.fy;
      const double dfx = (db1 * ay + db3 * t.fy) - (db0 * ay + db2 * t.fy);
      const double dfy = (db2 * ax + db3 * t.fx) - (db0 * ax + db1 * t.fx);
      du = du + dfx * t.wf;
      dv = dv + dfy * t.hf;
    }
    const double df = ds[1] - ds[0];
    // lod = clamp(0.5 * log2(clamp(max(fx2, fy2), 1e-20)), 0, L - 1)
    const double dlod = (lod.raw >= 0.0f && lod.raw <= (float)(lv.n - 1)) ? df : 0.0;
    const double dc = dlod * 0.5 / (lod.c * kLn2);
    const double dm = lod.m >= 1e-20f ? dc : 0.0;
    const double share_x = lod.fx2 > lod.fy2 ? 1.0 : (lod.fx2 == lod.fy2 ? 0.5 : 0.0);
    const double dfx2 = dm * share_x;
    const double dfy2 = dm * (1.0 - share_x);
    const float Wt = (float)lv.w[0], Ht = (float)lv.h[0];
    dd[0] = dfx2 * (2.0f * lod.tx0) * Wt;
    dd[1] = dfy2 * (2.0f * lod.ty1) * Wt;
    dd[2] = dfx2 * (2.0f * lod.tx2) * Ht;
    dd[3] = dfy2 * (2.0f * lod.ty3) * Ht;
  }
  float* pu = d_uv + sgu.at(b, p);
  pu[0] = (float)du;
  pu[sgu.c] = (float)dv;
  float* pd = d_da + sgd.at(b, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) pd[i * sgd.c] = (float)dd[i];
}

// the top levels' float64 sums into dflat, whose float32 atomics skip them
__global__ void fold_top(const double* __restrict__ top, long long n,
                         float* __restrict__ dflat_top) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q < n) dflat_top[q] = (float)top[q];
}

// K8: dflat[idx[b, k, p], c] += vals[b, k, c, p], one thread per tap
// (b, k, p). Replaces the TPU kernel _tile_kernel
// (vhap_tpu/ops/texture_grad_pallas.py:313, launched by scatter_taps :271),
// which bins taps per texel tile and adds with one-hot bf16 hi/lo matmuls.
// K4 cannot serve: it forms w * g in the kernel from the taps of a pixel's
// uv and a per-pixel cotangent, and vals need not factor that way. A tap
// whose C values are all 0 reads nothing more and writes nothing; a live
// tap reads its index and issues one float32 atomicAdd per channel. Threads
// run along p, so a warp reads each channel row of vals coalesced.
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

// doubles of scratch vhap_trilinear_sample_bwd takes for this pyramid
// (levels as below)
extern "C" long long vhap_trilinear_sample_bwd_scratch(const int* levels,
                                                       int n_levels) {
  return top_levels(levels, n_levels).count * kC;
}

// flat (N, 3) f32; levels (L, 3) host ints (offset, height, width); mask
// (B, P) bool or null; uv / uv_da f32 pixels through their (batch, pixel,
// channel) strides; g (B, P, 3) f32; dflat (N, 3) f32 zeroed by the
// caller; scratch f64 of vhap_trilinear_sample_bwd_scratch doubles, any
// contents; d_uv and d_da f32 through strides of their own.
extern "C" int vhap_trilinear_sample_bwd(
    const float* flat, const int* levels, int n_levels, const bool* mask,
    const float* uv, long long uv_sb, long long uv_sp, long long uv_sc,
    const float* da, long long da_sb, long long da_sp, long long da_sc,
    const float* g, int B, int P, float* dflat, double* scratch, float* d_uv,
    long long gu_sb, long long gu_sp, long long gu_sc, float* d_da,
    long long gd_sb, long long gd_sp, long long gd_sc, cudaStream_t stream) {
  const long long n = (long long)B * P;
  if (n == 0) return cudaSuccess;
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  const TopLevels top = top_levels(levels, n_levels);
  cudaError_t err = cudaMemsetAsync(scratch, 0,
                                    sizeof(double) * top.count * kC, stream);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  trilinear_sample_bwd<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         stream>>>(flat, make_levels(levels, n_levels), mask,
                                   uv, {uv_sb, uv_sp, uv_sc}, da,
                                   {da_sb, da_sp, da_sc}, g, P, dflat,
                                   scratch, top.first, d_uv,
                                   {gu_sb, gu_sp, gu_sc}, d_da,
                                   {gd_sb, gd_sp, gd_sc}, n);
  const long long m = top.count * kC;
  if (m > 0)
    fold_top<<<(unsigned)((m + threads - 1) / threads), threads, 0, stream>>>(
        scratch, m, dflat + top.first * kC);
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
