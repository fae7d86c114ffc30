// A pixel's 8 trilinear taps, formed in registers: the code K3
// (texture_fetch.cu) and K4 (texture_scatter.cu) share.
//
// It repeats ops/texture_fetch.py `tap_terms` op for op, in its order, and
// both sources are built with --fmad=false: every product and sum is
// rounded on its own, as PyTorch's elementwise kernels round them, and
// log2f is the full-precision libdevice function PyTorch's CUDA log2
// calls. So a pixel takes the plain version's mip level and texels even
// where its lod or texel coordinate lies within an ulp of an integer.
//
// The level table (offset, height, width of each level) comes as a
// __grid_constant__ kernel parameter: one constant-bank load per field, no
// per-thread copy. For a power-of-two texture it holds what the plain
// version's shift form computes; the wrapper builds it from the pyramid's
// own offsets and sizes.
#pragma once

#include <cuda_runtime.h>

namespace vhap_tex {

constexpr int kMaxLevels = 16;   // ops/texture_fetch.py MAX_LEVELS
constexpr int kC = 3;            // texel channels

struct MipLevels {
  int n;                         // levels, L
  int off[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// a (B, Hi, Wi, ch) float tensor read or written as (b, pixel, channel)
struct PixelStrides {
  long long b, p, c;
  __device__ __forceinline__ long long at(long long bi, long long pi) const {
    return bi * b + pi * p;
  }
};

// the lod of a pixel's footprint and its intermediates
struct Lod {
  float tx0, ty1, tx2, ty3;      // du/dx*Wt, du/dy*Wt, dv/dx*Ht, dv/dy*Ht
  float fx2, fy2;                // squared footprint along x and y, in texels
  float m, c;                    // max(fx2, fy2), clamped to >= 1e-20
  float raw;                     // 0.5 * log2(c), unclamped
  float f;                       // the lod's fraction: the upper level's share
  int l0, l1;                    // the two levels
};

// one level's 4 corners
struct LevelTaps {
  float fx, fy;                  // bilinear fractions
  float wf, hf;                  // the level's width and height
  int idx[4];                    // flat texel ids: (y0,x0) (y0,x1) (y1,x0) (y1,x1)
  float b[4];                    // bilinear weights
};

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return (r != 0 && ((r < 0) != (n < 0))) ? r + n : r;
}

// da = du/dx, du/dy, dv/dx, dv/dy
__device__ __forceinline__ Lod form_lod(const MipLevels& lv, const float da[4]) {
  Lod o;
  const float Wt = (float)lv.w[0], Ht = (float)lv.h[0];
  o.tx0 = da[0] * Wt;
  o.tx2 = da[2] * Ht;
  o.ty1 = da[1] * Wt;
  o.ty3 = da[3] * Ht;
  o.fx2 = o.tx0 * o.tx0 + o.tx2 * o.tx2;
  o.fy2 = o.ty1 * o.ty1 + o.ty3 * o.ty3;
  o.m = o.fx2 >= o.fy2 ? o.fx2 : o.fy2;
  o.c = o.m >= 1e-20f ? o.m : 1e-20f;
  o.raw = 0.5f * log2f(o.c);
  const float top = (float)(lv.n - 1);
  const float lod = fminf(fmaxf(o.raw, 0.0f), top);
  const float l0 = floorf(lod);
  o.f = lod - l0;
  o.l0 = (int)l0;
  o.l1 = min(o.l0 + 1, lv.n - 1);
  return o;
}

__device__ __forceinline__ LevelTaps form_level(const MipLevels& lv, int l,
                                                float u, float v) {
  LevelTaps t;
  const int off = lv.off[l], hi = lv.h[l], wi = lv.w[l];
  t.wf = (float)wi;
  t.hf = (float)hi;
  const float x = u * t.wf - 0.5f;
  const float y = v * t.hf - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  t.fx = x - x0;
  t.fy = y - y0;
  const int x0i = floor_mod((int)x0, wi), y0i = floor_mod((int)y0, hi);
  const int x1i = floor_mod(x0i + 1, wi), y1i = floor_mod(y0i + 1, hi);
  t.idx[0] = off + y0i * wi + x0i;
  t.idx[1] = off + y0i * wi + x1i;
  t.idx[2] = off + y1i * wi + x0i;
  t.idx[3] = off + y1i * wi + x1i;
  const float ax = 1.0f - t.fx, ay = 1.0f - t.fy;
  t.b[0] = ax * ay;
  t.b[1] = t.fx * ay;
  t.b[2] = ax * t.fy;
  t.b[3] = t.fx * t.fy;
  return t;
}

// a pixel's uv and uv_da, read through their strides
__device__ __forceinline__ void read_pixel(const float* __restrict__ uv,
                                           PixelStrides su,
                                           const float* __restrict__ da,
                                           PixelStrides sd, long long b,
                                           long long p, float& u, float& v,
                                           float d[4]) {
  const float* pu = uv + su.at(b, p);
  u = pu[0];
  v = pu[su.c];
  const float* pd = da + sd.at(b, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = pd[i * sd.c];
}

// the level table from the wrapper's (offset, height, width) triples
inline MipLevels make_levels(const int* table, int n) {
  MipLevels lv{};
  lv.n = n;
  for (int l = 0; l < n && l < kMaxLevels; ++l) {
    lv.off[l] = table[3 * l];
    lv.h[l] = table[3 * l + 1];
    lv.w[l] = table[3 * l + 2];
  }
  return lv;
}

}  // namespace vhap_tex
