// K2b: fused deferred interpolation, backward.
//
// Replaces the TPU kernel _bwd_kernel_flat (vhap_tpu/ops/interp_pallas.py:421,
// launched by _interp_core_flat_bwd at :509 under fused_interp_flat). The
// TPU keeps every pixel's resolved face rows from the forward, re-runs
// _pixel_math under jax.vjp per tile and sums the row gradients per face
// with one-hot bf16 hi/lo matmuls (it has no atomics). Hopper has atomics
// and a cheap gather, so one thread per pixel:
//
//   * reads tri_id; a background pixel (tri_id == 0) contributes nothing.
//   * a foreground pixel re-reads the 36 + nf rows of face tri_id - 1 from
//     the (B, F, C) face table the forward saved (not per-pixel resolved
//     rows: those would be (37 + nf) floats per pixel, over 600 MB at
//     16 x 512 x 512), recomputes _pixel_math's intermediates
//     (interp_pallas.py:72-138) and forms their adjoint for its 19 + nf
//     cotangent channels (match carries none). The 12 plane rows, 9 corner
//     normals and 6 corner uvs get the adjoint of the math; the vertex ids,
//     flags and AA planes pass their cotangent through unchanged (the AA
//     planes' is the silhouette gradient of the antialias pass). Where the
//     forward clamps (|S| <= 1e-12, squared normal length < 1e-20) no
//     gradient flows past the clamp, as in autograd.
//   * lanes of a warp that share a face add their row gradients with
//     shuffles first (a peer reduction over the lanes __match_any_sync
//     groups by face); one lane per face then atomicAdds the 36 + nf sums
//     into the zeroed (B, F, C) gradient table.
//
// Built with --fmad=false, so the recomputed forward and the adjoint round
// step by step like the plain version's autograd. It matters: on sliver
// faces (plane coefficients ~5e3) the 1/w rows' gradients cancel, and
// contracting to FMA moved them by 2.9e-4 of the row's largest gradient
// on an H100 at the bench's shapes; without contraction 4e-7.
//
// What bounds it on an H100: bytes. Each foreground pixel reads 19 + nf
// cotangent floats (the 4-byte tri_id of every pixel besides); each visible
// face's rows are read from memory once and written once as gradients. The
// adjoint is ~320 flops per foreground pixel, far below the float32 rate.
// The collisions of atomics on a face's rows are what the warp pre-sum
// cuts: a warp's 32 pixels span a few faces, not 32.
#include <cuda_runtime.h>

#include "warp_reduce.cuh"

namespace {

using vhap::reduce_peers;

constexpr int kFixedIn = 36;    // rows besides the nf flag rows
constexpr int kFixedOut = 20;   // output channels besides the nf flags
constexpr int kMathRows = 27;   // 12 plane rows, 9 corner normals, 6 uvs
constexpr int kPassOut = 10;    // first pass-through output channel (vids)
constexpr unsigned kFull = vhap::kFullMask;

__global__ void fused_interp_bwd(const float* __restrict__ table,  // (B, F, C)
                                 const int* __restrict__ tri_id,   // (B, H, W)
                                 const float* __restrict__ grad,   // (B, CO, H, W)
                                 int F, int H, int W, int n_flags,
                                 float sx, float sy,
                                 float* __restrict__ d_table,      // (B, F, C)
                                 int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int tid = p < n ? tri_id[p] : 0;
  const bool fg = tid > 0;
  // warp-uniform exit: the block is a whole number of warps, so every lane
  // of a warp that goes on is present for the shuffles below
  if (!__any_sync(kFull, fg)) return;
  const int HW = H * W;
  const int b = p / HW;
  const int pix = p - b * HW;
  const int C = kFixedIn + n_flags;
  const int CO = kFixedOut + n_flags;
  const int key = fg ? b * F + (tid - 1) : -1;      // (batch, face) row
  const unsigned peers = __match_any_sync(kFull, key);
  const int lane = threadIdx.x & 31;
  const bool leader = fg && __ffs(peers) - 1 == lane;
  const float* g = grad + (size_t)b * CO * HW + pix;

  float d[kMathRows];
#pragma unroll
  for (int r = 0; r < kMathRows; ++r) d[r] = 0.0f;

  if (fg) {
    const float* s = table + (size_t)key * C;
    const int i = pix / W;
    const int j = pix - i * W;
    const float px = ((float)j + 0.5f) * sx - 1.0f;
    const float py = ((float)i + 0.5f) * sy - 1.0f;

    // ---- forward intermediates (csrc/interp.cu, same order) ----
    const float a0x = s[0], a0y = s[1], a0c = s[2];
    const float a1x = s[3], a1y = s[4], a1c = s[5];
    const float iw0 = s[6], iw1 = s[7], iw2 = s[8];
    const float z0 = s[9], z1 = s[10], z2 = s[11];
    const float b0 = (a0x * px + a0y * py) + a0c;
    const float b1 = (a1x * px + a1y * py) + a1c;
    const float b2 = (1.0f - b0) - b1;
    const float n0 = b0 * iw0, n1 = b1 * iw1, n2 = b2 * iw2;
    const float S_raw = (n0 + n1) + n2;
    const bool s_ok = fabsf(S_raw) > 1e-12f;
    const float S = s_ok ? S_raw : 1e-12f;
    const float u = n0 / S;
    const float v = n1 / S;
    const float w2 = (1.0f - u) - v;
    const float a2x = -(a0x + a1x), a2y = -(a0y + a1y);
    const float n0x = a0x * iw0, n0y = a0y * iw0;
    const float n1x = a1x * iw1, n1y = a1y * iw1;
    const float n2x = a2x * iw2, n2y = a2y * iw2;
    const float Sx = (n0x + n1x) + n2x, Sy = (n0y + n1y) + n2y;
    const float inv_S2 = 1.0f / (S * S);
    const float qa = n0x * S - n0 * Sx, qb = n0y * S - n0 * Sy;
    const float qc = n1x * S - n1 * Sx, qd = n1y * S - n1 * Sy;
    const float dudx = qa * inv_S2 * sx, dudy = qb * inv_S2 * sy;
    const float dvdx = qc * inv_S2 * sx, dvdy = qd * inv_S2 * sy;
    const float rx = (u * s[12] + v * s[15]) + w2 * s[18];
    const float ry = (u * s[13] + v * s[16]) + w2 * s[19];
    const float rz = (u * s[14] + v * s[17]) + w2 * s[20];
    const float len2 = (rx * rx + ry * ry) + rz * rz;
    const bool len_ok = len2 >= 1e-20f;             // clamp passes gradient
    const float L = sqrtf(len_ok ? len2 : 1e-20f);
    const float du_u = s[21] - s[25], du_v = s[22] - s[26];
    const float dv_u = s[23] - s[25], dv_v = s[24] - s[26];

    // ---- cotangents ----
    const float g_zw = g[0];
    const float g_tcu = g[(size_t)1 * HW], g_tcv = g[(size_t)2 * HW];
    const float gt0 = g[(size_t)3 * HW], gt1 = g[(size_t)4 * HW];
    const float gt2 = g[(size_t)5 * HW], gt3 = g[(size_t)6 * HW];
    const float gnx = g[(size_t)7 * HW], gny = g[(size_t)8 * HW];
    const float gnz = g[(size_t)9 * HW];

    // ---- texd = [dudx dvdx; dudy dvdy] x corner uv differences ----
    const float d_dudx = gt0 * du_u + gt1 * du_v;
    const float d_dvdx = gt0 * dv_u + gt1 * dv_v;
    const float d_dudy = gt2 * du_u + gt3 * du_v;
    const float d_dvdy = gt2 * dv_u + gt3 * dv_v;
    const float d_du_u = gt0 * dudx + gt2 * dudy;
    const float d_du_v = gt1 * dudx + gt3 * dudy;
    const float d_dv_u = gt0 * dvdx + gt2 * dvdy;
    const float d_dv_v = gt1 * dvdx + gt3 * dvdy;

    // ---- corner uvs (rows 21..26): texc and the differences ----
    d[21] = d_du_u + u * g_tcu;
    d[22] = d_du_v + u * g_tcv;
    d[23] = d_dv_u + v * g_tcu;
    d[24] = d_dv_v + v * g_tcv;
    d[25] = w2 * g_tcu - (d_du_u + d_dv_u);
    d[26] = w2 * g_tcv - (d_du_v + d_dv_v);
    float d_u = g_tcu * s[21] + g_tcv * s[22];
    float d_v = g_tcu * s[23] + g_tcv * s[24];
    float d_w = g_tcu * s[25] + g_tcv * s[26];

    // ---- unit normal: o = r / |r| ----
    const float dot = (gnx * rx + gny * ry) + gnz * rz;
    const float k = len_ok ? dot / (L * L * L) : 0.0f;
    const float drx = gnx / L - rx * k;
    const float dry = gny / L - ry * k;
    const float drz = gnz / L - rz * k;
    d[12] = u * drx;  d[13] = u * dry;  d[14] = u * drz;
    d[15] = v * drx;  d[16] = v * dry;  d[17] = v * drz;
    d[18] = w2 * drx; d[19] = w2 * dry; d[20] = w2 * drz;
    d_u += (drx * s[12] + dry * s[13]) + drz * s[14];
    d_v += (drx * s[15] + dry * s[16]) + drz * s[17];
    d_w += (drx * s[18] + dry * s[19]) + drz * s[20];
    d_u -= d_w;                                      // w2 = 1 - u - v
    d_v -= d_w;

    // ---- uv screen derivatives: (q * inv_S2) * scale ----
    const float dqa = d_dudx * inv_S2 * sx, dqb = d_dudy * inv_S2 * sy;
    const float dqc = d_dvdx * inv_S2 * sx, dqd = d_dvdy * inv_S2 * sy;
    const float d_inv = (d_dudx * qa * sx + d_dudy * qb * sy)
                        + (d_dvdx * qc * sx + d_dvdy * qd * sy);
    float d_S = (dqa * n0x + dqb * n0y) + (dqc * n1x + dqd * n1y)
                - 2.0f * d_inv * inv_S2 / S;
    float d_n0 = -(dqa * Sx + dqb * Sy);
    float d_n1 = -(dqc * Sx + dqd * Sy);
    const float d_Sx = -(dqa * n0 + dqc * n1);
    const float d_Sy = -(dqb * n0 + dqd * n1);
    const float d_n0x = dqa * S + d_Sx, d_n0y = dqb * S + d_Sy;
    const float d_n1x = dqc * S + d_Sx, d_n1y = dqd * S + d_Sy;
    const float d_a2x = d_Sx * iw2, d_a2y = d_Sy * iw2;   // n2x = a2x * iw2
    float d_a0x = d_n0x * iw0 - d_a2x, d_a0y = d_n0y * iw0 - d_a2y;
    float d_a1x = d_n1x * iw1 - d_a2x, d_a1y = d_n1y * iw1 - d_a2y;
    float d_iw0 = d_n0x * a0x + d_n0y * a0y;
    float d_iw1 = d_n1x * a1x + d_n1y * a1y;
    float d_iw2 = d_Sx * a2x + d_Sy * a2y;

    // ---- perspective division u = n0 / S, v = n1 / S ----
    d_n0 += d_u / S;
    d_n1 += d_v / S;
    d_S -= (d_u * u + d_v * v) / S;
    const float d_Sr = s_ok ? d_S : 0.0f;           // no gradient past the clamp
    d_n0 += d_Sr;
    d_n1 += d_Sr;
    const float d_n2 = d_Sr;

    // ---- n_i = b_i * iw_i and zw = sum b_i z_i ----
    d_iw0 += d_n0 * b0;
    d_iw1 += d_n1 * b1;
    d_iw2 += d_n2 * b2;
    const float d_b2 = d_n2 * iw2 + g_zw * z2;
    const float d_b0 = d_n0 * iw0 + g_zw * z0 - d_b2;   // b2 = 1 - b0 - b1
    const float d_b1 = d_n1 * iw1 + g_zw * z1 - d_b2;
    d_a0x += d_b0 * px;
    d_a0y += d_b0 * py;
    d_a1x += d_b1 * px;
    d_a1y += d_b1 * py;

    d[0] = d_a0x; d[1] = d_a0y; d[2] = d_b0;
    d[3] = d_a1x; d[4] = d_a1y; d[5] = d_b1;
    d[6] = d_iw0; d[7] = d_iw1; d[8] = d_iw2;
    d[9] = g_zw * b0; d[10] = g_zw * b1; d[11] = g_zw * b2;
  }

  reduce_peers(peers, d);
  float* out = d_table + (size_t)(fg ? key : 0) * C;
  if (leader) {
#pragma unroll
    for (int r = 0; r < kMathRows; ++r) atomicAdd(out + r, d[r]);
  }
  // vids (rows 27..29), flags and AA planes: the cotangent passes through
  for (int c = 0; c < C - kMathRows; ++c) {
    float t[1] = {fg ? g[(size_t)(kPassOut + c) * HW] : 0.0f};
    reduce_peers(peers, t);
    if (leader) atomicAdd(out + kMathRows + c, t[0]);
  }
}

}  // namespace

// table (B, F, 36 + nf) f32, the forward's; tri_id (B, H, W) i32; grad
// (B, 20 + nf, H, W) f32, the cotangent of the forward's output; d_table
// (B, F, 36 + nf) f32, zeroed by the caller. sx = 2/W, sy = 2/H.
extern "C" int vhap_fused_interp_bwd(const float* table, const int* tri_id,
                                     const float* grad, int B, int F, int H,
                                     int W, int n_flags, float sx, float sy,
                                     float* d_table, cudaStream_t stream) {
  const int n = B * H * W;
  if (n == 0) return cudaSuccess;
  fused_interp_bwd<<<(n + 255) / 256, 256, 0, stream>>>(
      table, tri_id, grad, F, H, W, n_flags, sx, sy, d_table, n);
  return cudaGetLastError();
}
