// K2b: fused deferred interpolation, backward.
//
// Replaces the TPU kernel _bwd_kernel_flat (vhap_tpu/ops/interp_pallas.py:421,
// launched by _interp_core_flat_bwd at :509 under fused_interp_flat). The
// TPU keeps every pixel's resolved face rows from the forward, re-runs
// _pixel_math under jax.vjp per tile and sums the row gradients per face
// with one-hot bf16 hi/lo matmuls (it has no atomics). On Hopper, one CTA
// per 16 x 16 pixel tile of one image, a thread per pixel:
//
//   * a tile without a foreground pixel leaves after one __syncthreads_or
//     (most of a head render is background). A background pixel routes its
//     cotangent nowhere (its output is 0 whatever the table holds).
//   * the tile's distinct faces get slots: an open-addressing hash on the
//     face id in shared memory (512 entries, so at most half full: a tile
//     has 256 pixels, hence at most 256 faces and never an overflow), each
//     first inserter takes the next slot number; a counting pass lists each
//     slot's pixels together.
//   * a foreground pixel re-reads the 36 + nf rows of its face from the
//     (B, F, C) table the forward saved, recomputes _pixel_math's
//     intermediates (interp_pallas.py:72-138) and forms their adjoint: the
//     12 plane rows, 9 corner normals and 6 corner uvs get the adjoint of
//     the math; the vertex ids, flags and AA planes pass their cotangent
//     through (the AA planes' is the silhouette gradient of the antialias
//     pass). Where the forward clamps (|S| <= 1e-12, squared normal length
//     < 1e-20) no gradient flows past the clamp, as in autograd. All 36 + nf
//     values go the same way: into the pixel's row vector in shared memory.
//   * after a barrier, one thread per (face, row) of the tile sums the row
//     over the face's pixels and adds a nonzero sum into the (B, F, C)
//     gradient table, zeroed by a memset before the launch, with one
//     global atomicAdd; consecutive
//     threads take consecutive rows of a face. Nothing adds floats
//     atomically in shared memory: the pixels of a face, neighbours in a
//     warp, would all hit one address and serialize.
//
// The cotangent comes per output group (zw, texc, texd, normal, vids,
// flags, AA planes), each with its own pointer and strides, as autograd
// hands it over: a group nothing downstream depends on has no cotangent
// (a null pointer), is never read and adds nothing.
//
// Built with --fmad=false, so the recomputed forward and the adjoint round
// step by step like the plain version's autograd. It matters: on sliver
// faces (plane coefficients ~5e3) the 1/w rows' gradients cancel, and
// contracting to FMA moved them by 2.9e-4 of the row's largest gradient
// on an H100 at the bench's shapes; without contraction 4e-7.
//
// What bounds it on an H100: bytes. Each foreground pixel reads the
// cotangent channels that exist (15 of 22 on the train step); tri_id is
// read for every pixel; each visible face's rows are read once and its
// gradient written once. The adjoint is ~320 flops per foreground pixel,
// far below the float32 rate. The table takes one global atomic per
// (tile, face, row); within a tile the sums need no warp vote or shuffle.
#include <cuda_runtime.h>

namespace {

constexpr int kFixedIn = 36;    // rows besides the nf flag rows
constexpr int kMathRows = 27;   // 12 plane rows, 9 corner normals, 6 uvs
constexpr int kTile = 16;       // tile side in pixels
constexpr int kThreads = kTile * kTile;
constexpr int kHash = 2 * kThreads;

// output groups of the forward, in channel order (ops/interp.py GROUPS)
enum { G_ZW, G_TEXC, G_TEXD, G_NORMAL, G_VIDS, G_FLAGS, G_AA, kGroups };

struct Cot {                    // one group's cotangent; p == nullptr: none
  const float* p;
  long long sb, sc, sp;         // element strides: batch, channel, pixel
};
struct Cots {
  Cot g[kGroups];
};

__device__ __forceinline__ float cot(const Cot& c, int b, int ch, int pix) {
  return c.p ? c.p[b * c.sb + ch * c.sc + pix * c.sp] : 0.0f;
}

__device__ __forceinline__ int hash_face(int face) {
  return (int)(((unsigned)face * 2654435761u) >> 22) & (kHash - 1);
}

// The adjoint of one foreground pixel's _pixel_math: its 27 math rows,
// stored into `row` (the pixel's row vector in shared memory) as each is
// formed.
__device__ __forceinline__ void pixel_adjoint(
    const float* __restrict__ s, const Cots& cots, int b, int pix, float px,
    float py, float sx, float sy, float* row) {
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
  const float du_u = s[21] - s[25], du_v = s[22] - s[26];
  const float dv_u = s[23] - s[25], dv_v = s[24] - s[26];

  // ---- cotangents (0 for a group without one) ----
  const float g_zw = cot(cots.g[G_ZW], b, 0, pix);
  const float g_tcu = cot(cots.g[G_TEXC], b, 0, pix);
  const float g_tcv = cot(cots.g[G_TEXC], b, 1, pix);
  const float gt0 = cot(cots.g[G_TEXD], b, 0, pix);
  const float gt1 = cot(cots.g[G_TEXD], b, 1, pix);
  const float gt2 = cot(cots.g[G_TEXD], b, 2, pix);
  const float gt3 = cot(cots.g[G_TEXD], b, 3, pix);
  const float gnx = cot(cots.g[G_NORMAL], b, 0, pix);
  const float gny = cot(cots.g[G_NORMAL], b, 1, pix);
  const float gnz = cot(cots.g[G_NORMAL], b, 2, pix);

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
  row[21] = d_du_u + u * g_tcu;
  row[22] = d_du_v + u * g_tcv;
  row[23] = d_dv_u + v * g_tcu;
  row[24] = d_dv_v + v * g_tcv;
  row[25] = w2 * g_tcu - (d_du_u + d_dv_u);
  row[26] = w2 * g_tcv - (d_du_v + d_dv_v);
  float d_u = g_tcu * s[21] + g_tcv * s[22];
  float d_v = g_tcu * s[23] + g_tcv * s[24];
  float d_w = g_tcu * s[25] + g_tcv * s[26];

  // ---- unit normal: o = r / |r| (rows 12..20) ----
  {
    const float rx = (u * s[12] + v * s[15]) + w2 * s[18];
    const float ry = (u * s[13] + v * s[16]) + w2 * s[19];
    const float rz = (u * s[14] + v * s[17]) + w2 * s[20];
    const float len2 = (rx * rx + ry * ry) + rz * rz;
    const bool len_ok = len2 >= 1e-20f;           // clamp passes gradient
    const float L = sqrtf(len_ok ? len2 : 1e-20f);
    const float dot = (gnx * rx + gny * ry) + gnz * rz;
    const float k = len_ok ? dot / (L * L * L) : 0.0f;
    const float drx = gnx / L - rx * k;
    const float dry = gny / L - ry * k;
    const float drz = gnz / L - rz * k;
    row[12] = u * drx;
    row[13] = u * dry;
    row[14] = u * drz;
    row[15] = v * drx;
    row[16] = v * dry;
    row[17] = v * drz;
    row[18] = w2 * drx;
    row[19] = w2 * dry;
    row[20] = w2 * drz;
    d_u += (drx * s[12] + dry * s[13]) + drz * s[14];
    d_v += (drx * s[15] + dry * s[16]) + drz * s[17];
    d_w += (drx * s[18] + dry * s[19]) + drz * s[20];
  }
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

  // ---- n_i = b_i * iw_i and zw = sum b_i z_i (rows 0..11) ----
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
  row[0] = d_a0x;
  row[1] = d_a0y;
  row[2] = d_b0;
  row[3] = d_a1x;
  row[4] = d_a1y;
  row[5] = d_b1;
  row[6] = d_iw0;
  row[7] = d_iw1;
  row[8] = d_iw2;
  row[9] = g_zw * b0;
  row[10] = g_zw * b1;
  row[11] = g_zw * b2;
}

// One CTA of 16 x 16 threads per 16 x 16 pixel tile, a thread per pixel.
__global__ void __launch_bounds__(kThreads, 3)
fused_interp_bwd_tiles(const float* __restrict__ table,  // (B, F, C)
                       const int* __restrict__ tri_id,   // (B, H, W)
                       const Cots cots, int F, int H, int W, int n_flags,
                       float sx, float sy,
                       float* __restrict__ d_table) {    // (B, F, C)
  extern __shared__ float vals[];                        // [pixel][Cp]
  __shared__ int hash_key[kHash];
  __shared__ int hash_slot[kHash];
  __shared__ int slot_face[kThreads];
  __shared__ int slot_count[kThreads];
  __shared__ int slot_start[kThreads];
  __shared__ int plist[kThreads];                        // pixels by slot
  __shared__ int n_slots;

  const int b = blockIdx.z;
  const int t = threadIdx.y * kTile + threadIdx.x;
  const int lane = t & 31;
  const int C = kFixedIn + n_flags;
  const int Cp = C | 1;            // odd row stride: no bank conflicts
  float* row = vals + t * Cp;
  const bool math = cots.g[G_ZW].p || cots.g[G_TEXC].p ||
                    cots.g[G_TEXD].p || cots.g[G_NORMAL].p;
  const int i = blockIdx.y * kTile + threadIdx.y;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int tid = (i < H && j < W) ? tri_id[((size_t)b * H + i) * W + j] : 0;
  const bool fg = tid > 0;
  if (!__syncthreads_or(fg)) return;                   // background tile
  float* out = d_table + (size_t)b * F * C;

  // ---- slots: one per distinct face of the tile ----
  for (int k = t; k < kHash; k += kThreads) hash_key[k] = -1;
  slot_count[t] = 0;
  if (t == 0) n_slots = 0;
  __syncthreads();
  const int face = tid - 1;
  int pos = -1;
  bool first = false;
  if (fg) {
    pos = hash_face(face);
    for (;;) {
      const int prev = atomicCAS(&hash_key[pos], -1, face);
      if (prev == -1) { first = true; break; }
      if (prev == face) break;
      pos = (pos + 1) & (kHash - 1);
    }
  }
  __syncthreads();
  if (first) {
    const int slot = atomicAdd(&n_slots, 1);
    hash_slot[pos] = slot;
    slot_face[slot] = face;
  }
  __syncthreads();
  const int ns = n_slots;
  int slot = -1, rank = 0;
  if (fg) {
    slot = hash_slot[pos];
    rank = atomicAdd(&slot_count[slot], 1);
  }

  // ---- the pixel's row vector: the adjoint and the pass-through ----
  if (fg) {
    const int pix = i * W + j;
    if (math) {
      pixel_adjoint(table + ((size_t)b * F + face) * C, cots, b, pix,
                    ((float)j + 0.5f) * sx - 1.0f,
                    ((float)i + 0.5f) * sy - 1.0f, sx, sy, row);
    } else {
      for (int r = 0; r < kMathRows; ++r) row[r] = 0.0f;
    }
    // vids (rows 27..29), flags (30..30+nf), AA planes (30+nf..36+nf):
    // the cotangent passes through
    const int first_row[3] = {kMathRows, kMathRows + 3,
                              kMathRows + 3 + n_flags};
    const int n_rows[3] = {3, n_flags, 6};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const Cot& c = cots.g[G_VIDS + g];
      for (int r = 0; r < n_rows[g]; ++r)
        row[first_row[g] + r] = cot(c, b, r, pix);
    }
  }
  __syncthreads();

  // ---- each slot's pixels, listed together (exclusive scan by warp 0) ----
  if (t < 32) {
    int carry = 0;
    for (int s0 = 0; s0 < ns; s0 += 32) {
      const int v = s0 + lane < ns ? slot_count[s0 + lane] : 0;
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (s0 + lane < ns) slot_start[s0 + lane] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  if (fg) plist[slot_start[slot] + rank] = t;
  __syncthreads();

  // ---- per (face, row): sum its pixels' values, one global atomic ----
  for (int k = t; k < ns * C; k += kThreads) {
    const int sl = k / C, r = k - sl * C;
    const int p0 = slot_start[sl], p1 = p0 + slot_count[sl];
    float v = 0.0f;
    for (int e = p0; e < p1; ++e) v += vals[plist[e] * Cp + r];
    if (v != 0.0f) atomicAdd(out + (size_t)slot_face[sl] * C + r, v);
  }
}

}  // namespace

// table (B, F, 36 + nf) f32, the forward's; tri_id (B, H, W) i32; cot
// (kGroups x 4) int64: per output group (zw, texc, texd, normal, vids,
// flags, AA planes) its f32 cotangent's address (0: no cotangent) and its
// element strides over batch, channel and pixel (h * W + w); d_table
// (B, F, 36 + nf) f32 out (zeroed here, then summed into). sx = 2/W,
// sy = 2/H.
extern "C" int vhap_fused_interp_bwd(const float* table, const int* tri_id,
                                     const long long* cot, int B, int F,
                                     int H, int W, int n_flags, float sx,
                                     float sy, float* d_table,
                                     cudaStream_t stream) {
  const int C = kFixedIn + n_flags;
  const size_t smem = sizeof(float) * kThreads * (C | 1);
  // host-side set-up first, so that the memset and the kernel are queued
  // back to back
  cudaError_t err = cudaFuncSetAttribute(
      fused_interp_bwd_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  Cots cots;
  for (int q = 0; q < kGroups; ++q) {
    cots.g[q].p = reinterpret_cast<const float*>(cot[4 * q]);
    cots.g[q].sb = cot[4 * q + 1];
    cots.g[q].sc = cot[4 * q + 2];
    cots.g[q].sp = cot[4 * q + 3];
  }
  err = cudaMemsetAsync(d_table, 0, sizeof(float) * B * F * C, stream);
  if (err != cudaSuccess || B == 0 || H == 0 || W == 0) return err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  fused_interp_bwd_tiles<<<grid, dim3(kTile, kTile), smem, stream>>>(
      table, tri_id, cots, F, H, W, n_flags, sx, sy, d_table);
  return cudaGetLastError();
}
