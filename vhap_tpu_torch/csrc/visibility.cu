// K1: per-pixel visibility (nearest covering front face).
//
// Replaces the TPU kernel _visibility_kernel_flat
// (vhap_tpu/ops/rasterize_pallas.py:208, launched by visibility_pallas_flat
// at :284), which walks per-tile face lists built by an XLA binning pass
// under a global chunk budget. Here a tile-binned rasterizer in the manner
// of Laine & Karras 2011 ("High-Performance Software Rasterization on
// GPUs", cudaraster), in three operations on the caller's stream:
//
//   1. a memset of the per-tile counters;
//   2. bin_faces: one thread per face. An invalid (culled, degenerate,
//      behind the camera) face drops out. A valid one takes the pixel
//      centers of its NDC bounding box widened by one pixel and clamped to
//      the image (first_pixel / last_pixel; the coverage test decides
//      exactly), and from them its range of 16 x 16 screen tiles. A face
//      over at most kTileFaces tiles is written into each tile's list of
//      kTileCap entries; a larger face (a near-plane straddler has a
//      full-screen box), and a face whose tile list is already full, goes
//      to its image's shared list instead, which every tile of the image
//      box-tests. No scan: a list's slot is its counter's old value. A
//      spill costs every tile of its image, so the lists are long: the
//      bench's head at 512^2 lists at most 134 faces a tile.
//   3. raster_tiles: one CTA of 256 threads per tile. It stages its
//      candidates (its list, then its image's shared entries whose box
//      meets the tile) in shared memory, 256 at a time, as many chunks as
//      there are. A warp takes a staged face and spreads its lanes over
//      the face's box clipped to the tile; a covered pixel does an
//      atomicMin of (orderable z << 32 | face) into the tile's best keys in
//      shared memory, and each pixel's tri_id = face + 1 (0 = background)
//      is then written once. A tile without candidates writes its zeros.
//
// A pixel tests a face only inside the face's widened box, and covers it
// when the three edge planes give b0, b1, b2 >= 0 (each multiplied by its
// corner's w sign, -1 only on the far corners of a near-plane straddler)
// and the depth plane gives z/w in [-1, 1], exactly as
// vhap_tpu/ops/rasterize.py:_visibility_xla. The smaller key wins: the
// nearest z, and at equal z the lowest face id, the tie-break of the
// chunked plain version; -0.0 is canonicalized to +0.0 first (the two
// compare equal there, so they must order equal here).
//
// Nothing is dropped and nothing waits on the host: the scratch size
// (vhap_visibility_scratch_ints, the one place that knows its layout)
// follows from the shapes. A tile list holds kTileCap faces; the shared
// list of an image holds F * kTileFaces entries, enough for every large
// face once and every listed face once per tile it spills from. Which
// faces spill depends on the atomics' order; the result does not. Built
// with --fmad=false: every product and sum rounds on its own, as
// PyTorch's elementwise ops do, so tri_id equals the plain version's bit
// for bit.
//
// What bounds it on an H100: bytes at its floor (the setup rows read and
// tri_id written once: ~20 MB at 16 x 512 x 512), latency in practice:
// three dependent operations, and in each tile a chain of dependent loads
// before any pixel is tested. It keeps no (B, H, W) key buffer and makes
// no global atomic on a pixel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// setup row layout, shared with vhap_tpu_torch/ops/rasterize.py (SETUP_ROW)
constexpr int kRow = 20;
enum {
  A0X, A0Y, A0C, A1X, A1Y, A1C, ZX, ZY, ZC,
  XMIN, YMIN, XMAX, YMAX, WS0, WS1, WS2, VALID
};
constexpr int kTile = 16;        // tile side in pixels (ops/rasterize.py VIS_TILE)
constexpr int kPixels = kTile * kTile;
constexpr int kTileFaces = 16;   // most tiles a face is listed in (VIS_TILE_FACES)
constexpr int kTileCap = 1024;   // entries of a tile's list (VIS_TILE_CAP)
constexpr int kThreads = kPixels; // raster_tiles' CTA: a thread per pixel
constexpr int kChunk = kThreads; // candidates staged per round

__device__ __forceinline__ uint32_t orderable(float z) {
  uint32_t bits = __float_as_uint(z == 0.0f ? 0.0f : z);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// first / last pixel whose center (k + 0.5) * s - 1 may lie in [lo, hi]
__device__ __forceinline__ int first_pixel(float lo, float s, int n) {
  float t = fminf(fmaxf((lo + 1.0f) / s - 0.5f, -2.0f), (float)n + 1.0f);
  return max((int)floorf(t) - 1, 0);
}
__device__ __forceinline__ int last_pixel(float hi, float s, int n) {
  float t = fminf(fmaxf((hi + 1.0f) / s - 0.5f, -2.0f), (float)n + 1.0f);
  return min((int)ceilf(t) + 1, n - 1);
}

struct Box {
  int i0, i1, j0, j1;             // pixel rows / columns, inclusive
};

// a valid face's widened, clamped pixel box; false when it is empty
__device__ __forceinline__ bool face_box(const float* r, int H, int W,
                                         float sx, float sy, Box& box) {
  box.j0 = first_pixel(r[XMIN], sx, W);
  box.j1 = last_pixel(r[XMAX], sx, W);
  box.i0 = first_pixel(r[YMIN], sy, H);
  box.i1 = last_pixel(r[YMAX], sy, H);
  return box.j0 <= box.j1 && box.i0 <= box.i1;
}

// scratch layout (ints): tile counters (B * T), shared-list counts (B),
// tile lists (B * T * kTileCap), shared lists (B * F * kTileFaces)
size_t scratch_ints(int B, int F, int T) {
  return (size_t)B * T + B + (size_t)B * T * kTileCap + (size_t)B * F * kTileFaces;
}
struct Scratch {
  int* count;
  int* shared_count;
  int* list;
  int* shared;
  Scratch(int* base, int B, int T) {
    count = base;
    shared_count = count + (size_t)B * T;
    list = shared_count + B;
    shared = list + (size_t)B * T * kTileCap;
  }
};

__global__ void bin_faces(const float* __restrict__ rows, int B, int F,
                          int H, int W, float sx, float sy, int tiles_x,
                          int tiles_y, const Scratch s) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= B * F) return;
  const int b = k / F;
  const int face = k - b * F;
  const float* r = rows + (size_t)k * kRow;
  Box box;
  if (r[VALID] == 0.0f || !face_box(r, H, W, sx, sy, box)) return;
  const int tx0 = box.j0 / kTile, tx1 = box.j1 / kTile;
  const int ty0 = box.i0 / kTile, ty1 = box.i1 / kTile;
  int* sh = s.shared + (size_t)b * F * kTileFaces;
  if ((tx1 - tx0 + 1) * (ty1 - ty0 + 1) > kTileFaces) {
    sh[atomicAdd(s.shared_count + b, 1)] = face;
    return;
  }
  const int t0 = b * tiles_y * tiles_x;
  for (int ty = ty0; ty <= ty1; ++ty)
    for (int tx = tx0; tx <= tx1; ++tx) {
      const int bt = t0 + ty * tiles_x + tx;
      const int slot = atomicAdd(s.count + bt, 1);
      if (slot < kTileCap) s.list[(size_t)bt * kTileCap + slot] = face;
      else sh[atomicAdd(s.shared_count + b, 1)] = face;
    }
}

// One CTA of 256 threads per tile, a thread per pixel; a tile without
// candidates writes its zeros and leaves. The tile's candidates (its list,
// then its image's shared list entries whose box meets the tile) are
// staged kChunk at a time; each warp then takes every 8th staged face and
// spreads its lanes over the face's box clipped to the tile, so a pixel is
// tested only by the faces whose box holds it. A lane finds its pixel in
// the box by a float reciprocal, not an integer division: e < 256 and a
// box row of w <= 16 pixels put (e + 0.5) / w at least 1/32 from an
// integer, far beyond float rounding. The best keys sit in shared memory
// (atomicMin per pixel there, only where the key beats the current one);
// each pixel is written once.
__global__ void __launch_bounds__(kThreads)
raster_tiles(const float* __restrict__ rows, int F, int H, int W, float sx,
             float sy, const Scratch s, int* __restrict__ tri_id) {
  __shared__ float s_pl[kChunk][12];   // a0 (3), a1 (3), z (3), w signs (3)
  __shared__ int s_box[kChunk];        // clipped to the tile, tile-relative:
                                       // i0 | i1 << 8 | j0 << 16 | j1 << 24
  __shared__ int s_face[kChunk];
  __shared__ unsigned long long s_best[kPixels];
  __shared__ int n_chunk;

  const int b = blockIdx.z;
  const int bt = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int n_list = min(s.count[bt], kTileCap);
  const int total = n_list + s.shared_count[b];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ti0 = blockIdx.y * kTile, tj0 = blockIdx.x * kTile;
  const int ti1 = min(ti0 + kTile, H) - 1, tj1 = min(tj0 + kTile, W) - 1;
  const int i = ti0 + t / kTile, j = tj0 + t % kTile;
  int* out = tri_id + ((size_t)b * H + i) * W + j;
  if (total == 0) {                    // no candidates: zeros only
    if (i <= ti1 && j <= tj1) *out = 0;
    return;
  }
  s_best[t] = ~0ull;
  const int* lst = s.list + (size_t)bt * kTileCap;
  const int* sh = s.shared + (size_t)b * F * kTileFaces;

  for (int base = 0; base < total; base += kChunk) {
    if (t == 0) n_chunk = 0;
    __syncthreads();
    const int k = base + t;
    if (k < total) {
      const int face = k < n_list ? lst[k] : sh[k - n_list];
      const float* r = rows + ((size_t)b * F + face) * kRow;
      Box box;
      face_box(r, H, W, sx, sy, box);
      box.i0 = max(box.i0, ti0);
      box.i1 = min(box.i1, ti1);
      box.j0 = max(box.j0, tj0);
      box.j1 = min(box.j1, tj1);
      if (box.i0 <= box.i1 && box.j0 <= box.j1) {
        const int c = atomicAdd(&n_chunk, 1);
#pragma unroll
        for (int e = 0; e < 9; ++e) s_pl[c][e] = r[A0X + e];
        s_pl[c][9] = r[WS0];
        s_pl[c][10] = r[WS1];
        s_pl[c][11] = r[WS2];
        s_box[c] = (box.i0 - ti0) | (box.i1 - ti0) << 8 | (box.j0 - tj0) << 16 |
                   (box.j1 - tj0) << 24;
        s_face[c] = face;
      }
    }
    __syncthreads();
    const int m = n_chunk;
    for (int c = warp; c < m; c += kThreads / 32) {
      const int bx = s_box[c];
      const int i0 = bx & 0xff, j0 = (bx >> 16) & 0xff;
      const int nw = ((bx >> 24) & 0xff) - j0 + 1;
      const int n = nw * (((bx >> 8) & 0xff) - i0 + 1);
      const float inv_nw = 1.0f / (float)nw;
      const float* p = s_pl[c];
      const unsigned long long fbits = (uint32_t)s_face[c];
      for (int e = lane; e < n; e += 32) {
        const int q = (int)(((float)e + 0.5f) * inv_nw);
        const int li = i0 + q, lj = j0 + (e - q * nw);
        const float px = ((float)(tj0 + lj) + 0.5f) * sx - 1.0f;
        const float py = ((float)(ti0 + li) + 0.5f) * sy - 1.0f;
        const float b0 = (p[0] * px + p[1] * py) + p[2];
        const float b1 = (p[3] * px + p[4] * py) + p[5];
        const float b2 = (1.0f - b0) - b1;
        const float z = (p[6] * px + p[7] * py) + p[8];
        if (p[9] * b0 >= 0.0f && p[10] * b1 >= 0.0f && p[11] * b2 >= 0.0f &&
            z >= -1.0f && z <= 1.0f) {
          const unsigned long long key =
              ((unsigned long long)orderable(z) << 32) | fbits;
          unsigned long long* best = &s_best[li * kTile + lj];
          if (key < *best) atomicMin(best, key);
        }
      }
    }
    __syncthreads();
  }
  if (i <= ti1 && j <= tj1) {
    const unsigned long long best = s_best[t];
    *out = best == ~0ull ? 0 : (int)(uint32_t)(best & 0xffffffffu) + 1;
  }
}

}  // namespace

// ints of scratch vhap_visibility takes for these shapes
extern "C" long long vhap_visibility_scratch_ints(int B, int F, int H, int W) {
  const int T = ((W + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
  return (long long)scratch_ints(B, F, T);
}

// rows (B, F, 20) f32 setup rows; scratch i32 of
// vhap_visibility_scratch_ints(B, F, H, W) ints, any contents; tri_id
// (B, H, W) i32 out. sx = 2/W, sy = 2/H: the pixel -> NDC scale.
extern "C" int vhap_visibility(const float* rows, int B, int F, int H, int W,
                               float sx, float sy, int* scratch, int* tri_id,
                               cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const Scratch s(scratch, B, tiles_x * tiles_y);
  cudaError_t err = cudaMemsetAsync(   // the counters, the shared-list counts
      s.count, 0, sizeof(int) * ((size_t)B * tiles_x * tiles_y + B), stream);
  if (err != cudaSuccess) return err;
  const int nf = B * F;
  if (nf > 0) {
    bin_faces<<<(nf + 255) / 256, 256, 0, stream>>>(rows, B, F, H, W, sx, sy,
                                                    tiles_x, tiles_y, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  raster_tiles<<<dim3(tiles_x, tiles_y, B), kThreads, 0, stream>>>(
      rows, F, H, W, sx, sy, s, tri_id);
  return cudaGetLastError();
}
