"""Rasterizer geometry and visibility.

Counterpart of vhap_tpu/ops/rasterize.py (reference: nvdiffrast's
`dr.rasterize`, vhap/util/render_nvdiffrast.py:247-260) in two phases:

1. **Visibility** (not differentiable): the per-pixel winning face id.
   `visibility` launches the CUDA kernel K1 (csrc/visibility.cu, a
   tile-binned rasterizer) for CUDA tensors; `visibility_plain` is its
   plain PyTorch version, a chunked brute force like `_visibility_xla`, and
   `tile_bins_plain` the kernel's binning rule. Both return tri_id = face
   id + 1, 0 = background, with no bin budget, so the overflow count is
   always 0.
2. **Attributes** (differentiable): per-face plane tables from clip-space
   vertices (`face_attribute_planes`), evaluated per pixel by the fused
   interpolation (ops/interp.py) on the training path, or, on the
   nvdiffrast-style path (`rasterize`, `interpolate`), looked up per pixel
   by the plane gather (ops/plane_gather.py, kernel K6) and finished in
   plain PyTorch, as the JAX package finishes them in XLA.

`rasterize` is the JAX package's second caller of visibility: there its
dense-list Pallas kernel K5 (`visibility_pallas`) computes the same winner
as the flat one (K1), so here both go through K1's CUDA kernel.

Near-plane straddlers: the port follows the JAX `xla` backend, not its
Pallas kernel. A face with some but not all corners at w > eps is kept
with the clipless homogeneous setup (`_homogeneous_planes`), a full-screen
bounding box and per-corner coverage signs, so its visible part renders
as nvdiffrast's clipping renders it; the Pallas kernel drops such a face
whole. Kernel and plain version share this setup. Heads never straddle.

Conventions match nvdiffrast: pixel (i, j) covers NDC
x = (j+0.5)/W*2-1, y = (i+0.5)/H*2-1 (row 0 = bottom, y up).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from vhap_tpu_torch.device import constant
from vhap_tpu_torch.ops.kernels import Kernel, c_float, c_int, c_ptr, \
    check_cuda_tensor, library
from vhap_tpu_torch.ops.plane_gather import plane_gather, plane_gather_plain

W_EPS = 1e-6     # minimum clip w for a usable vertex
AREA_EPS = 1e-12  # minimum |signed area| (NDC^2) for a non-degenerate face

PLANE_KEYS = ("a0x", "a0y", "a0c", "a1x", "a1y", "a1c",
              "iw0", "iw1", "iw2", "z0", "z1", "z2")

# K1's per-face setup row (csrc/visibility.cu): b0/b1 planes, z/w plane,
# NDC bbox, per-corner coverage signs, valid flag, 3 pad
SETUP_ROW = 20

PLAIN_CHUNK = 64  # faces per step of visibility_plain


def _where0(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, x, torch.zeros_like(x))


def _homogeneous_planes(v: torch.Tensor):
    """Clipless (2D-homogeneous) face setup for near-plane straddlers
    (Olano & Greer '97), vhap_tpu/ops/rasterize.py:40-78.

    v: (B, F, 3, 4) face corners in clip space. Returns
    (abc (B,F,2,3) b0/b1 planes, zpln (B,F,3) z/w plane, det (B,F)).
    """
    x, y, w = v[..., 0], v[..., 1], v[..., 3]
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    n0 = (y1 * w2 - y2 * w1, x2 * w1 - x1 * w2, x1 * y2 - x2 * y1)
    n1 = (y2 * w0 - y0 * w2, x0 * w2 - x2 * w0, x2 * y0 - x0 * y2)
    n2 = (y0 * w1 - y1 * w0, x1 * w0 - x0 * w1, x0 * y1 - x1 * y0)
    det = n0[2] * w0 + n1[2] * w1 + n2[2] * w2
    ok = torch.abs(det) > AREA_EPS
    inv_det = _where0(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)))

    def plane(n, wi):
        s = wi * inv_det
        return torch.stack([n[0] * s, n[1] * s, n[2] * s], dim=-1)

    abc = torch.stack([plane(n0, w0), plane(n1, w1)], dim=-2)
    z = v[..., 2]
    zpln = torch.stack(
        [sum(n[k] * z[..., i] for i, n in enumerate((n0, n1, n2))) * inv_det
         for k in range(3)], dim=-1)
    return abc, zpln, det


def face_setup(verts_clip: torch.Tensor, faces: torch.Tensor,
               cull_backfaces: bool = True) -> Dict[str, torch.Tensor]:
    """Per-face screen-space setup (vhap_tpu/ops/rasterize.py:81-171, with
    clip_straddling=True: straddlers get the clipless setup).

    verts_clip: (B, V, 4); faces: (F, 3). Returns (B, F, ...) tensors:
      abc (B,F,2,3) b0/b1 planes in NDC, zpln (B,F,3) z/w plane,
      bbox (B,F,4) [xmin, ymin, xmax, ymax], valid (B,F) bool,
      wsign (B,F,3) per-corner coverage sign (-1 only on straddlers).
    """
    v = verts_clip[:, faces]                   # (B, F, 3, 4)
    w = v[..., 3]
    w_ok = torch.all(w > W_EPS, dim=-1)        # (B, F)
    w_safe = torch.where(torch.abs(w) > W_EPS, w, torch.full_like(w, W_EPS))
    sx = v[..., 0] / w_safe
    sy = v[..., 1] / w_safe
    szw = v[..., 2] / w_safe

    x0, x1, x2 = sx[..., 0], sx[..., 1], sx[..., 2]
    y0, y1, y2 = sy[..., 0], sy[..., 1], sy[..., 2]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)

    # front faces wind counter-clockwise in NDC (y up): positive area
    orient_ok = area > AREA_EPS if cull_backfaces else torch.abs(area) > AREA_EPS
    valid = w_ok & orient_ok

    ok = torch.abs(area) > AREA_EPS
    inv_area = _where0(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)))
    a0x = (y1 - y2) * inv_area
    a0y = (x2 - x1) * inv_area
    a0c = -(a0x * x2 + a0y * y2)
    a1x = (y2 - y0) * inv_area
    a1y = (x0 - x2) * inv_area
    a1c = -(a1x * x2 + a1y * y2)

    z0, z1, z2 = szw[..., 0], szw[..., 1], szw[..., 2]
    zx = a0x * (z0 - z2) + a1x * (z1 - z2)
    zy = a0y * (z0 - z2) + a1y * (z1 - z2)
    zc = a0c * (z0 - z2) + a1c * (z1 - z2) + z2

    abc = torch.stack([torch.stack([a0x, a0y, a0c], -1),
                       torch.stack([a1x, a1y, a1c], -1)], dim=-2)
    zpln = torch.stack([zx, zy, zc], dim=-1)
    bbox = torch.stack([sx.amin(-1), sy.amin(-1),
                        sx.amax(-1), sy.amax(-1)], dim=-1)

    # near-plane straddlers: clipless planes, full-screen bbox, coverage
    # sign flipped on the corners behind the camera
    straddle = torch.any(w > W_EPS, dim=-1) & ~w_ok
    abc_h, zpln_h, det = _homogeneous_planes(v)
    orient_h = det > AREA_EPS if cull_backfaces else torch.abs(det) > AREA_EPS
    abc = torch.where(straddle[..., None, None], abc_h, abc)
    zpln = torch.where(straddle[..., None], zpln_h, zpln)
    full = constant((-1.0, -1.0, 1.0, 1.0), bbox.dtype, bbox.device)
    bbox = torch.where(straddle[..., None], full, bbox)
    valid = valid | (straddle & orient_h)
    wsign = torch.where(straddle[..., None] & (w <= 0), -1.0, 1.0).to(w.dtype)
    return dict(abc=abc, zpln=zpln, bbox=bbox, valid=valid, wsign=wsign)


def pack_setup_rows(setup: Dict[str, torch.Tensor]) -> torch.Tensor:
    """face_setup dict -> (B, F, SETUP_ROW) f32 rows in K1's layout."""
    B, F = setup["valid"].shape
    return torch.cat([
        setup["abc"].reshape(B, F, 6), setup["zpln"], setup["bbox"],
        setup["wsign"], setup["valid"].to(torch.float32)[..., None],
        setup["zpln"].new_zeros(B, F, 3)], dim=-1).contiguous()


def pixel_grid(H: int, W: int, dtype=torch.float32, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC coordinates of pixel centers, (1, W) and (H, 1); row 0 = bottom."""
    px = (torch.arange(W, dtype=dtype, device=device) + 0.5) * (2.0 / W) - 1.0
    py = (torch.arange(H, dtype=dtype, device=device) + 0.5) * (2.0 / H) - 1.0
    return px[None, :], py[:, None]


# ---------------------------------------------------------------------------
# Visibility: plain version and kernel K1
# ---------------------------------------------------------------------------

def visibility_plain(verts_clip: torch.Tensor, faces: torch.Tensor, H: int,
                     W: int, cull_backfaces: bool = True):
    """Chunked brute force with a running (z, id) buffer
    (vhap_tpu/ops/rasterize.py:199-253). Returns (tri_id (B,H,W) int32, 0).
    Faces go PLAIN_CHUNK at a time: (B, 64, H, W) temporaries, 1 GiB each
    at batch 16 and 512x512.

    Within a chunk torch.min picks the first minimal face; across chunks
    only a strictly nearer z replaces the winner: equal z goes to the lowest
    face id. Each product and sum is its own elementwise op, so K1 (built
    with --fmad=false) reproduces this bit for bit on the card.
    """
    verts_clip = verts_clip.detach()
    B = verts_clip.shape[0]
    F = faces.shape[0]
    dev = verts_clip.device
    s = face_setup(verts_clip, faces, cull_backfaces)
    px, py = pixel_grid(H, W, device=dev)
    best_z = torch.full((B, H, W), float("inf"), device=dev)
    best_id = torch.zeros((B, H, W), dtype=torch.int32, device=dev)

    def col(x):   # (B, c) -> (B, c, 1, 1)
        return x[..., None, None]

    for base in range(0, F, PLAIN_CHUNK):
        sl = slice(base, min(base + PLAIN_CHUNK, F))
        abc, zp = s["abc"][:, sl], s["zpln"][:, sl]
        ws, valid = s["wsign"][:, sl], s["valid"][:, sl]
        b0 = col(abc[..., 0, 0]) * px + col(abc[..., 0, 1]) * py + col(abc[..., 0, 2])
        b1 = col(abc[..., 1, 0]) * px + col(abc[..., 1, 1]) * py + col(abc[..., 1, 2])
        b2 = 1.0 - b0 - b1
        z = col(zp[..., 0]) * px + col(zp[..., 1]) * py + col(zp[..., 2])
        inside = ((col(ws[..., 0]) * b0 >= 0) & (col(ws[..., 1]) * b1 >= 0)
                  & (col(ws[..., 2]) * b2 >= 0) & col(valid)
                  & (z >= -1.0) & (z <= 1.0))
        z = torch.where(inside, z, torch.full_like(z, float("inf")))
        zmin, k = torch.min(z, dim=1)
        upd = zmin < best_z
        best_z = torch.where(upd, zmin, best_z)
        best_id = torch.where(upd, (k + base + 1).to(torch.int32), best_id)
    return best_id, 0


# K1's tile binning (csrc/visibility.cu): 16 x 16 pixel tiles; a face over
# more than VIS_TILE_FACES tiles goes to its image's shared list, and so
# does a face whose tile list already holds VIS_TILE_CAP faces
VIS_TILE = 16
VIS_TILE_FACES = 16
VIS_TILE_CAP = 1024


def _first_last_pixel(lo: torch.Tensor, hi: torch.Tensor, s: float, n: int):
    """First / last pixel whose center (k + 0.5) * s - 1 may lie in [lo, hi],
    widened by one and clamped to [0, n - 1]: csrc/visibility.cu's
    first_pixel / last_pixel, in the same float32 steps."""
    def t(x):
        return torch.fmin(torch.fmax((x + 1.0) / x.new_tensor(s) - 0.5,
                                     x.new_tensor(-2.0)),
                          x.new_tensor(float(n) + 1.0))
    first = torch.clamp(torch.floor(t(lo)).to(torch.int64) - 1, min=0)
    last = torch.clamp(torch.ceil(t(hi)).to(torch.int64) + 1, max=n - 1)
    return first, last


def face_pixel_boxes(rows: torch.Tensor, H: int, W: int):
    """K1's per-face pixel box from (B, F, SETUP_ROW) setup rows: (i0, i1,
    j0, j1) int64 (B, F) each, inclusive, and `live` (B, F): the face is
    valid and its box is not empty. Mirrors the kernel's arithmetic."""
    j0, j1 = _first_last_pixel(rows[..., 9], rows[..., 11], 2.0 / W, W)
    i0, i1 = _first_last_pixel(rows[..., 10], rows[..., 12], 2.0 / H, H)
    live = (rows[..., 16] != 0) & (j0 <= j1) & (i0 <= i1)
    return i0, i1, j0, j1, live


def tile_bins_plain(rows: torch.Tensor, H: int, W: int):
    """K1's binning, plainly (a (B, T, F) table: for small inputs).
    Returns (listed (B, T, F) bool: face f is a candidate of tile t, tiles
    row by row; large (B, F) bool: f goes to its image's shared list, which
    every tile tests). A live face over at most VIS_TILE_FACES tiles is
    listed in each tile its pixel box meets; a larger one is large. The
    kernel keeps at most VIS_TILE_CAP of a tile's candidates in its list
    and moves the others, in the order of its atomics, to the shared list:
    a tile whose listed.sum(-1) exceeds VIS_TILE_CAP spills."""
    i0, i1, j0, j1, live = face_pixel_boxes(rows, H, W)
    ty = torch.arange(-(-H // VIS_TILE), device=rows.device)
    tx = torch.arange(-(-W // VIS_TILE), device=rows.device)
    n_tiles = (i1 // VIS_TILE - i0 // VIS_TILE + 1) * (
        j1 // VIS_TILE - j0 // VIS_TILE + 1)
    large = live & (n_tiles > VIS_TILE_FACES)
    in_y = ((ty[None, :, None] >= (i0 // VIS_TILE)[:, None])
            & (ty[None, :, None] <= (i1 // VIS_TILE)[:, None]))   # (B, TY, F)
    in_x = ((tx[None, :, None] >= (j0 // VIS_TILE)[:, None])
            & (tx[None, :, None] <= (j1 // VIS_TILE)[:, None]))   # (B, TX, F)
    listed = in_y[:, :, None] & in_x[:, None] & (live & ~large)[:, None, None]
    return listed.reshape(rows.shape[0], -1, rows.shape[1]), large


VISIBILITY = Kernel("visibility", "vhap_visibility",
                    [c_ptr, c_int, c_int, c_int, c_int, c_float, c_float,
                     c_ptr, c_ptr])


@functools.lru_cache(maxsize=64)
def _scratch_ints(B: int, F: int, H: int, W: int) -> int:
    """int32 scratch K1 takes at these shapes; the kernel's C interface owns
    the layout. From shapes alone: the step never reads a device count."""
    fn = library().vhap_visibility_scratch_ints
    fn.argtypes, fn.restype = [c_int] * 4, ctypes.c_longlong
    return fn(B, F, H, W)


class _Visibility(torch.autograd.Function):
    """K1 launch. tri_id is an integer map: visibility carries no gradient,
    in the reference as here (the JAX package stop-gradients verts_clip)."""

    @staticmethod
    def forward(ctx, rows, H, W):
        check_cuda_tensor("setup rows", rows, torch.float32, 3)
        B, F, width = rows.shape
        if width != SETUP_ROW:
            raise ValueError(f"setup rows must be (B, F, {SETUP_ROW})")
        if B * F * VIS_TILE_FACES >= 2**31:
            raise ValueError(f"{B} x {F} faces overflow K1's int32 tile lists")
        scratch = torch.empty(_scratch_ints(B, F, H, W), dtype=torch.int32,
                              device=rows.device)
        tri_id = torch.empty((B, H, W), dtype=torch.int32, device=rows.device)
        VISIBILITY(rows.data_ptr(), B, F, H, W, 2.0 / W, 2.0 / H,
                   scratch.data_ptr(), tri_id.data_ptr())
        ctx.mark_non_differentiable(tri_id)
        return tri_id

    @staticmethod
    def backward(ctx, grad):
        return None, None, None


def visibility(verts_clip: torch.Tensor, faces: torch.Tensor, H: int, W: int,
               cull_backfaces: bool = True):
    """Per-pixel winning face: (tri_id (B, H, W) int32, overflow = 0).

    CUDA tensors go through kernel K1; CPU tensors through
    `visibility_plain`.
    """
    if verts_clip.device.type == "cpu":
        return visibility_plain(verts_clip, faces, H, W, cull_backfaces)
    setup = face_setup(verts_clip.detach(), faces, cull_backfaces)
    return _Visibility.apply(pack_setup_rows(setup), H, W), 0


# ---------------------------------------------------------------------------
# Differentiable per-face attribute planes
# ---------------------------------------------------------------------------

def face_attribute_planes(verts_clip: torch.Tensor,
                          faces: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Differentiable per-face coefficients, dict of (B, F) tensors
    (vhap_tpu/ops/rasterize.py:403-458, clip_straddling=True):
      a0x a0y a0c a1x a1y a1c   affine barycentric planes of b0, b1 (NDC)
      iw0 iw1 iw2               1 / clip-w per corner (sign-preserving)
      z0 z1 z2                  z/w per corner
    """
    v = verts_clip[:, faces]                   # (B, F, 3, 4)
    w = v[..., 3]
    w_safe = torch.where(torch.abs(w) > W_EPS, w,
                         torch.where(w < 0, -W_EPS, W_EPS).to(w.dtype))
    sx = v[..., 0] / w_safe
    sy = v[..., 1] / w_safe
    szw = v[..., 2] / w_safe

    x0, x1, x2 = sx[..., 0], sx[..., 1], sx[..., 2]
    y0, y1, y2 = sy[..., 0], sy[..., 1], sy[..., 2]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    ok = torch.abs(area) > AREA_EPS
    inv_area = _where0(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)))

    a0x = (y1 - y2) * inv_area
    a0y = (x2 - x1) * inv_area
    a0c = -(a0x * x2 + a0y * y2)
    a1x = (y2 - y0) * inv_area
    a1y = (x0 - x2) * inv_area
    a1c = -(a1x * x2 + a1y * y2)

    out = dict(
        a0x=a0x, a0y=a0y, a0c=a0c, a1x=a1x, a1y=a1y, a1c=a1c,
        iw0=1.0 / w_safe[..., 0], iw1=1.0 / w_safe[..., 1],
        iw2=1.0 / w_safe[..., 2],
        z0=szw[..., 0], z1=szw[..., 1], z2=szw[..., 2],
    )
    # straddlers: the clipless b0/b1 planes; n_i = b_i * iw_i (signed iw)
    # then stays exact on their visible part
    straddle = torch.any(w > W_EPS, dim=-1) & ~torch.all(w > W_EPS, dim=-1)
    abc_h, _, _ = _homogeneous_planes(v)
    for i, k in enumerate(("a0x", "a0y", "a0c")):
        out[k] = torch.where(straddle, abc_h[..., 0, i], out[k])
    for i, k in enumerate(("a1x", "a1y", "a1c")):
        out[k] = torch.where(straddle, abc_h[..., 1, i], out[k])
    return out


# ---------------------------------------------------------------------------
# The nvdiffrast-style API: rasterize -> (rast, rast_db), interpolate
# ---------------------------------------------------------------------------

def gather_face_planes_packed(tables: torch.Tensor,
                              fid: torch.Tensor) -> List[torch.Tensor]:
    """(B|1, C, F) packed face tables -> list of C (B, H, W) pixel planes
    for the face ids fid (B, H, W) >= 0 (vhap_tpu/ops/rasterize.py:468)."""
    return list(plane_gather(tables, (fid + 1).to(torch.int32)).unbind(1))


def gather_face_plane(table: torch.Tensor, fid: torch.Tensor) -> torch.Tensor:
    """(B, F) face table -> (B, H, W) per-pixel plane via face ids fid."""
    return gather_face_planes_packed(table[:, None], fid)[0]


def rast_tables(verts_clip: torch.Tensor, faces: torch.Tensor,
                extra_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B, 12 + CE, F) table `fused_rast_and_planes` gathers: the
    PLANE_KEYS rows, then extra_tables (B|1, CE, F) when given."""
    p = face_attribute_planes(verts_clip, faces)
    packed = torch.stack([p[k] for k in PLANE_KEYS], dim=1)
    if extra_tables is not None:
        packed = torch.cat(
            [packed, extra_tables.expand(packed.shape[0], -1, -1)], dim=1)
    return packed


def fused_rast_and_planes(verts_clip: torch.Tensor, faces: torch.Tensor,
                          tri_id: torch.Tensor,
                          extra_tables: Optional[torch.Tensor],
                          use_kernels: bool = True):
    """rasterize_attributes + extra per-face channels in one per-pixel
    gather (vhap_tpu/ops/rasterize.py:507-596, without tile lists).

    Returns (rast (B,H,W,4), rast_db (B,H,W,4), extra planes: a list of CE
    (B, H, W) planes, plane_overflow = 0). The extra planes are not masked:
    background pixels carry face 0's values, as in the JAX gather.
    """
    H, W = tri_id.shape[1:]
    gather = plane_gather if use_kernels else plane_gather_plain
    planes = gather(rast_tables(verts_clip, faces, extra_tables), tri_id)
    (a0x, a0y, a0c, a1x, a1y, a1c,
     iw0, iw1, iw2, z0, z1, z2) = planes[:, :len(PLANE_KEYS)].unbind(1)
    extra_planes = list(planes[:, len(PLANE_KEYS):].unbind(1))

    px, py = pixel_grid(H, W, device=planes.device)
    b0 = a0x * px + a0y * py + a0c
    b1 = a1x * px + a1y * py + a1c
    b2 = 1.0 - b0 - b1

    zw = b0 * z0 + b1 * z1 + b2 * z2               # affine z/w

    n0, n1, n2 = b0 * iw0, b1 * iw1, b2 * iw2      # perspective-correct
    S = n0 + n1 + n2
    S = torch.where(torch.abs(S) > 1e-12, S, torch.full_like(S, 1e-12))
    u = n0 / S
    vv = n1 / S

    a2x, a2y = -(a0x + a1x), -(a0y + a1y)
    n0x, n0y = a0x * iw0, a0y * iw0
    n1x, n1y = a1x * iw1, a1y * iw1
    n2x, n2y = a2x * iw2, a2y * iw2
    Sx, Sy = n0x + n1x + n2x, n0y + n1y + n2y
    inv_S2 = 1.0 / (S * S)
    dudx = (n0x * S - n0 * Sx) * inv_S2 * (2.0 / W)
    dudy = (n0y * S - n0 * Sy) * inv_S2 * (2.0 / H)
    dvdx = (n1x * S - n1 * Sx) * inv_S2 * (2.0 / W)
    dvdy = (n1y * S - n1 * Sy) * inv_S2 * (2.0 / H)

    m = (tri_id > 0).to(u.dtype)
    rast = torch.stack([u * m, vv * m, zw * m, tri_id.to(u.dtype)], dim=-1)
    rast_db = torch.stack([dudx * m, dudy * m, dvdx * m, dvdy * m], dim=-1)
    return rast, rast_db, extra_planes, 0


def rasterize_attributes(verts_clip: torch.Tensor, faces: torch.Tensor,
                         tri_id: torch.Tensor, use_kernels: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v, z/w, tri_id) and the uv pixel derivatives of the winning
    faces, differentiable with respect to verts_clip (visibility frozen, as
    in nvdiffrast). Returns rast (B, H, W, 4), rast_db (B, H, W, 4) =
    (du/dx, du/dy, dv/dx, dv/dy) in pixel units."""
    rast, rast_db, _, _ = fused_rast_and_planes(verts_clip, faces, tri_id,
                                                None, use_kernels)
    return rast, rast_db


def rasterize(verts_clip: torch.Tensor, faces: torch.Tensor,
              image_size: Tuple[int, int], cull_backfaces: bool = True,
              grad_enabled: bool = True, with_overflow: bool = False,
              use_kernels: bool = True):
    """Full rasterization, nvdiffrast's `dr.rasterize`
    (vhap_tpu/ops/rasterize.py:743-772): visibility + differentiable
    attributes. Returns (rast, rast_db, tri_id (B, H, W) int32), plus the
    dropped-faces count (always 0: no bin budget) with with_overflow.

    Visibility runs kernel K1 for CUDA tensors (the JAX package's K5 on
    this path computes the same winner); use_kernels=False takes every
    plain version instead.
    """
    H, W = image_size
    vis = visibility if use_kernels else visibility_plain
    tri_id, overflow = vis(verts_clip.detach(), faces, H, W, cull_backfaces)
    if not grad_enabled:
        verts_clip = verts_clip.detach()
    rast, rast_db = rasterize_attributes(verts_clip, faces, tri_id, use_kernels)
    if with_overflow:
        return rast, rast_db, tri_id, overflow
    return rast, rast_db, tri_id


def corner_tables(attr: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Vertex attributes (B|1, Va, C) -> the (B|1, 3C, F) corner table
    `interpolate` gathers: corner 0's C rows, then corner 1's, then 2's."""
    return torch.cat([attr[:, faces[:, k], :].transpose(1, 2)
                      for k in range(3)], dim=1).contiguous()


def interpolate(attr: torch.Tensor, rast: torch.Tensor, faces: torch.Tensor,
                rast_db: Optional[torch.Tensor] = None,
                diff_attrs: Optional[str] = None, use_kernels: bool = True):
    """Barycentric attribute interpolation, nvdiffrast's `dr.interpolate`
    (vhap_tpu/ops/rasterize.py:775-823).

    attr (B|1, Va, C); rast (B, H, W, 4) from `rasterize` (its tri_id in
    channel 3); faces (F, 3) indices into attr. Returns ((B, H, W, C),
    None), or with rast_db and diff_attrs='all' also the screen derivatives
    (B, H, W, 2C): the C x-derivatives, then the C y-derivatives (the JAX
    package's order).
    """
    C = attr.shape[-1]
    tri_id = rast[..., 3].to(torch.int32)
    m = (tri_id > 0).to(rast.dtype)[:, None]
    gather = plane_gather if use_kernels else plane_gather_plain
    planes = gather(corner_tables(attr, faces), tri_id)
    a0, a1, a2 = planes[:, :C], planes[:, C:2 * C], planes[:, 2 * C:]

    u = rast[..., 0][:, None]
    v = rast[..., 1][:, None]
    w2 = 1.0 - u - v
    out = ((u * a0 + v * a1 + w2 * a2) * m).permute(0, 2, 3, 1)
    if diff_attrs is None:
        return out, None
    if rast_db is None:
        raise ValueError("diff_attrs needs rast_db")
    dudx, dudy = rast_db[..., 0][:, None], rast_db[..., 1][:, None]
    dvdx, dvdy = rast_db[..., 2][:, None], rast_db[..., 3][:, None]
    dadx = (dudx * (a0 - a2) + dvdx * (a1 - a2)) * m
    dady = (dudy * (a0 - a2) + dvdy * (a1 - a2)) * m
    return out, torch.cat([dadx, dady], dim=1).permute(0, 2, 3, 1)
