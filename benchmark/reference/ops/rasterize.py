"""Rasterizer geometry and visibility, plainly.

Counterpart of vhap_tpu/ops/rasterize.py (reference: nvdiffrast's
`dr.rasterize`, vhap/util/render_nvdiffrast.py:247-260) in two phases:

1. **Visibility** (not differentiable): the per-pixel winning face id.
   `visibility_plain` is a chunked brute force like `_visibility_xla`. It
   returns tri_id = face id + 1, 0 = background, with no bin budget, so
   the overflow count is always 0.
2. **Attributes** (differentiable): per-face plane tables from clip-space
   vertices (`face_attribute_planes`), evaluated per pixel by the fused
   interpolation (ops/interp.py).

Near-plane straddlers follow the JAX `xla` backend. A face with some but
not all corners at w > eps is kept with the clipless homogeneous setup
(`_homogeneous_planes`), a full-screen bounding box and per-corner
coverage signs, so its visible part renders as nvdiffrast's clipping
renders it. Heads never straddle.

Conventions match nvdiffrast: pixel (i, j) covers NDC
x = (j+0.5)/W*2-1, y = (i+0.5)/H*2-1 (row 0 = bottom, y up).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


W_EPS = 1e-6     # minimum clip w for a usable vertex
AREA_EPS = 1e-12  # minimum |signed area| (NDC^2) for a non-degenerate face

PLANE_KEYS = ("a0x", "a0y", "a0c", "a1x", "a1y", "a1c",
              "iw0", "iw1", "iw2", "z0", "z1", "z2")

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
    full = torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=bbox.dtype,
                        device=bbox.device)
    bbox = torch.where(straddle[..., None], full, bbox)
    valid = valid | (straddle & orient_h)
    wsign = torch.where(straddle[..., None] & (w <= 0), -1.0, 1.0).to(w.dtype)
    return dict(abc=abc, zpln=zpln, bbox=bbox, valid=valid, wsign=wsign)


def pixel_grid(H: int, W: int, dtype=torch.float32, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC coordinates of pixel centers, (1, W) and (H, 1); row 0 = bottom."""
    px = (torch.arange(W, dtype=dtype, device=device) + 0.5) * (2.0 / W) - 1.0
    py = (torch.arange(H, dtype=dtype, device=device) + 0.5) * (2.0 / H) - 1.0
    return px[None, :], py[:, None]


# ---------------------------------------------------------------------------
# Visibility
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
