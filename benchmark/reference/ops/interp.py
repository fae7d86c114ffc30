"""Fused deferred interpolation: per-pixel attributes from face tables.

Counterpart of vhap_tpu/ops/interp_pallas.py (the forward of
`fused_interp_flat`). Given the winning face of every pixel, one pass
computes the whole per-pixel chain of the render: barycentrics,
perspective division, z/w, uv screen derivatives, normal and uv
interpolation, and passes the vertex ids, flag rows and antialias planes
through. `fused_interp_plain` is the plain version of the port's kernel
K2f (autograd gives the backward, the port's K2b); `split_channels` cuts
its channels into an `InterpOut` (zw, texc, texd, normal, vertex ids,
flags, AA planes, match).

Input face table (B, C, F), C = 36 + nf:
  [0:12)  PLANE_KEYS: a0x a0y a0c a1x a1y a1c iw0 iw1 iw2 z0 z1 z2
  [12:21) corner normals n0.xyz n1.xyz n2.xyz (corner-major)
  [21:27) corner uvs uv0.uv uv1.uv uv2.uv
  [27:30) corner vertex ids (as f32)
  [30:30+nf) per-face flag rows
  [30+nf:36+nf) AA edge planes (AA_PLANE_KEYS order)

Output image layout (B, CO, H, W), CO = 20 + nf:
  [0]     zw          [1:3]  texc.uv      [3:7] texd dudx' dvdx' dudy' dvdy'
  [7:10]  unit normal [10:13) corner vertex ids
  [13:13+nf) flags    [13+nf:19+nf) AA planes
  [19+nf] match (1 on foreground)
Background pixels carry 0 in every channel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.ops.rasterize import pixel_grid

N_FIXED_IN = 36    # input rows besides the nf flag rows
N_FIXED_OUT = 20   # output rows besides the nf flag rows (incl. match)


def pixel_math(s: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
               m: torch.Tensor, *, n_flags: int, img_h: int, img_w: int):
    """(C_in, ...) resolved rows -> (20 + nf, ...) processed channels.

    A faithful copy of `_pixel_math` (vhap_tpu/ops/interp_pallas.py:72-138),
    operation for operation, including the mask multiplications; `m` is
    the foreground mask (1.0 / 0.0).
    """
    nf = n_flags
    a0x, a0y, a0c = s[0], s[1], s[2]
    a1x, a1y, a1c = s[3], s[4], s[5]
    iw0, iw1, iw2 = s[6], s[7], s[8]
    z0, z1, z2 = s[9], s[10], s[11]
    nrm = s[12:21]
    uvp = s[21:27]
    vids = s[27:30]
    flags = s[30:30 + nf]
    aa = s[30 + nf:36 + nf]
    match = s[36 + nf:37 + nf]

    b0 = a0x * px + a0y * py + a0c
    b1 = a1x * px + a1y * py + a1c
    b2 = 1.0 - b0 - b1

    zw = (b0 * z0 + b1 * z1 + b2 * z2) * m

    n0, n1, n2 = b0 * iw0, b1 * iw1, b2 * iw2
    S = n0 + n1 + n2
    S = torch.where(torch.abs(S) > 1e-12, S, torch.full_like(S, 1e-12))
    u = (n0 / S) * m
    v = (n1 / S) * m
    w2 = (1.0 - u - v) * m

    a2x, a2y = -(a0x + a1x), -(a0y + a1y)
    n0x, n0y = a0x * iw0, a0y * iw0
    n1x, n1y = a1x * iw1, a1y * iw1
    n2x, n2y = a2x * iw2, a2y * iw2
    Sx, Sy = n0x + n1x + n2x, n0y + n1y + n2y
    inv_S2 = 1.0 / (S * S)
    dudx = (n0x * S - n0 * Sx) * inv_S2 * (2.0 / img_w) * m
    dudy = (n0y * S - n0 * Sy) * inv_S2 * (2.0 / img_h) * m
    dvdx = (n1x * S - n1 * Sx) * inv_S2 * (2.0 / img_w) * m
    dvdy = (n1y * S - n1 * Sy) * inv_S2 * (2.0 / img_h) * m

    def interp3(c0, c1, c2):
        return u * c0 + v * c1 + w2 * c2

    nx = interp3(nrm[0], nrm[3], nrm[6])
    ny = interp3(nrm[1], nrm[4], nrm[7])
    nz = interp3(nrm[2], nrm[5], nrm[8])
    # safe_normalize (ops/shading.py): eps-clamped length
    nlen = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen

    tcu = interp3(uvp[0], uvp[2], uvp[4])
    tcv = interp3(uvp[1], uvp[3], uvp[5])

    du_u, du_v = uvp[0] - uvp[4], uvp[1] - uvp[5]
    dv_u, dv_v = uvp[2] - uvp[4], uvp[3] - uvp[5]
    texd0 = dudx * du_u + dvdx * dv_u
    texd1 = dudx * du_v + dvdx * dv_v
    texd2 = dudy * du_u + dvdy * dv_u
    texd3 = dudy * du_v + dvdy * dv_v

    rows = [zw, tcu, tcv, texd0, texd1, texd2, texd3, nx, ny, nz]
    return torch.cat([torch.stack(rows), vids, flags, aa, match], dim=0)


def fused_interp_plain(packed: torch.Tensor, tri_id: torch.Tensor,
                       n_flags: int):
    """Plain version of K2f: (B, 36+nf, F) tables + tri_id (B, H, W) ->
    ((B, 20+nf, H, W) channels, overflow = 0)."""
    B, H, W = tri_id.shape
    C = packed.shape[1]
    if C != N_FIXED_IN + n_flags:
        raise ValueError(f"face table has {C} rows, expected {N_FIXED_IN + n_flags}")
    fg = tri_id > 0
    fid = torch.clamp(tri_id.long() - 1, min=0).reshape(B, 1, H * W)
    rows = torch.gather(packed, 2, fid.expand(B, C, H * W))      # (B, C, P)
    ones = torch.ones_like(rows[:, :1])
    s = torch.cat([rows, ones], dim=1).reshape(B, C + 1, H, W).transpose(0, 1)
    px, py = pixel_grid(H, W, device=packed.device)
    m = fg.to(packed.dtype)
    out = pixel_math(s, px, py, m, n_flags=n_flags, img_h=H, img_w=W)
    out = out.transpose(0, 1)                                     # (B, CO, H, W)
    return torch.where(fg[:, None], out, torch.zeros_like(out)), 0


class InterpOut(NamedTuple):
    """The fused interpolation's outputs, one per group of channels of the
    (B, 20+nf, H, W) layout above; each (B, c, H, W), zw and match (B, H, W)."""
    zw: torch.Tensor
    texc: torch.Tensor
    texd: torch.Tensor
    normal: torch.Tensor
    vids: torch.Tensor
    flags: torch.Tensor
    aa: torch.Tensor
    match: torch.Tensor


def group_slices(n_flags: int):
    """Channel range of each InterpOut field in the (B, 20+nf, H, W) layout."""
    nf = n_flags
    return dict(zw=0, texc=slice(1, 3), texd=slice(3, 7), normal=slice(7, 10),
                vids=slice(10, 13), flags=slice(13, 13 + nf),
                aa=slice(13 + nf, 19 + nf), match=19 + nf)


def split_channels(chans: torch.Tensor, n_flags: int) -> InterpOut:
    """(B, 20+nf, H, W) channels -> InterpOut of views of them."""
    return InterpOut(**{k: chans[:, sl] for k, sl in group_slices(n_flags).items()})
