"""Analytic silhouette antialiasing with vertex-position gradients.

Counterpart of vhap_tpu/ops/antialias.py (the role of nvdiffrast's
`dr.antialias`, vhap/util/render_nvdiffrast.py:463-466), in image layout:

  * a horizontal or vertical pixel pair participates when its two pixels
    have different face ids and the boundary is a silhouette (one side is
    background, or the two faces share fewer than two corners);
  * the foreground pixel is the one covered by the nearer (or only) face;
    that face's edges are intersected with the segment between the two
    pixel centers, giving the crossing t in [0, 1] from the affine
    barycentric planes (differentiable w.r.t. the clip-space vertices);
  * if t > 1/2 the neighbour receives w = t - 1/2 of the foreground color;
    if t < 1/2 the foreground pixel receives w = 1/2 - t of the neighbour's;
  * each edge is owned by its dominant axis, so diagonal edges are not
    blended by both passes.

`antialias` takes the per-pixel planes the caller already has (the fused
interpolation's channels on the training path); `antialias_rast`, the
nvdiffrast form, takes (color, rast, verts_clip, faces) and looks its
planes up through the plane gather (kernel K6) first.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from vhap_tpu_torch.device import constant
from vhap_tpu_torch.ops.plane_gather import plane_gather, plane_gather_plain
from vhap_tpu_torch.ops.rasterize import face_attribute_planes, pixel_grid

AA_PLANE_KEYS = ("a0x", "a0y", "a0c", "a1x", "a1y", "a1c")


def _pixel_planes(vid_planes: Sequence[torch.Tensor],
                  a_planes: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-pixel edge planes + corner vertex ids of the winning face, from
    the fused interpolation's vid and AA channels."""
    out = dict(zip(AA_PLANE_KEYS, a_planes))
    out["a2x"] = -(out["a0x"] + out["a1x"])
    out["a2y"] = -(out["a0y"] + out["a1y"])
    out["a2c"] = 1.0 - out["a0c"] - out["a1c"]
    for k in range(3):
        out[f"vid{k}"] = vid_planes[k]
    return out


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with its derivative: at either bound half the gradient
    passes (torch.clamp passes all of it). An edge through a pixel pair's
    midpoint puts t exactly on a bound."""
    return torch.minimum(torch.maximum(x, constant(lo, x.dtype, x.device)),
                         constant(hi, x.dtype, x.device))


def _pair_weights(tri_id_p, tri_id_q, zw_p, zw_q, pl_p, pl_q,
                  cx_p, cy_p, cx_q, cy_q, horizontal: bool):
    """Edge-crossing blend weights for adjacent pixel pairs p, q
    (vhap_tpu/ops/antialias.py:71-131). Returns (w_f, w_o, p_is_fg)."""
    differs = tri_id_p != tri_id_q
    both_fg = (tri_id_p > 0) & (tri_id_q > 0)

    # interior edges (two shared corners) are not antialiased
    shared = torch.zeros(tri_id_p.shape, dtype=torch.int32, device=tri_id_p.device)
    for i in range(3):
        for j in range(3):
            shared = shared + (pl_p[f"vid{i}"] == pl_q[f"vid{j}"]).to(torch.int32)
    silhouette = torch.where(both_fg, shared < 2, True)
    active = differs & silhouette & ((tri_id_p > 0) | (tri_id_q > 0))

    # foreground side: covered and nearer
    p_is_fg = torch.where(both_fg, zw_p < zw_q, tri_id_p > 0)

    def sel(a, b):
        return torch.where(p_is_fg, a, b)

    cx_f, cy_f = sel(cx_p, cx_q), sel(cy_p, cy_q)
    cx_o, cy_o = sel(cx_q, cx_p), sel(cy_q, cy_p)

    # edge crossing between the centers for each of the fg face's 3 edges
    t_star = ax_star = ay_star = None
    for i in range(3):
        ax = sel(pl_p[f"a{i}x"], pl_q[f"a{i}x"])
        ay = sel(pl_p[f"a{i}y"], pl_q[f"a{i}y"])
        ac = sel(pl_p[f"a{i}c"], pl_q[f"a{i}c"])
        bf = ax * cx_f + ay * cy_f + ac
        bo = ax * cx_o + ay * cy_o + ac
        denom = bf - bo
        denom = torch.where(torch.abs(denom) > 1e-12, denom,
                            torch.full_like(denom, 1e-12))
        t = bf / denom
        crossing = (bf >= 0) & (bo < 0)
        t = torch.where(crossing, t, torch.full_like(t, 2.0))  # inactive edge
        if t_star is None:
            t_star, ax_star, ay_star = t, ax, ay
        else:
            closer = t < t_star
            ax_star = torch.where(closer, ax, ax_star)
            ay_star = torch.where(closer, ay, ay_star)
            t_star = torch.minimum(t, t_star)

    has_cross = t_star <= 1.0
    t_star = _clip(t_star, 0.0, 1.0)

    # dominant-axis ownership: |ax| >= |ay| <=> edge is more vertical
    axis_ok = (torch.abs(ax_star) >= torch.abs(ay_star) if horizontal
               else torch.abs(ay_star) > torch.abs(ax_star))

    w = t_star - 0.5
    active = active & has_cross & axis_ok
    w_o = _clip(w, 0.0, 0.5) * active
    w_f = _clip(-w, 0.0, 0.5) * active
    return w_f, w_o, p_is_fg


def _pair_blend(color_p, color_q, tri_id_p, tri_id_q, zw_p, zw_q,
                pl_p, pl_q, cx_p, cy_p, cx_q, cy_q, horizontal: bool):
    """Blend deltas for adjacent pixel pairs p, q."""
    w_f, w_o, p_is_fg = _pair_weights(
        tri_id_p, tri_id_q, zw_p, zw_q, pl_p, pl_q,
        cx_p, cy_p, cx_q, cy_q, horizontal)
    fg = p_is_fg[..., None]
    color_f = torch.where(fg, color_p, color_q)
    color_o = torch.where(fg, color_q, color_p)
    delta_f = w_f.to(color_f.dtype)[..., None] * (color_o - color_f)
    delta_o = w_o.to(color_f.dtype)[..., None] * (color_f - color_o)
    return torch.where(fg, delta_f, delta_o), torch.where(fg, delta_o, delta_f)


def antialias(color: torch.Tensor, tri_id: torch.Tensor, zw: torch.Tensor,
              vid_planes: Sequence[torch.Tensor],
              a_planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Edge antialiasing (nvdiffrast `dr.antialias` role).

    color (B, H, W, C); tri_id (B, H, W); zw (B, H, W) z/w of the winning
    face; vid_planes 3 and a_planes 6 (B, H, W) per-pixel corner vertex ids
    and b0/b1 edge planes of the (possibly boundary-detached) clip verts.
    The JAX version's `out.at[...].add` updates become out-of-place adds of
    the zero-padded pair deltas.
    """
    B, H, W, C = color.shape
    pl = _pixel_planes(vid_planes, a_planes)
    px, py = pixel_grid(H, W, device=color.device)
    cx = px.expand(H, W)
    cy = py.expand(H, W)

    out = color

    # horizontal pairs: p = (i, j), q = (i, j+1)
    dp, dq = _pair_blend(
        color[:, :, :-1], color[:, :, 1:],
        tri_id[:, :, :-1], tri_id[:, :, 1:],
        zw[:, :, :-1], zw[:, :, 1:],
        {k: v[:, :, :-1] for k, v in pl.items()},
        {k: v[:, :, 1:] for k, v in pl.items()},
        cx[:, :-1], cy[:, :-1], cx[:, 1:], cy[:, 1:], horizontal=True)
    out = out + F.pad(dp, (0, 0, 0, 1))
    out = out + F.pad(dq, (0, 0, 1, 0))

    # vertical pairs: p = (i, j), q = (i+1, j)
    dp, dq = _pair_blend(
        color[:, :-1], color[:, 1:],
        tri_id[:, :-1], tri_id[:, 1:],
        zw[:, :-1], zw[:, 1:],
        {k: v[:, :-1] for k, v in pl.items()},
        {k: v[:, 1:] for k, v in pl.items()},
        cx[:-1], cy[:-1], cx[1:], cy[1:], horizontal=False)
    out = out + F.pad(dp, (0, 0, 0, 0, 0, 1))
    out = out + F.pad(dq, (0, 0, 0, 0, 1, 0))
    return out


def aa_tables(verts_clip: torch.Tensor, faces: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two tables `antialias_rast` gathers: the 6 edge planes (B, 6, F),
    differentiable with respect to verts_clip, and the corner vertex ids
    (1, 3, F) as float32 (exact below 2^24)."""
    p = face_attribute_planes(verts_clip, faces)
    return (torch.stack([p[k] for k in AA_PLANE_KEYS], dim=1),
            faces.T[None].to(torch.float32).contiguous())


def antialias_rast(color: torch.Tensor, rast: torch.Tensor,
                   verts_clip: torch.Tensor, faces: torch.Tensor,
                   use_kernels: bool = True) -> torch.Tensor:
    """Edge antialiasing in nvdiffrast's form, `dr.antialias(color, rast,
    pos, tri)` (vhap_tpu/ops/antialias.py:154-198).

    color (B, H, W, C); rast (B, H, W, 4) from `rasterize` (z/w in channel
    2, tri_id in 3); verts_clip (B, V, 4), possibly with rows detached for
    boundary control; faces (F, 3). The winning face's edge planes and
    vertex ids are looked up per pixel (kernel K6 for CUDA tensors unless
    use_kernels=False), then the pair passes of `antialias` run.
    """
    gather = plane_gather if use_kernels else plane_gather_plain
    tri_id = rast[..., 3].to(torch.int32)
    aa_tab, vid_tab = aa_tables(verts_clip, faces)
    a_planes = gather(aa_tab, tri_id).unbind(1)
    vid_planes = [v.to(torch.int32) for v in gather(vid_tab, tri_id).unbind(1)]
    return antialias(color, tri_id, rast[..., 2], vid_planes, a_planes)
