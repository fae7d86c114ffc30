"""UV-space rasterization (vhap_tpu/ops/render_uvmap.py; reference:
vhap/util/render_uvmap.py).

Renders the UV layout itself (uv verts as positions) with vertex colors or
a texture: used to bake per-region texel masks and for debugging. Runs on
the device of its inputs; use_kernels=False takes every kernel's plain
version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vhap_tpu_torch.ops.antialias import antialias_rast
from vhap_tpu_torch.ops.rasterize import interpolate, rasterize
from vhap_tpu_torch.ops.texture import texture_sample


def transform_vt(vt: torch.Tensor) -> torch.Tensor:
    """UV verts (Vt, 2) -> clip space (1, Vt, 4): every vertex at z = -1,
    w = 1 (render_uvmap.py:22-28)."""
    xy = vt * 2 - 1
    w = torch.ones_like(vt[:, :1])
    return torch.cat([xy, -w, w], dim=-1)[None]


def render_uvmap_vtex(pos: torch.Tensor, pos_idx: torch.Tensor,
                      v_color: torch.Tensor, col_idx: torch.Tensor,
                      resolution: Tuple[int, int],
                      use_kernels: bool = True) -> torch.Tensor:
    """Rasterize the UV layout with per-vertex colors (render_uvmap.py:30-37):
    (1, H, W, C) in buffer orientation (row 0 = v 0).

    UV-space triangles wind either way, so culling is off.
    """
    pos_clip = transform_vt(pos)
    rast, _, _ = rasterize(pos_clip, pos_idx, tuple(resolution),
                           cull_backfaces=False, use_kernels=use_kernels)
    color, _ = interpolate(v_color[None], rast, col_idx, use_kernels=use_kernels)
    return antialias_rast(color, rast, pos_clip, pos_idx, use_kernels=use_kernels)


def render_uvmap_texmap(pos: torch.Tensor, pos_idx: torch.Tensor,
                        verts_uv: torch.Tensor, faces_uv: torch.Tensor,
                        tex: torch.Tensor, resolution: Tuple[int, int],
                        enable_mip: bool = True,
                        max_mip_level: Optional[int] = None,
                        use_kernels: bool = True) -> torch.Tensor:
    """Rasterize the UV layout sampling tex (H, W, C) (render_uvmap.py:39-51):
    trilinear with mips (at most max_mip_level levels) or, with
    enable_mip=False, bilinear."""
    pos_clip = transform_vt(pos)
    rast, rast_db, _ = rasterize(pos_clip, pos_idx, tuple(resolution),
                                 cull_backfaces=False, use_kernels=use_kernels)
    if enable_mip:
        texc, texd = interpolate(verts_uv[None], rast, faces_uv, rast_db=rast_db,
                                 diff_attrs="all", use_kernels=use_kernels)
        color = texture_sample(tex[None], texc, texd, use_kernels=use_kernels,
                               max_mip_level=max_mip_level)
    else:
        texc, _ = interpolate(verts_uv[None], rast, faces_uv,
                              use_kernels=use_kernels)
        color = texture_sample(tex[None], texc, filter_mode="linear")
    return antialias_rast(color, rast, pos_clip, pos_idx, use_kernels=use_kernels)
