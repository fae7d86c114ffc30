"""Mip-mapped texture sampling (`linear-mipmap-linear`).

Counterpart of vhap_tpu/ops/texture.py (reference: nvdiffrast's
`dr.texture(..., filter_mode='linear-mipmap-linear')`,
vhap/util/render_nvdiffrast.py:399). The pyramid is flattened into one
buffer with static level offsets; every pixel samples its 8 trilinear
taps (4 per level of the two nearest mips) through
`trilinear_sample_plain` (ops/texture_fetch.py).
Boundary mode 'wrap'; the caller flips v as the reference does
(vhap/model/tracker.py:315-316).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from reference.ops.texture_fetch import trilinear_sample_plain


def build_mip_pyramid(tex: torch.Tensor, max_levels: Optional[int] = None):
    """tex (B, H, W, C) -> (flat (B, N, C), offsets, sizes) with 2x2-mean mips.

    Level 0 is full resolution; level i has shape (H >> i, W >> i). At most
    max_levels levels (level 0 included) when given.
    """
    B, H, W, C = tex.shape
    levels: List[torch.Tensor] = [tex]
    h, w = H, W
    while h > 1 and w > 1 and (max_levels is None or len(levels) < max_levels):
        t = levels[-1][:, :h // 2 * 2, :w // 2 * 2]
        t = (t[:, 0::2, 0::2] + t[:, 0::2, 1::2]
             + t[:, 1::2, 0::2] + t[:, 1::2, 1::2]) * 0.25
        levels.append(t)
        h, w = h // 2, w // 2

    offsets, sizes = [], []
    off = 0
    for t in levels:
        offsets.append(off)
        sizes.append((t.shape[1], t.shape[2]))
        off += t.shape[1] * t.shape[2]
    flat = torch.cat([t.reshape(B, -1, C) for t in levels], dim=1)
    return flat, tuple(offsets), tuple(sizes)


def texture_sample(tex: torch.Tensor, uv: torch.Tensor, uv_da: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   max_mip_level: Optional[int] = None) -> torch.Tensor:
    """nvdiffrast's `linear-mipmap-linear` texture lookup, (B, Hi, Wi, C)
    (vhap_tpu/ops/texture.py:111-153).

    tex (1, H, W, C) is one texture shared by the batch; its pyramid (at
    most max_mip_level levels) is built once and every batch element
    samples the same flat buffer at uv (B, Hi, Wi, 2) with the footprint
    uv_da (B, Hi, Wi, 4). mask (B, Hi, Wi) marks the pixels whose sample
    matters (rasterizer coverage); masked-out pixels return 0; without a
    mask every pixel fetches.
    """
    B, Hi, Wi = uv.shape[:3]
    if tex.shape[0] != 1:
        raise ValueError("texture_sample takes one shared texture (batch 1), "
                         f"got {tuple(tex.shape)}")
    flat, offsets, sizes = build_mip_pyramid(tex, max_mip_level)
    out = trilinear_sample_plain(flat[0].contiguous(), tex.shape[1:3], offsets,
                                 sizes, uv, uv_da, mask)
    return out.reshape(B, Hi, Wi, tex.shape[-1])
