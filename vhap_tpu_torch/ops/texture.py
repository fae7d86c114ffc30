"""Mip-mapped texture sampling (`linear-mipmap-linear`).

Counterpart of vhap_tpu/ops/texture.py (reference: nvdiffrast's
`dr.texture(..., filter_mode='linear-mipmap-linear')`,
vhap/util/render_nvdiffrast.py:399). The pyramid is flattened into one
buffer with static level offsets; every pixel samples its 8 trilinear
taps (4 per level of the two nearest mips) through `trilinear_sample`
(ops/texture_fetch.py: kernels K3 and K4 on the card, which form the taps
in registers; `trilinear_taps` writes them out for the plain version).
Boundary mode 'wrap'; the caller flips v as the reference does
(vhap/model/tracker.py:315-316).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from vhap_tpu_torch.ops.texture_fetch import trilinear_sample, trilinear_sample_plain


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


def _bilinear_gather(tex: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """One level sampled bilinearly with wrap addressing
    (vhap_tpu/ops/texture.py:77-106). tex (B|1, h, w, C); u, v (B, P) in
    [0, 1]; returns (B, P, C)."""
    _, h, w, C = tex.shape
    flat = tex.reshape(tex.shape[0], h * w, C)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)

    def at(yi, xi):
        idx = (yi * w + xi).long()
        if flat.shape[0] == 1:
            return flat[0][idx]                  # shared texture
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))

    t00, t01 = at(y0i, x0i), at(y0i, x1i)
    t10, t11 = at(y1i, x0i), at(y1i, x1i)
    return ((t00 * (1 - fx) + t01 * fx) * (1 - fy)
            + (t10 * (1 - fx) + t11 * fx) * fy)


def texture_sample(tex: torch.Tensor, uv: torch.Tensor,
                   uv_da: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   filter_mode: str = "linear-mipmap-linear",
                   max_mip_level: Optional[int] = None,
                   use_kernels: bool = True) -> torch.Tensor:
    """nvdiffrast-compatible texture lookup, (B, Hi, Wi, C)
    (vhap_tpu/ops/texture.py:111-153).

    `linear-mipmap-linear` (with uv_da (B, Hi, Wi, 4)): tex (1, H, W, C) is
    one texture shared by the batch; its pyramid (at most max_mip_level
    levels) is built once and every batch element samples the same flat
    buffer. mask (B, Hi, Wi) marks the pixels whose sample matters
    (rasterizer coverage); masked-out pixels return 0 and fetch nothing;
    without a mask every pixel fetches. uv and uv_da may be strided views
    (the fused interpolation's planes): the kernels read them in place.
    use_kernels=False runs the plain version (`trilinear_sample_plain`) on
    any device; otherwise CUDA tensors go through kernels K3/K4 and CPU
    tensors through the plain version.

    `linear`, or no uv_da: one bilinear level, in plain PyTorch (tex batch
    1 or B), as the JAX package leaves it to XLA.
    """
    B, Hi, Wi = uv.shape[:3]
    if filter_mode == "linear" or uv_da is None:
        out = _bilinear_gather(tex, uv[..., 0].reshape(B, -1),
                               uv[..., 1].reshape(B, -1))
        return out.reshape(B, Hi, Wi, tex.shape[-1])
    if filter_mode != "linear-mipmap-linear":
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if tex.shape[0] != 1:
        raise ValueError("texture_sample takes one shared texture (batch 1), "
                         f"got {tuple(tex.shape)}")
    flat, offsets, sizes = build_mip_pyramid(tex, max_mip_level)
    sample = trilinear_sample if use_kernels else trilinear_sample_plain
    out = sample(flat[0].contiguous(), tex.shape[1:3], offsets, sizes, uv,
                 uv_da, mask)
    return out.reshape(B, Hi, Wi, tex.shape[-1])
