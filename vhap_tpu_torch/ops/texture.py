"""Mip-mapped texture sampling (`linear-mipmap-linear`).

Counterpart of vhap_tpu/ops/texture.py (reference: nvdiffrast's
`dr.texture(..., filter_mode='linear-mipmap-linear')`,
vhap/util/render_nvdiffrast.py:399). The pyramid is flattened into one
buffer with static level offsets; every pixel's 8 trilinear taps (4 per
level of the two nearest mips) become (index, weight) pairs, and the
weighted fetch (ops/texture_fetch.py, kernel K3 on the card) sums them.
Boundary mode 'wrap'; the caller flips v as the reference does
(vhap/model/tracker.py:315-316).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from vhap_tpu_torch.ops.texture_fetch import weighted_fetch


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


def trilinear_taps(tex_size: Tuple[int, int], offsets, sizes,
                   uv: torch.Tensor, uv_da: torch.Tensor,
                   mask: Optional[torch.Tensor] = None):
    """The 8 trilinear taps of every pixel (vhap_tpu/ops/texture.py:155-238).

    tex_size (Ht, Wt) of level 0; offsets/sizes from build_mip_pyramid;
    uv (B, Hi, Wi, 2); uv_da (B, Hi, Wi, 4) = du/dx, du/dy, dv/dx, dv/dy;
    mask (B, Hi, Wi) bool coverage (masked-out taps get weight 0).
    Returns idx (B, 8, P) int32 flat texel ids and wgt (B, 8, P).
    """
    B = uv.shape[0]
    Ht, Wt = tex_size
    P = uv.shape[1] * uv.shape[2]
    u = uv[..., 0].reshape(B, P)
    v = uv[..., 1].reshape(B, P)
    L = len(offsets)
    dev = uv.device

    # lod from the uv footprint in texel units (nvdiffrast convention)
    da = uv_da.reshape(B, P, 4)
    fx2 = (da[..., 0] * Wt) ** 2 + (da[..., 2] * Ht) ** 2
    fy2 = (da[..., 1] * Wt) ** 2 + (da[..., 3] * Ht) ** 2
    lod = 0.5 * torch.log2(torch.clamp(torch.maximum(fx2, fy2), min=1e-20))
    lod = torch.clamp(lod, 0.0, L - 1)

    l0 = torch.floor(lod)
    f = (lod - l0)[:, None]
    l0i = l0.to(torch.int32)
    l1i = torch.clamp(l0i + 1, max=L - 1)

    pow2 = (Ht & (Ht - 1)) == 0 and (Wt & (Wt - 1)) == 0
    A = Ht * Wt
    if pow2:
        # off(l) = sum_{k<l} (A >> 2k) = (4A - 4*(A >> 2l)) / 3, exact while
        # 2l <= trailing zeros of A (holds for every generated level)
        if not all(o == (4 * A - ((A >> (2 * l)) << 2)) // 3
                   for l, o in enumerate(offsets)):
            raise ValueError("mip pyramid layout does not match its offsets")
    offs_t = torch.tensor(offsets, dtype=torch.int32, device=dev)
    hs_t = torch.tensor([s[0] for s in sizes], dtype=torch.int32, device=dev)
    ws_t = torch.tensor([s[1] for s in sizes], dtype=torch.int32, device=dev)

    def level_params(li):
        if pow2:
            wi = torch.bitwise_right_shift(torch.full_like(li, Wt), li)
            hi = torch.bitwise_right_shift(torch.full_like(li, Ht), li)
            shifted = torch.bitwise_right_shift(torch.full_like(li, A), 2 * li)
            off = torch.div(4 * A - torch.bitwise_left_shift(shifted, 2), 3,
                            rounding_mode="floor")
            return off, hi, wi
        lil = li.long()
        return offs_t[lil], hs_t[lil], ws_t[lil]

    def corner_indices_weights(li):
        off, hi, wi = level_params(li)
        x = u * wi.to(torch.float32) - 0.5
        y = v * hi.to(torch.float32) - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx, fy = x - x0, y - y0
        # floor-mod (jnp.mod): torch.remainder, not torch.fmod
        x0i = torch.remainder(x0.to(torch.int32), wi)
        y0i = torch.remainder(y0.to(torch.int32), hi)
        x1i = torch.remainder(x0i + 1, wi)
        y1i = torch.remainder(y0i + 1, hi)
        idx = torch.stack([off + y0i * wi + x0i, off + y0i * wi + x1i,
                           off + y1i * wi + x0i, off + y1i * wi + x1i], dim=1)
        wgt = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                           (1 - fx) * fy, fx * fy], dim=1)
        return idx, wgt                          # (B, 4, P) each

    i0, w0 = corner_indices_weights(l0i)
    i1, w1 = corner_indices_weights(l1i)
    idx = torch.cat([i0, i1], dim=1).to(torch.int32)
    wgt = torch.cat([w0 * (1 - f), w1 * f], dim=1)
    if mask is not None:
        wgt = torch.where(mask.reshape(B, 1, P), wgt, torch.zeros_like(wgt))
    return idx, wgt


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
                   fetch: Callable = weighted_fetch,
                   filter_mode: str = "linear-mipmap-linear",
                   max_mip_level: Optional[int] = None) -> torch.Tensor:
    """nvdiffrast-compatible texture lookup, (B, Hi, Wi, C)
    (vhap_tpu/ops/texture.py:111-153).

    `linear-mipmap-linear` (with uv_da (B, Hi, Wi, 4)): tex (1, H, W, C) is
    one texture shared by the batch; its pyramid (at most max_mip_level
    levels) is built once and every batch element fetches its 8 trilinear
    taps from the same flat buffer. mask (B, Hi, Wi) marks the pixels whose
    sample matters (rasterizer coverage); masked-out pixels return 0 and
    fetch nothing; without a mask every pixel fetches. fetch is the weighted
    texel fetch (kernel K3's wrapper, or its plain version).

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
    idx, wgt = trilinear_taps(tex.shape[1:3], offsets, sizes, uv, uv_da, mask)
    out = fetch(flat[0].contiguous(), idx.contiguous(), wgt.contiguous())
    return out.reshape(B, Hi, Wi, tex.shape[-1])
