"""Trilinear mip sampling, plainly.

`trilinear_sample_plain` samples a flat mip pyramid (build_mip_pyramid's
layout) trilinearly at every pixel's uv with the lod of its footprint
uv_da:

    out[b, p, :] = sum_k wgt[b, k, p] * flat1[idx[b, k, p], :]

over the pixel's 8 taps (4 bilinear corners on each of the two nearest mip
levels), where `trilinear_taps` writes the (idx, wgt) pairs out as tensors:
the counterpart of vhap_tpu's XLA tap math (vhap_tpu/ops/texture.py:158-238)
followed by its tap gather. Autograd gives the backward. All in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# the tap math, in plain PyTorch
# ---------------------------------------------------------------------------

class LevelTerms(NamedTuple):
    """One mip level's part of a pixel's taps, each (B, P) unless noted."""
    idx: torch.Tensor      # (B, 4, P) int32 flat texel ids of the 4 corners
    fx: torch.Tensor       # bilinear fractions
    fy: torch.Tensor
    wf: torch.Tensor       # the level's width and height, float32
    hf: torch.Tensor


class TapTerms(NamedTuple):
    """The intermediates of trilinear_taps, each (B, P)."""
    tx0: torch.Tensor      # du/dx * Wt
    ty1: torch.Tensor      # du/dy * Wt
    tx2: torch.Tensor      # dv/dx * Ht
    ty3: torch.Tensor      # dv/dy * Ht
    fx2: torch.Tensor      # squared footprint along x and y, in texels
    fy2: torch.Tensor
    lod_raw: torch.Tensor  # 0.5 * log2(max(fx2, fy2, 1e-20)), unclamped
    f: torch.Tensor        # the lod's fraction: the upper level's share
    levels: Tuple[LevelTerms, LevelTerms]


def _bilinear(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """The 4 corner weights of one level, (B, 4, P)."""
    return torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                        (1 - fx) * fy, fx * fy], dim=1)


def tap_terms(tex_size: Tuple[int, int], offsets, sizes, uv: torch.Tensor,
              uv_da: torch.Tensor) -> TapTerms:
    """Every pixel's lod and its two levels' corners (vhap_tpu/ops/
    texture.py:158-238), the arithmetic K3 and K4 repeat op for op."""
    B = uv.shape[0]
    Ht, Wt = tex_size
    P = uv.shape[1] * uv.shape[2]
    u = uv[..., 0].reshape(B, P)
    v = uv[..., 1].reshape(B, P)
    L = len(offsets)
    dev = uv.device

    # lod from the uv footprint in texel units (nvdiffrast convention)
    da = uv_da.reshape(B, P, 4)
    tx0, tx2 = da[..., 0] * Wt, da[..., 2] * Ht
    ty1, ty3 = da[..., 1] * Wt, da[..., 3] * Ht
    fx2 = tx0 ** 2 + tx2 ** 2
    fy2 = ty1 ** 2 + ty3 ** 2
    lod_raw = 0.5 * torch.log2(torch.clamp(torch.maximum(fx2, fy2), min=1e-20))
    lod = torch.clamp(lod_raw, 0.0, L - 1)

    l0 = torch.floor(lod)
    f = lod - l0
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

    def corners(li) -> LevelTerms:
        off, hi, wi = level_params(li)
        wf, hf = wi.to(torch.float32), hi.to(torch.float32)
        x = u * wf - 0.5
        y = v * hf - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        # floor-mod (jnp.mod): torch.remainder, not torch.fmod
        x0i = torch.remainder(x0.to(torch.int32), wi)
        y0i = torch.remainder(y0.to(torch.int32), hi)
        x1i = torch.remainder(x0i + 1, wi)
        y1i = torch.remainder(y0i + 1, hi)
        idx = torch.stack([off + y0i * wi + x0i, off + y0i * wi + x1i,
                           off + y1i * wi + x0i, off + y1i * wi + x1i], dim=1)
        return LevelTerms(idx.to(torch.int32), x - x0, y - y0, wf, hf)

    return TapTerms(tx0, ty1, tx2, ty3, fx2, fy2, lod_raw, f,
                    (corners(l0i), corners(l1i)))


def trilinear_taps(tex_size: Tuple[int, int], offsets, sizes,
                   uv: torch.Tensor, uv_da: torch.Tensor,
                   mask: Optional[torch.Tensor] = None):
    """The 8 trilinear taps of every pixel (vhap_tpu/ops/texture.py:155-238).

    tex_size (Ht, Wt) of level 0; offsets/sizes from build_mip_pyramid;
    uv (B, Hi, Wi, 2); uv_da (B, Hi, Wi, 4) = du/dx, du/dy, dv/dx, dv/dy;
    mask (B, Hi, Wi) bool coverage (masked-out taps get weight 0).
    Returns idx (B, 8, P) int32 flat texel ids and wgt (B, 8, P).
    """
    return _taps(tap_terms(tex_size, offsets, sizes, uv, uv_da), mask)


def _taps(t: TapTerms, mask: Optional[torch.Tensor]):
    (lv0, lv1), f = t.levels, t.f[:, None]
    idx = torch.cat([lv0.idx, lv1.idx], dim=1)
    wgt = torch.cat([_bilinear(lv0.fx, lv0.fy) * (1 - f),
                     _bilinear(lv1.fx, lv1.fy) * f], dim=1)
    if mask is not None:
        B, _, P = wgt.shape
        wgt = torch.where(mask.reshape(B, 1, P), wgt, torch.zeros_like(wgt))
    return idx, wgt


def weighted_fetch_plain(flat1: torch.Tensor, idx: torch.Tensor,
                         wgt: torch.Tensor) -> torch.Tensor:
    """flat1 (N, C); idx, wgt (B, K, P) -> (B, P, C)."""
    texels = flat1[idx.long()]                                  # (B, K, P, C)
    return torch.einsum("bkpc,bkp->bpc", texels, wgt)


def trilinear_sample_plain(flat1: torch.Tensor, tex_size: Tuple[int, int],
                           offsets, sizes, uv: torch.Tensor,
                           uv_da: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3: `trilinear_taps`, then `weighted_fetch_plain`.
    flat1 (N, C); uv (B, Hi, Wi, 2); uv_da (B, Hi, Wi, 4); mask (B, Hi, Wi)
    bool or None -> (B, P, C), differentiable by autograd."""
    idx, wgt = trilinear_taps(tex_size, offsets, sizes, uv, uv_da, mask)
    return weighted_fetch_plain(flat1, idx, wgt)

