"""Trilinear mip sampling: the fused sampler K3 / K4, its plain versions,
and the value scatter K8.

`trilinear_sample` samples a flat mip pyramid (build_mip_pyramid's layout)
trilinearly at every pixel's uv with the lod of its footprint uv_da:

    out[b, p, :] = sum_k wgt[b, k, p] * flat1[idx[b, k, p], :]

over the pixel's 8 taps (4 bilinear corners on each of the two nearest mip
levels), where `trilinear_taps` writes the (idx, wgt) pairs out as tensors.
For CUDA tensors it launches kernel K3 (csrc/texture_fetch.cu), which forms
each pixel's taps in registers from uv and uv_da and gathers the texels, the
counterpart of vhap_tpu's XLA tap math (vhap_tpu/ops/texture.py:158-238)
followed by its tap gather `gather_taps` (texture_grad_pallas.py:597). Its
backward, kernel K4 (csrc/texture_scatter.cu), forms the taps again,
scatters the texel gradient `dflat[idx] += wgt * g` and carries each tap's
`texel . g` through the chain rule to d_uv and d_uv_da (the counterpart of
`scatter_taps_wg`, texture_grad_pallas.py:413, with autodiff of the tap
math). No (B, 8, P) tap tensor exists on that path. Both kernels are built
without FMA contraction and follow the plain version's order of operations,
so the level and texel chosen on the card are the plain version's.

The plain versions: `trilinear_sample_plain` (`trilinear_taps`, then
`weighted_fetch_plain`; autograd gives its backward) and
`trilinear_sample_bwd_plain`, the chain rule K4 computes, written out in
tensor ops (`scatter_taps_plain` for the texel gradient,
`tap_weight_grad_plain` for each tap's `texel . g`). `trilinear_taps_card`
returns the taps that K3 and K4 form, through the kernels' own tap code.

`scatter_taps` is K8, the counterpart of vhap_tpu's `scatter_taps`
(texture_grad_pallas.py:271): the sum of precomputed tap values into the
flat texel buffer, `dflat[idx[b, k, p], c] += vals[b, k, c, p]`, through
the CUDA kernel `scatter_vals` (csrc/texture_scatter.cu) for CUDA tensors
and `scatter_vals_plain` (float32 `index_add_`) for CPU tensors. The TPU
function's `level_offsets`, `plan`, `npix` and `precision` arguments only
shape its tile binning and bf16 split, so the port does not take them.

All run in float32 (the TPU's bf16 fetch is a TPU speed trade and is not
ported).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from vhap_tpu_torch.ops.kernels import (Kernel, c_int, c_ptr,
                                        check_cuda_tensor, library)

MAX_LEVELS = 16          # csrc/trilinear.cuh kMaxLevels
LN2 = math.log(2.0)      # torch.log2's backward divides by x * ln 2
c_ll = ctypes.c_longlong


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


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def weighted_fetch_plain(flat1: torch.Tensor, idx: torch.Tensor,
                         wgt: torch.Tensor) -> torch.Tensor:
    """flat1 (N, C); idx, wgt (B, K, P) -> (B, P, C)."""
    texels = flat1[idx.long()]                                  # (B, K, P, C)
    return torch.einsum("bkpc,bkp->bpc", texels, wgt)


def scatter_vals_plain(idx: torch.Tensor, vals: torch.Tensor,
                       n_texels: int) -> torch.Tensor:
    """Plain version of K8: idx (B, K, P); vals (B, K, C, P) -> dflat
    (n_texels, C) with dflat[idx[b, k, p], c] += vals[b, k, c, p], in
    vals' dtype."""
    C = vals.shape[2]
    rows = vals.permute(0, 1, 3, 2).reshape(-1, C)              # (B*K*P, C)
    return torch.zeros((n_texels, C), dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx.reshape(-1).long(), rows)


def scatter_taps_plain(idx: torch.Tensor, wgt: torch.Tensor, g: torch.Tensor,
                       n_texels: int) -> torch.Tensor:
    """The texel gradient of weighted_fetch: idx, wgt (B, K, P); g (B, P, C)
    -> dflat (n_texels, C) with dflat[idx[b, k, p]] += wgt[b, k, p] * g[b, p]."""
    return scatter_vals_plain(idx, wgt[:, :, None, :] * g.transpose(1, 2)[:, None],
                              n_texels)


def tap_weight_grad_plain(flat1: torch.Tensor, idx: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of weighted_fetch: d_wgt (B, K, P) =
    sum_c flat1[idx, c] * g[b, p, c], for every tap (the XLA branch of
    vhap_tpu's _wfe_bwd)."""
    return torch.einsum("bkpc,bpc->bkp", flat1[idx.long()], g)


def weighted_fetch(flat1: torch.Tensor, idx: torch.Tensor,
                   wgt: torch.Tensor) -> torch.Tensor:
    """flat1 (N, C) shared flat mip pyramid; idx (B, K, P) int32 taps in
    [0, N); wgt (B, K, P) -> (B, P, C), through `weighted_fetch_plain`.
    CPU tensors only: on the card the taps never exist as tensors."""
    if flat1.device.type != "cpu":
        raise ValueError(
            "weighted_fetch takes CPU tensors only: on the card the taps are "
            "formed inside the fused sampler, use trilinear_sample (K3/K4)")
    return weighted_fetch_plain(flat1, idx, wgt)


def trilinear_sample_plain(flat1: torch.Tensor, tex_size: Tuple[int, int],
                           offsets, sizes, uv: torch.Tensor,
                           uv_da: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3: `trilinear_taps`, then `weighted_fetch_plain`.
    flat1 (N, C); uv (B, Hi, Wi, 2); uv_da (B, Hi, Wi, 4); mask (B, Hi, Wi)
    bool or None -> (B, P, C), differentiable by autograd."""
    idx, wgt = trilinear_taps(tex_size, offsets, sizes, uv, uv_da, mask)
    return weighted_fetch_plain(flat1, idx, wgt)


def trilinear_sample_bwd_plain(flat1: torch.Tensor, tex_size: Tuple[int, int],
                               offsets, sizes, uv: torch.Tensor,
                               uv_da: torch.Tensor,
                               mask: Optional[torch.Tensor], g: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4: the gradients of trilinear_sample_plain for the
    cotangent g (B, P, C), with the chain rule written out as K4 computes
    it. Returns (d_uv, d_uv_da, dflat) in uv's, uv_da's and flat1's shapes.
    The taps are formed in uv's float32 in every case; a float64 flat1 and
    g carry the chain rule in float64 (as K4 does from each tap's
    texel . g on), the exact gradient of the float32 forward.

    Each tap's weight gradient is `texel . g` (on every tap, also one of
    weight 0: a bilinear or lod fraction of exactly 0 still carries
    gradient); a masked pixel's is 0. torch.maximum splits a tie of fx2 and
    fy2 half and half; the clamps pass gradient at their bounds inclusive;
    floor passes none, so d lod = d f and d fx / d u = the level's width.
    """
    Ht, Wt = tex_size
    L = len(offsets)
    B = uv.shape[0]
    with torch.no_grad():
        t = tap_terms(tex_size, offsets, sizes, uv, uv_da)
        idx, wgt = _taps(t, mask)
        dflat = scatter_taps_plain(idx, wgt, g, flat1.shape[0])
        G = tap_weight_grad_plain(flat1, idx, g)                    # (B, 8, P)
        if mask is not None:
            G = torch.where(mask.reshape(B, 1, -1), G, torch.zeros_like(G))
        s = (1 - t.f, t.f)
        d_u = d_v = 0.0
        ds = []
        for a, lv in enumerate(t.levels):
            Ga = G[:, 4 * a:4 * a + 4]
            b = _bilinear(lv.fx, lv.fy)
            # d (bilinear weight) and d (level share)
            db0, db1, db2, db3 = (Ga[:, j] * s[a] for j in range(4))
            ds.append(((Ga[:, 0] * b[:, 0] + Ga[:, 1] * b[:, 1])
                       + Ga[:, 2] * b[:, 2]) + Ga[:, 3] * b[:, 3])
            ax, ay = 1 - lv.fx, 1 - lv.fy
            dfx = (db1 * ay + db3 * lv.fy) - (db0 * ay + db2 * lv.fy)
            dfy = (db2 * ax + db3 * lv.fx) - (db0 * ax + db1 * lv.fx)
            d_u = d_u + dfx * lv.wf
            d_v = d_v + dfy * lv.hf
        df = ds[1] - ds[0]
        # lod = clamp(0.5 * log2(clamp(max(fx2, fy2), 1e-20)), 0, L - 1)
        m = torch.maximum(t.fx2, t.fy2)
        c = torch.clamp(m, min=1e-20)
        zero = torch.zeros_like(df)
        dlod = torch.where((t.lod_raw >= 0.0) & (t.lod_raw <= L - 1), df, zero)
        dc = dlod * 0.5 / (c * LN2)
        dm = torch.where(m >= 1e-20, dc, zero)
        share_x = torch.where(t.fx2 > t.fy2, 1.0,
                              torch.where(t.fx2 == t.fy2, 0.5, 0.0))
        dfx2 = dm * share_x
        dfy2 = dm * (1 - share_x)
        d_da = torch.stack([dfx2 * (2 * t.tx0) * Wt, dfy2 * (2 * t.ty1) * Wt,
                            dfx2 * (2 * t.tx2) * Ht, dfy2 * (2 * t.ty3) * Ht], -1)
        d_uv = torch.stack([d_u, d_v], -1)
    return d_uv.reshape(uv.shape), d_da.reshape(uv_da.shape), dflat


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_PIXEL = [c_ptr, c_ll, c_ll, c_ll]          # pointer, batch / pixel / channel strides
TRILINEAR_SAMPLE = Kernel(
    "trilinear_sample", "vhap_trilinear_sample",
    [c_ptr, c_ptr, c_int, c_ptr, *_PIXEL, *_PIXEL, c_int, c_int, c_ptr])
TRILINEAR_SAMPLE_BWD = Kernel(
    "trilinear_sample_bwd", "vhap_trilinear_sample_bwd",
    [c_ptr, c_ptr, c_int, c_ptr, *_PIXEL, *_PIXEL, c_ptr, c_int, c_int,
     c_ptr, c_ptr, *_PIXEL, *_PIXEL])
TRILINEAR_TAPS = Kernel(
    "trilinear_taps", "vhap_trilinear_taps",
    [c_ptr, c_int, c_ptr, *_PIXEL, *_PIXEL, c_int, c_int, c_ptr, c_ptr])
SCATTER_VALS = Kernel("scatter_vals", "vhap_scatter_vals",
                      [c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_ptr])


def _level_table(offsets: Sequence[int], sizes: Sequence[Tuple[int, int]]):
    """(offset, height, width) of each level as a host int array."""
    if not 1 <= len(offsets) <= MAX_LEVELS:
        raise ValueError(f"the fused sampler takes 1 to {MAX_LEVELS} mip levels, "
                         f"got {len(offsets)}")
    vals: List[int] = []
    for off, (h, w) in zip(offsets, sizes):
        vals += [int(off), int(h), int(w)]
    return (ctypes.c_int * len(vals))(*vals)


def _pixel_view(name: str, t: torch.Tensor, ch: int):
    """t (B, Hi, Wi, ch) float32 on the card -> (t, [ptr, batch, pixel,
    channel strides]), read in place (a channel slice of the fused
    interpolation's buffer too); a t whose (Hi, Wi) cannot flatten to one
    pixel stride is copied contiguous first."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or t.dim() != 4 or t.shape[-1] != ch:
        raise ValueError(f"{name} must be float32 (B, Hi, Wi, {ch}), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.stride(1) != t.shape[2] * t.stride(2):
        t = t.contiguous()
    return t, [t.data_ptr(), t.stride(0), t.stride(2), t.stride(3)]


def _grad_like(t: torch.Tensor):
    """An uninitialized gradient for t (B, Hi, Wi, ch): plane layout, a
    (B, ch, Hi, Wi) tensor's view, when t's channels are planes (the fused
    interpolation's outputs), else pixel-interleaved; and its pointer and
    strides."""
    B, Hi, Wi, ch = t.shape
    if t.stride(3) > t.stride(2):
        g = torch.empty((B, ch, Hi, Wi), dtype=t.dtype,
                        device=t.device).permute(0, 2, 3, 1)
    else:
        g = torch.empty_like(t, memory_format=torch.contiguous_format)
    return g, [g.data_ptr(), g.stride(0), g.stride(2), g.stride(3)]


def _check_sampler_inputs(flat1, uv, uv_da, mask):
    check_cuda_tensor("flat1", flat1, torch.float32, 2)
    if flat1.shape[1] != 3:
        raise ValueError(f"flat1 must have 3 channels, got {tuple(flat1.shape)}")
    uv, uv_args = _pixel_view("uv", uv, 2)
    uv_da, da_args = _pixel_view("uv_da", uv_da, 4)
    if uv.shape[:3] != uv_da.shape[:3]:
        raise ValueError(f"uv {tuple(uv.shape)} and uv_da {tuple(uv_da.shape)} "
                         "cover other pixels")
    if mask is not None:
        check_cuda_tensor("mask", mask, torch.bool, 3)
        if mask.shape != uv.shape[:3]:
            raise ValueError(f"mask {tuple(mask.shape)} != pixels "
                             f"{tuple(uv.shape[:3])}")
    return uv, uv_args, uv_da, da_args


class _TrilinearSample(torch.autograd.Function):
    """K3 launch; its backward launches K4. Saves the pyramid, uv, uv_da
    and the mask: the taps are formed again in K4, never stored."""

    @staticmethod
    def forward(ctx, flat1, uv, uv_da, mask, offsets, sizes):
        uv, uv_args, uv_da, da_args = _check_sampler_inputs(flat1, uv, uv_da, mask)
        B, Hi, Wi = uv.shape[:3]
        P = Hi * Wi
        table = _level_table(offsets, sizes)
        out = torch.empty((B, P, 3), dtype=torch.float32, device=flat1.device)
        TRILINEAR_SAMPLE(flat1.data_ptr(), table, len(offsets),
                         0 if mask is None else mask.data_ptr(),
                         *uv_args, *da_args, B, P, out.data_ptr())
        ctx.save_for_backward(flat1, uv, uv_da, mask)
        ctx.levels = (offsets, sizes)
        return out

    @staticmethod
    def backward(ctx, g):
        flat1, uv, uv_da, mask = ctx.saved_tensors
        dflat, d_uv, d_uv_da = _launch_bwd(flat1, uv, uv_da, mask, *ctx.levels, g)
        return dflat, d_uv, d_uv_da, None, None, None


def _launch_bwd(flat1, uv, uv_da, mask, offsets, sizes, g):
    """K4: (dflat (N, 3), d_uv, d_uv_da); a uv or uv_da of plane layout
    (the fused interpolation's outputs) gets a plane-layout gradient, which
    reaches that interpolation's backward without a transpose."""
    uv, uv_args, uv_da, da_args = _check_sampler_inputs(flat1, uv, uv_da, mask)
    B, Hi, Wi = uv.shape[:3]
    P = Hi * Wi
    g = g.contiguous()
    check_cuda_tensor("grad", g, torch.float32, 3)
    if tuple(g.shape) != (B, P, 3):
        raise ValueError(f"grad {tuple(g.shape)} is not the forward's output "
                         f"shape {(B, P, 3)}")
    table = _level_table(offsets, sizes)
    dflat = torch.zeros_like(flat1)
    scratch = torch.empty(_bwd_scratch_doubles(table, len(offsets)),
                          dtype=torch.float64, device=flat1.device)
    d_uv, d_uv_args = _grad_like(uv)
    d_uv_da, d_da_args = _grad_like(uv_da)
    TRILINEAR_SAMPLE_BWD(flat1.data_ptr(), table, len(offsets),
                         0 if mask is None else mask.data_ptr(),
                         *uv_args, *da_args, g.data_ptr(), B, P,
                         dflat.data_ptr(), scratch.data_ptr(), *d_uv_args,
                         *d_da_args)
    return dflat, d_uv, d_uv_da


def _bwd_scratch_doubles(table, n_levels: int) -> int:
    """float64 scratch K4 takes for this pyramid (the sums of its top
    levels); the kernel's C interface owns the rule."""
    fn = library().vhap_trilinear_sample_bwd_scratch
    fn.argtypes, fn.restype = [c_ptr, c_int], c_ll
    return fn(table, n_levels)


def trilinear_sample(flat1: torch.Tensor, tex_size: Tuple[int, int], offsets,
                     sizes, uv: torch.Tensor, uv_da: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample the flat mip pyramid flat1 (N, C) (build_mip_pyramid of a
    texture of size tex_size, one texture shared by the batch) trilinearly
    at uv (B, Hi, Wi, 2) with the lod of uv_da (B, Hi, Wi, 4) = du/dx,
    du/dy, dv/dx, dv/dy, wrap addressing -> (B, Hi * Wi, C). mask
    (B, Hi, Wi) bool marks the pixels whose sample matters: the others
    return 0, fetch nothing and take no gradient.

    CUDA tensors go through kernel K3, and backward K4 (C = 3); uv and
    uv_da may be strided views (channel slices of the fused interpolation's
    buffer), read in place. CPU tensors go through
    `trilinear_sample_plain`.
    """
    if flat1.device.type == "cpu":
        return trilinear_sample_plain(flat1, tex_size, offsets, sizes, uv,
                                      uv_da, mask)
    if tuple(tex_size) != tuple(sizes[0]):
        raise ValueError(f"tex_size {tuple(tex_size)} is not level 0's size "
                         f"{tuple(sizes[0])}")
    return _TrilinearSample.apply(flat1, uv, uv_da, mask, tuple(offsets),
                                  tuple(tuple(s) for s in sizes))


def trilinear_sample_bwd(flat1: torch.Tensor, tex_size: Tuple[int, int],
                         offsets, sizes, uv: torch.Tensor, uv_da: torch.Tensor,
                         mask: Optional[torch.Tensor], g: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 alone: (d_uv, d_uv_da, dflat) of trilinear_sample for the
    cotangent g (B, P, 3). CUDA tensors go through the kernel, CPU tensors
    through `trilinear_sample_bwd_plain`."""
    if flat1.device.type == "cpu":
        return trilinear_sample_bwd_plain(flat1, tex_size, offsets, sizes, uv,
                                          uv_da, mask, g)
    dflat, d_uv, d_uv_da = _launch_bwd(flat1, uv, uv_da, mask, offsets, sizes, g)
    return d_uv, d_uv_da, dflat


def trilinear_taps_card(tex_size: Tuple[int, int], offsets, sizes,
                        uv: torch.Tensor, uv_da: torch.Tensor,
                        mask: Optional[torch.Tensor] = None):
    """The taps K3 and K4 form, written out as trilinear_taps writes them
    (idx (B, 8, P) int32, wgt (B, 8, P)): for CUDA tensors through the
    kernels' own tap code (csrc/trilinear.cuh), for CPU tensors through
    trilinear_taps. A check of the kernels' level and texel choice; no path
    runs it."""
    if uv.device.type == "cpu":
        return trilinear_taps(tex_size, offsets, sizes, uv, uv_da, mask)
    if tuple(tex_size) != tuple(sizes[0]):
        raise ValueError(f"tex_size {tuple(tex_size)} is not level 0's size "
                         f"{tuple(sizes[0])}")
    uv, uv_args = _pixel_view("uv", uv, 2)
    uv_da, da_args = _pixel_view("uv_da", uv_da, 4)
    if mask is not None:
        check_cuda_tensor("mask", mask, torch.bool, 3)
    B, Hi, Wi = uv.shape[:3]
    P = Hi * Wi
    idx = torch.empty((B, 8, P), dtype=torch.int32, device=uv.device)
    wgt = torch.empty((B, 8, P), dtype=torch.float32, device=uv.device)
    TRILINEAR_TAPS(_level_table(offsets, sizes), len(offsets),
                   0 if mask is None else mask.data_ptr(), *uv_args, *da_args,
                   B, P, idx.data_ptr(), wgt.data_ptr())
    return idx, wgt


def scatter_taps(idx: torch.Tensor, vals: torch.Tensor, n_texels: int
                 ) -> Tuple[torch.Tensor, int]:
    """Sum tap values into a flat texel buffer: idx (B, K, P) int32 in
    [0, n_texels); vals (B, K, C, P) float32 -> (dflat (n_texels, C),
    overflow = 0). The port has no tile lists to overflow.

    CUDA tensors go through kernel K8 (`scatter_vals`); CPU tensors
    through `scatter_vals_plain`.
    """
    if vals.device.type == "cpu":
        return scatter_vals_plain(idx, vals, n_texels), 0
    check_cuda_tensor("idx", idx, torch.int32, 3)
    check_cuda_tensor("vals", vals, torch.float32, 4)
    B, K, C, P = vals.shape
    if tuple(idx.shape) != (B, K, P):
        raise ValueError(f"idx {tuple(idx.shape)} does not match vals "
                         f"{tuple(vals.shape)} (expected {(B, K, P)})")
    dflat = torch.zeros((n_texels, C), dtype=torch.float32, device=vals.device)
    SCATTER_VALS(idx.data_ptr(), vals.data_ptr(), B, K, C, P, dflat.data_ptr())
    return dflat, 0
