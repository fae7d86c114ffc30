"""Fused deferred interpolation: per-pixel attributes from face tables.

Counterpart of vhap_tpu/ops/interp_pallas.py (the forward of
`fused_interp_flat`). Given the winning face of every pixel, one pass
computes the whole per-pixel chain of the render: barycentrics,
perspective division, z/w, uv screen derivatives, normal and uv
interpolation, and passes the vertex ids, flag rows and antialias planes
through. `fused_interp` launches the CUDA kernel K2f (csrc/interp.cu) for
CUDA tensors, and its backward the kernel K2b (csrc/interp_bwd.cu);
`fused_interp_plain` is their plain PyTorch version (autograd gives the
backward), and `fused_interp_bwd_plain` the plain version of K2b alone.
`fused_interp` returns the channels as an `InterpOut` of separate autograd
outputs (zw, texc, texd, normal, vertex ids, flags, AA planes, match), so
its backward gets one cotangent per output, or None for an output nothing
used, and the whole channel buffer's cotangent is never assembled.

The JAX package computes this function with two pairs of TPU kernels: K2
(`fused_interp_flat`, on the globally budgeted flat bins) and K7
(`fused_interp_tiled`, interp_pallas.py:259 / :291, on dense per-tile
(B, T, K) face lists, selected by `render.bin_mode='dense'`). Both resolve
each pixel's face row with a one-hot bf16 hi/lo matmul over the tile's list,
a TPU shape. On Hopper a per-pixel gather by `tri_id` computes the same
function, so K7 is ported as a second caller of K2f and K2b, not as a
kernel of its own (as K5 reaches K1's kernel): with `bin_mode='dense'` the
render runs exactly this path, and its overflow is 0, as the JAX kernels
report when no list is capped.

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

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from vhap_tpu_torch.ops.kernels import Kernel, c_float, c_int, c_ptr, \
    check_cuda_tensor
from vhap_tpu_torch.ops.rasterize import pixel_grid

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


def fused_interp_bwd_plain(packed: torch.Tensor, tri_id: torch.Tensor,
                           g: torch.Tensor, n_flags: int) -> torch.Tensor:
    """Plain version of K2b: the gradient of `fused_interp_plain`'s
    channels with respect to the (B, 36+nf, F) table, for the cotangent g
    (B, 20+nf, H, W). A background pixel contributes nothing (its output
    is 0 whatever the table holds)."""
    with torch.enable_grad():
        p = packed.detach().requires_grad_(True)
        out, _ = fused_interp_plain(p, tri_id, n_flags)
        (d_packed,) = torch.autograd.grad(out, p, g)
    return d_packed


class InterpOut(NamedTuple):
    """The fused interpolation's outputs, one per group of channels of the
    (B, 20+nf, H, W) layout above; each (B, c, H, W), zw and match (B, H, W).
    `fused_interp` returns them as separate outputs of one autograd node, so
    autograd hands the backward one cotangent per group (None where nothing
    depends on it) and never assembles the whole channel buffer."""
    zw: torch.Tensor
    texc: torch.Tensor
    texd: torch.Tensor
    normal: torch.Tensor
    vids: torch.Tensor
    flags: torch.Tensor
    aa: torch.Tensor
    match: torch.Tensor


# the groups K2b takes a cotangent for, in channel order (csrc/interp_bwd.cu)
GROUPS = ("zw", "texc", "texd", "normal", "vids", "flags", "aa")


def group_slices(n_flags: int):
    """Channel range of each InterpOut field in the (B, 20+nf, H, W) layout."""
    nf = n_flags
    return dict(zw=0, texc=slice(1, 3), texd=slice(3, 7), normal=slice(7, 10),
                vids=slice(10, 13), flags=slice(13, 13 + nf),
                aa=slice(13 + nf, 19 + nf), match=19 + nf)


def split_channels(chans: torch.Tensor, n_flags: int) -> InterpOut:
    """(B, 20+nf, H, W) channels -> InterpOut of views of them."""
    return InterpOut(**{k: chans[:, sl] for k, sl in group_slices(n_flags).items()})


def join_channels(out: InterpOut) -> torch.Tensor:
    """InterpOut -> the (B, 20+nf, H, W) channels (a copy)."""
    return torch.cat([out.zw[:, None], out.texc, out.texd, out.normal,
                      out.vids, out.flags, out.aa, out.match[:, None]], dim=1)


FUSED_INTERP = Kernel("fused_interp", "vhap_fused_interp",
                      [c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int,
                       c_float, c_float, c_ptr])
FUSED_INTERP_BWD = Kernel("fused_interp_bwd", "vhap_fused_interp_bwd",
                          [c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int,
                           c_int, c_float, c_float, c_ptr])


def _check_shapes(packed, tri_id, n_flags):
    check_cuda_tensor("tri_id", tri_id, torch.int32, 3)
    check_cuda_tensor("packed", packed, torch.float32, 3)
    B, C, _ = packed.shape
    if C != N_FIXED_IN + n_flags or tri_id.shape[0] != B:
        raise ValueError(f"packed {tuple(packed.shape)} and tri_id "
                         f"{tuple(tri_id.shape)} disagree (n_flags={n_flags})")


def _cotangent_table(grads: Sequence[Optional[torch.Tensor]], n_flags: int,
                     B: int, H: int, W: int):
    """Per group of GROUPS: (address, batch, channel and pixel strides) of
    its cotangent for K2b, 0 where it has none. Returns the int64 table (a
    ctypes array) and the tensors it points into (kept alive by the caller
    until the launch)."""
    chans = [group_slices(n_flags)[k] for k in GROUPS]
    desc, keep = [], []
    for name, sl, g in zip(GROUPS, chans, grads):
        n_c = 1 if isinstance(sl, int) else sl.stop - sl.start
        if g is None or n_c == 0:
            desc += [0, 0, 0, 0]
            continue
        g4 = g[:, None] if isinstance(sl, int) else g
        if tuple(g4.shape) != (B, n_c, H, W):
            raise ValueError(f"cotangent of {name} {tuple(g.shape)} is not the "
                             f"output's shape")
        if g4.dtype != torch.float32 or not g4.is_cuda:
            raise ValueError(f"cotangent of {name} must be a float32 CUDA tensor")
        if g4.stride(2) != W * g4.stride(3):   # (h, w) must flatten to a pixel
            g4 = g4.contiguous()
        keep.append(g4)
        desc += [g4.data_ptr(), g4.stride(0), g4.stride(1), g4.stride(3)]
    return (ctypes.c_longlong * len(desc))(*desc), keep


def _launch_bwd(table: torch.Tensor, tri_id: torch.Tensor,
                grads: Sequence[Optional[torch.Tensor]], n_flags: int
                ) -> torch.Tensor:
    """K2b on the forward's (B, F, C) table, for one cotangent (or None) per
    group of GROUPS: -> d_packed (B, C, F), a view of the (B, F, C)
    gradient table."""
    B, F, C = table.shape
    H, W = tri_id.shape[1:]
    desc, keep = _cotangent_table(grads, n_flags, B, H, W)
    d_table = torch.empty_like(table)             # the launch zeroes it
    FUSED_INTERP_BWD(table.data_ptr(), tri_id.data_ptr(), desc, B, F, H, W,
                     n_flags, 2.0 / W, 2.0 / H, d_table.data_ptr())
    del keep
    return d_table.transpose(1, 2)


def _plain_bwd(packed: torch.Tensor, tri_id: torch.Tensor,
               grads: Sequence[Optional[torch.Tensor]], n_flags: int
               ) -> torch.Tensor:
    """K2b's plain version for per-group cotangents: the missing groups'
    cotangent is 0."""
    B, _, F = packed.shape
    H, W = tri_id.shape[1:]
    g = packed.new_zeros((B, N_FIXED_OUT + n_flags, H, W))
    for name, gk in zip(GROUPS, grads):
        if gk is not None:
            g[:, group_slices(n_flags)[name]] = gk
    return fused_interp_bwd_plain(packed, tri_id, g, n_flags)


def _outputs(ctx, chans, saved, tri_id, n_flags):
    """The per-output form shared by both autograd nodes: save what the
    backward needs and return the InterpOut groups as separate outputs
    (views of the one channel buffer). Unused outputs then come back with
    no cotangent (None), not a zero-filled one."""
    ctx.set_materialize_grads(False)
    ctx.n_flags = n_flags
    ctx.save_for_backward(saved, tri_id)
    groups = split_channels(chans, n_flags)
    ctx.mark_non_differentiable(groups.match)
    return tuple(groups)


class _FusedInterp(torch.autograd.Function):
    """K2f launch; its backward launches K2b (the adjoint of pixel_math
    summed per face, TPU kernel _bwd_kernel_flat) with one cotangent per
    output group. The forward saves the (B, F, C) table and tri_id; K2b
    re-reads each pixel's face row."""

    @staticmethod
    def forward(ctx, packed, tri_id, n_flags):
        _check_shapes(packed, tri_id, n_flags)
        B, C, F = packed.shape
        H, W = tri_id.shape[1:]
        table = packed.transpose(1, 2).contiguous()              # (B, F, C)
        out = torch.empty((B, N_FIXED_OUT + n_flags, H, W),
                          dtype=torch.float32, device=packed.device)
        FUSED_INTERP(table.data_ptr(), tri_id.data_ptr(), B, F, H, W, n_flags,
                     2.0 / W, 2.0 / H, out.data_ptr())
        return _outputs(ctx, out, table, tri_id, n_flags)

    @staticmethod
    def backward(ctx, *grads):
        table, tri_id = ctx.saved_tensors
        grads = grads[:len(GROUPS)]                 # match carries none
        if all(g is None for g in grads):
            return None, None, None
        return _launch_bwd(table, tri_id, grads, ctx.n_flags), None, None


class _FusedInterpPlain(torch.autograd.Function):
    """The same per-output node for CPU tensors, through the plain versions
    (fused_interp_plain forward, _plain_bwd backward)."""

    @staticmethod
    def forward(ctx, packed, tri_id, n_flags):
        out, _ = fused_interp_plain(packed, tri_id, n_flags)
        return _outputs(ctx, out, packed, tri_id, n_flags)

    @staticmethod
    def backward(ctx, *grads):
        packed, tri_id = ctx.saved_tensors
        grads = grads[:len(GROUPS)]
        if all(g is None for g in grads):
            return None, None, None
        return _plain_bwd(packed, tri_id, grads, ctx.n_flags), None, None


def fused_interp_bwd(packed: torch.Tensor, tri_id: torch.Tensor,
                     g: torch.Tensor, n_flags: int) -> torch.Tensor:
    """K2b alone: the table gradient (B, 36+nf, F) of fused_interp for the
    whole cotangent g (B, 20+nf, H, W). CUDA tensors go through the kernel
    (g's groups as InterpOut splits it), CPU tensors through
    `fused_interp_bwd_plain`."""
    if packed.device.type == "cpu":
        return fused_interp_bwd_plain(packed, tri_id, g, n_flags)
    _check_shapes(packed, tri_id, n_flags)
    g = g.contiguous()
    check_cuda_tensor("grad", g, torch.float32, 4)
    B, _, F = packed.shape
    H, W = tri_id.shape[1:]
    if tuple(g.shape) != (B, N_FIXED_OUT + n_flags, H, W):
        raise ValueError(f"grad {tuple(g.shape)} is not the forward's output "
                         f"shape {(B, N_FIXED_OUT + n_flags, H, W)}")
    groups = split_channels(g, n_flags)
    return _launch_bwd(packed.transpose(1, 2).contiguous(), tri_id,
                       [getattr(groups, k) for k in GROUPS], n_flags)


def fused_interp(packed: torch.Tensor, tri_id: torch.Tensor, n_flags: int):
    """(B, 36+nf, F) face tables + tri_id (B, H, W) ->
    (InterpOut of the (B, 20+nf, H, W) channels' groups, overflow = 0).

    CUDA tensors go through kernel K2f (and K2b backward); CPU tensors
    through the plain versions, in a node of the same per-output form.
    """
    node = _FusedInterpPlain if packed.device.type == "cpu" else _FusedInterp
    return InterpOut(*node.apply(packed, tri_id, n_flags)), 0
