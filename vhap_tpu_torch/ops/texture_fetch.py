"""Weighted texel fetch: the gather at the heart of trilinear sampling.

Counterpart of the forward of vhap_tpu/ops/texture_grad_pallas.py
`weighted_fetch_exact`:

    out[b, p, :] = sum_k wgt[b, k, p] * flat1[idx[b, k, p], :]

`weighted_fetch` launches the CUDA kernel K3 (csrc/texture_fetch.cu) for
CUDA tensors, and its backward the kernel K4 (csrc/texture_scatter.cu):
the texel gradient `dflat[idx] += wgt * g` with the uv-path weight
gradient `d_wgt = sum_c flat1[idx] * g` in the same launch.
`weighted_fetch_plain` is their plain PyTorch version (autograd gives the
backward); `scatter_taps_plain` and `tap_weight_grad_plain` are the plain
versions of K4's two outputs.

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

from typing import Tuple

import torch

from vhap_tpu_torch.ops.kernels import Kernel, c_int, c_ptr, check_cuda_tensor


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
    """Plain version of K4's texel gradient: idx, wgt (B, K, P); g (B, P, C)
    -> dflat (n_texels, C) with dflat[idx[b, k, p]] += wgt[b, k, p] * g[b, p]."""
    return scatter_vals_plain(idx, wgt[:, :, None, :] * g.transpose(1, 2)[:, None],
                              n_texels)


def tap_weight_grad_plain(flat1: torch.Tensor, idx: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """Plain version of K4's weight gradient: d_wgt (B, K, P) =
    sum_c flat1[idx, c] * g[b, p, c], for every tap (the XLA branch of
    vhap_tpu's _wfe_bwd)."""
    return torch.einsum("bkpc,bpc->bkp", flat1[idx.long()], g)


WEIGHTED_FETCH = Kernel("weighted_fetch", "vhap_weighted_fetch",
                        [c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_ptr])
WEIGHTED_FETCH_BWD = Kernel("weighted_fetch_bwd", "vhap_weighted_fetch_bwd",
                            [c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int,
                             c_ptr, c_ptr])
SCATTER_VALS = Kernel("scatter_vals", "vhap_scatter_vals",
                      [c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_ptr])


def _check_inputs(flat1, idx, wgt):
    check_cuda_tensor("flat1", flat1, torch.float32, 2)
    check_cuda_tensor("idx", idx, torch.int32, 3)
    check_cuda_tensor("wgt", wgt, torch.float32, 3)
    if flat1.shape[1] != 3:
        raise ValueError(f"flat1 must have 3 channels, got {tuple(flat1.shape)}")
    if idx.shape != wgt.shape:
        raise ValueError(f"idx {tuple(idx.shape)} != wgt {tuple(wgt.shape)}")


def _launch_bwd(flat1, idx, wgt, g) -> Tuple[torch.Tensor, torch.Tensor]:
    B, K, P = idx.shape
    g = g.contiguous()
    check_cuda_tensor("grad", g, torch.float32, 3)
    if tuple(g.shape) != (B, P, 3):
        raise ValueError(f"grad {tuple(g.shape)} is not the forward's output "
                         f"shape {(B, P, 3)}")
    dflat = torch.zeros_like(flat1)
    d_wgt = torch.empty_like(wgt)
    WEIGHTED_FETCH_BWD(flat1.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                       g.data_ptr(), B, K, P, dflat.data_ptr(), d_wgt.data_ptr())
    return dflat, d_wgt


class _WeightedFetch(torch.autograd.Function):
    """K3 launch; its backward launches K4 (the texel scatter, TPU kernel
    _tile_kernel_wg, with the uv-path weight gradient)."""

    @staticmethod
    def forward(ctx, flat1, idx, wgt):
        _check_inputs(flat1, idx, wgt)
        B, K, P = idx.shape
        out = torch.empty((B, P, 3), dtype=torch.float32, device=flat1.device)
        WEIGHTED_FETCH(flat1.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                       B, K, P, out.data_ptr())
        ctx.save_for_backward(flat1, idx, wgt)
        return out

    @staticmethod
    def backward(ctx, grad):
        flat1, idx, wgt = ctx.saved_tensors
        dflat, d_wgt = _launch_bwd(flat1, idx, wgt, grad)
        return dflat, None, d_wgt


def weighted_fetch_bwd(flat1: torch.Tensor, idx: torch.Tensor,
                       wgt: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 alone: (dflat (N, 3), d_wgt (B, K, P)) of weighted_fetch for the
    cotangent g (B, P, 3). CUDA tensors go through the kernel, CPU tensors
    through `scatter_taps_plain` and `tap_weight_grad_plain`."""
    if flat1.device.type == "cpu":
        return (scatter_taps_plain(idx, wgt, g, flat1.shape[0]),
                tap_weight_grad_plain(flat1, idx, g))
    _check_inputs(flat1, idx, wgt)
    return _launch_bwd(flat1, idx, wgt, g)


def weighted_fetch(flat1: torch.Tensor, idx: torch.Tensor,
                   wgt: torch.Tensor) -> torch.Tensor:
    """flat1 (N, C) shared flat mip pyramid; idx (B, K, P) int32 taps in
    [0, N); wgt (B, K, P) -> (B, P, C).

    CUDA tensors go through kernel K3 (and K4 backward); CPU tensors
    through `weighted_fetch_plain`.
    """
    if flat1.device.type == "cpu":
        return weighted_fetch_plain(flat1, idx, wgt)
    return _WeightedFetch.apply(flat1, idx, wgt)


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
