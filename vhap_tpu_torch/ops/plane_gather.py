"""Per-pixel lookup of per-face table rows, and its adjoint.

Counterpart of vhap_tpu/ops/plane_pallas.py (`plane_gather_tiled`) and of
the XLA gather it reproduces, `gather_face_planes_packed`
(vhap_tpu/ops/rasterize.py:468-479):

    planes[b, c, i, j] = packed[b, c, max(tri_id[b, i, j] - 1, 0)]

for a table packed (B|1, C, F) (batch 1: one table shared by every image)
and the winning face ids tri_id (B, H, W), 0 = background. Background
pixels read face 0's row, and in the backward send their cotangent to face
0, as the JAX gather's clamped index does. There are no tile lists, so the
TPU kernel's `plane_overflow` count is always 0 here.

`plane_gather` launches the CUDA kernel K6 (csrc/plane_gather.cu) for CUDA
tensors, and its backward the K6 scatter kernel; `plane_gather_plain` is
their plain PyTorch version (`torch.gather`, whose autograd is
`scatter_add_`), and `plane_gather_bwd_plain` the plain backward alone.
"""

from __future__ import annotations

import torch

from vhap_tpu_torch.ops.kernels import Kernel, c_int, c_ptr, check_cuda_tensor

MAX_CHANNELS = 4096   # the backward keeps C face-0 sums in shared memory


def _face_index(tri_id: torch.Tensor, C: int) -> torch.Tensor:
    """tri_id (B, H, W) -> clamped face ids (B, C, H*W) int64 (a view)."""
    B, H, W = tri_id.shape
    fid = torch.clamp(tri_id.long() - 1, min=0).reshape(B, 1, H * W)
    return fid.expand(B, C, H * W)


def plane_gather_plain(packed: torch.Tensor, tri_id: torch.Tensor) -> torch.Tensor:
    """packed (B|1, C, F), tri_id (B, H, W) -> planes (B, C, H, W)."""
    B, H, W = tri_id.shape
    C, F = packed.shape[1:]
    rows = torch.gather(packed.expand(B, C, F), 2, _face_index(tri_id, C))
    return rows.reshape(B, C, H, W)


def plane_gather_bwd_plain(tri_id: torch.Tensor, g: torch.Tensor,
                           packed_batch: int, n_faces: int) -> torch.Tensor:
    """The gradient of `plane_gather_plain` with respect to its table, for
    the cotangent g (B, C, H, W): d_packed (packed_batch, C, n_faces)."""
    B, C, H, W = g.shape
    d = torch.zeros((B, C, n_faces), dtype=g.dtype, device=g.device)
    d.scatter_add_(2, _face_index(tri_id, C), g.reshape(B, C, H * W))
    return d.sum(0, keepdim=True) if packed_batch == 1 and B > 1 else d


PLANE_GATHER = Kernel("plane_gather", "vhap_plane_gather",
                      [c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int, c_ptr])
PLANE_GATHER_BWD = Kernel("plane_gather_bwd", "vhap_plane_gather_bwd",
                          [c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int,
                           c_ptr])


def _check_inputs(packed: torch.Tensor, tri_id: torch.Tensor) -> None:
    check_cuda_tensor("packed", packed, torch.float32, 3)
    check_cuda_tensor("tri_id", tri_id, torch.int32, 3)
    if packed.shape[0] not in (1, tri_id.shape[0]):
        raise ValueError(f"packed {tuple(packed.shape)} has neither batch 1 "
                         f"nor tri_id's batch {tri_id.shape[0]}")
    if packed.shape[1] > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {packed.shape[1]}")


def _launch_bwd(tri_id: torch.Tensor, g: torch.Tensor, packed_batch: int,
                n_faces: int) -> torch.Tensor:
    B, H, W = tri_id.shape
    g = g.contiguous()
    check_cuda_tensor("grad", g, torch.float32, 4)
    if g.shape[0] != B or tuple(g.shape[2:]) != (H, W):
        raise ValueError(f"grad {tuple(g.shape)} does not match tri_id "
                         f"{tuple(tri_id.shape)}")
    C = g.shape[1]
    if C > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {C}")
    d_packed = torch.zeros((packed_batch, C, n_faces), dtype=torch.float32,
                           device=g.device)
    PLANE_GATHER_BWD(g.data_ptr(), tri_id.data_ptr(), B, packed_batch, C,
                     n_faces, H * W, d_packed.data_ptr())
    return d_packed


class _PlaneGather(torch.autograd.Function):
    """K6 launch; its backward launches the K6 scatter (the TPU kernels
    _fwd_kernel and _bwd_kernel of plane_pallas.py). The forward saves only
    tri_id: the table's gradient does not depend on its values."""

    @staticmethod
    def forward(ctx, packed, tri_id):
        _check_inputs(packed, tri_id)
        B, H, W = tri_id.shape
        pb, C, F = packed.shape
        out = torch.empty((B, C, H, W), dtype=torch.float32, device=packed.device)
        PLANE_GATHER(packed.data_ptr(), tri_id.data_ptr(), B, pb, C, F, H * W,
                     out.data_ptr())
        ctx.save_for_backward(tri_id)
        ctx.table_shape = (pb, F)
        return out

    @staticmethod
    def backward(ctx, grad):
        (tri_id,) = ctx.saved_tensors
        return _launch_bwd(tri_id, grad, *ctx.table_shape), None


def plane_gather(packed: torch.Tensor, tri_id: torch.Tensor) -> torch.Tensor:
    """packed (B|1, C, F) float32 face table, tri_id (B, H, W) int32 ->
    planes (B, C, H, W).

    CUDA tensors go through kernel K6 (and its scatter backward); CPU
    tensors through `plane_gather_plain`.
    """
    if packed.device.type == "cpu":
        return plane_gather_plain(packed, tri_id)
    return _PlaneGather.apply(packed.contiguous(), tri_id.contiguous())


def plane_gather_bwd(tri_id: torch.Tensor, g: torch.Tensor, packed_batch: int,
                     n_faces: int) -> torch.Tensor:
    """K6's scatter alone: the table gradient (packed_batch, C, n_faces) of
    plane_gather for the cotangent g (B, C, H, W). CUDA tensors go through
    the kernel, CPU tensors through `plane_gather_bwd_plain`."""
    if g.device.type == "cpu":
        return plane_gather_bwd_plain(tri_id, g, packed_batch, n_faces)
    check_cuda_tensor("tri_id", tri_id, torch.int32, 3)
    return _launch_bwd(tri_id, g, packed_batch, n_faces)
