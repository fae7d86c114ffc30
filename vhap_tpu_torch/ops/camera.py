"""Camera transforms: intrinsics -> GL projection, world/camera/clip/NDC.

Counterpart of vhap_tpu/ops/camera.py (reference:
vhap/util/render_nvdiffrast.py:102-214), same OpenGL clip convention
(z_sign = -1, y-up clip space => rendered buffers are bottom-up until the
final flip).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vhap_tpu_torch.device import constant


def projection_from_intrinsics(K: torch.Tensor, image_size: Tuple[int, int],
                               near: float = 0.1, far: float = 10.0) -> torch.Tensor:
    """Intrinsics (N,3,3) or (N,4)[fx,fy,cx,cy] -> GL projection (N,4,4)."""
    if K.shape[-2:] == (3, 3):
        fx, fy = K[..., 0, 0], K[..., 1, 1]
        cx, cy = K[..., 0, 2], K[..., 1, 2]
    elif K.shape[-1] == 4:
        fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    else:
        raise ValueError(f"Expected K (N,3,3) or (N,4), got {tuple(K.shape)}")

    h, w = image_size
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    row0 = torch.stack([fx * 2 / w, z, (w - 2 * cx) / w, z], dim=-1)
    row1 = torch.stack([z, fy * 2 / h, (h - 2 * cy) / h, z], dim=-1)
    row2 = torch.stack([z, z, o * (-(far + near) / (far - near)),
                        o * (-2 * far * near / (far - near))], dim=-1)
    row3 = torch.stack([z, z, -o, z], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def _pad_rt(RT: torch.Tensor) -> torch.Tensor:
    """(N,3,4) world->camera -> (N,4,4) homogeneous."""
    if RT.shape[-2] == 4:
        return RT
    bottom = torch.zeros_like(RT[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([RT, bottom], dim=-2)


def _homogenize(vtx: torch.Tensor) -> torch.Tensor:
    if vtx.shape[-1] == 4:
        return vtx
    return torch.cat([vtx, torch.ones_like(vtx[..., :1])], dim=-1)


def world_to_camera(vtx: torch.Tensor, RT: torch.Tensor) -> torch.Tensor:
    """(B,V,3|4) x (B,3|4,4) -> (B,V,4)."""
    return torch.einsum("bvc,brc->bvr", _homogenize(vtx), _pad_rt(RT))


def camera_to_clip(vtx: torch.Tensor, K: torch.Tensor, image_size) -> torch.Tensor:
    """(B,V,3|4) -> clip (B,V,4)."""
    proj = projection_from_intrinsics(K, image_size)
    return torch.einsum("bvc,brc->bvr", _homogenize(vtx), proj)


def world_to_clip(vtx: torch.Tensor, RT: torch.Tensor, K: torch.Tensor,
                  image_size) -> torch.Tensor:
    return camera_to_clip(world_to_camera(vtx, RT), K, image_size)


def world_to_ndc(vtx: torch.Tensor, RT: torch.Tensor, K: torch.Tensor, image_size,
                 flip_y: bool = False) -> torch.Tensor:
    """NDC positions (B,V,3)."""
    clip = world_to_clip(vtx, RT, K, image_size)
    ndc = clip[..., :3] / clip[..., 3:]
    if flip_y:
        ndc = ndc * constant((1.0, -1.0, 1.0), ndc.dtype, ndc.device)
    return ndc
