"""Shading: vertex normals, spherical-harmonics lighting, vector ops.

Counterpart of vhap_tpu/ops/shading.py (reference: vhap/util/vector_ops.py
and vhap/util/render_nvdiffrast.py:19-53, 297-347).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vhap_tpu_torch.device import constant


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1, keepdim=True)


def length(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    # eps-clamped sqrt keeps grad(sqrt(0)) finite (vhap/util/vector_ops.py:10-11)
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / length(x, eps)


def compute_face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) x (F, 3) -> unit face normals (B, F, 3)
    (vhap/util/render_nvdiffrast.py:318-330)."""
    v0 = verts[:, faces[:, 0]]
    v1 = verts[:, faces[:, 1]]
    v2 = verts[:, faces[:, 2]]
    return safe_normalize(torch.linalg.cross(v1 - v0, v2 - v0))


def compute_v_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (B, V, 3) via scatter-add
    (vhap/util/render_nvdiffrast.py:297-316)."""
    v0 = verts[:, faces[:, 0]]
    v1 = verts[:, faces[:, 1]]
    v2 = verts[:, faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)    # un-normalized (area weighting)
    all_idx = torch.cat([faces[:, 0], faces[:, 1], faces[:, 2]])
    fn3 = torch.cat([fn, fn, fn], dim=1)
    vn = torch.zeros_like(verts).index_add(1, all_idx, fn3)
    fallback = constant((0.0, 0.0, 1.0), verts.dtype, verts.device)
    vn = torch.where(dot(vn, vn) > 1e-20, vn, fallback)
    return safe_normalize(vn)


# constant factors of the first three SH bands
# (vhap/util/render_nvdiffrast.py:81-97)
_pi = np.pi
SH_CONST = np.array([
    1 / np.sqrt(4 * _pi),
    ((2 * _pi) / 3) * np.sqrt(3 / (4 * _pi)),
    ((2 * _pi) / 3) * np.sqrt(3 / (4 * _pi)),
    ((2 * _pi) / 3) * np.sqrt(3 / (4 * _pi)),
    (_pi / 4) * 3 * np.sqrt(5 / (12 * _pi)),
    (_pi / 4) * 3 * np.sqrt(5 / (12 * _pi)),
    (_pi / 4) * 3 * np.sqrt(5 / (12 * _pi)),
    (_pi / 4) * (3 / 2) * np.sqrt(5 / (12 * _pi)),
    (_pi / 4) * (1 / 2) * np.sqrt(5 / (4 * _pi)),
], dtype=np.float32)


def sh_shading(normals: torch.Tensor, sh_coefficients: torch.Tensor) -> torch.Tensor:
    """9-band SH diffuse shading (vhap/util/render_nvdiffrast.py:19-53).

    normals (B, ..., 3); sh_coefficients (B|1, 9, 3). Returns (B, ..., 3).
    """
    N = normals
    sh = torch.stack([
        N[..., 0] * 0.0 + 1.0,
        N[..., 0], N[..., 1], N[..., 2],
        N[..., 0] * N[..., 1], N[..., 0] * N[..., 2], N[..., 1] * N[..., 2],
        N[..., 0] ** 2 - N[..., 1] ** 2,
        3 * (N[..., 2] ** 2) - 1,
    ], dim=-1) * constant(SH_CONST.tolist(), torch.float32, N.device)
    # broadcast shared lights to the pixel batch explicitly, one light set
    # per batch element
    if sh_coefficients.shape[0] == 1 and sh.shape[0] != 1:
        sh_coefficients = sh_coefficients.expand(
            (sh.shape[0],) + sh_coefficients.shape[1:])
    return torch.einsum("b...k,bkc->b...c", sh, sh_coefficients)


def shade(normal: torch.Tensor, lighting_type: str,
          lights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel diffuse term (vhap/util/render_nvdiffrast.py:332-347)."""
    if lighting_type == "constant":
        return torch.ones_like(normal[..., :3])
    if lighting_type in ("front", "front-range"):
        d = normal[..., 2:3]   # dot(normal, (0, 0, 1))
        if lighting_type == "front":
            return torch.where(d < 0, torch.abs(d) * 0.3, d)
        return torch.clamp(d + 0.75, 0.0, 1.0)
    if lighting_type == "SH":
        return sh_shading(normal, lights)
    raise NotImplementedError(f"Unknown lighting type: {lighting_type}")


def uniform_sh_lights() -> np.ndarray:
    """SH coefficients of uniform white light (vhap/model/tracker.py:1301-1304)."""
    lights = np.zeros((9, 3), np.float32)
    lights[0] = np.sqrt(4 * np.pi)
    return lights
