"""Camera rig utilities (numpy): axis alignment, convention conversion,
GL projection.

A copy of vhap_tpu/util/camera_np.py (reference: vhap/util/camera.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def gram_schmidt_orthogonalization(M: np.ndarray) -> np.ndarray:
    """Orthonormalize column vectors in place (vhap/util/camera.py:67-81)."""
    M = M.copy()
    num_rows, num_cols = M.shape
    for c in range(1, num_cols):
        for cc in (c - 1, c):
            M[:, cc] = M[:, cc] / max(np.linalg.norm(M[:, cc]), 1e-12)
        M[:, c] -= M[:, :c] @ (M[:, :c].T @ M[:, c])
    M[:, -1] = M[:, -1] / max(np.linalg.norm(M[:, -1]), 1e-12)
    return M


def align_cameras_to_axes(R: np.ndarray, T: np.ndarray,
                          target_convention: Optional[str] = None):
    """Rotate the rig so the mean camera axes coincide with world axes
    (vhap/util/camera.py:18-42). R (N,3,3), T (N,3,1)."""
    bases_c2w = gram_schmidt_orthogonalization(R.mean(0))
    if target_convention == "opengl":
        bases_c2w[:, [1, 2]] *= -1
    bases_w2c = bases_c2w.T
    return bases_w2c[None] @ R, bases_w2c[None] @ T


def convert_camera_convention(conversion: str, R: np.ndarray, K: np.ndarray,
                              H: int, W: int):
    """In-place-style convention flips (vhap/util/camera.py:45-64)."""
    R = R.copy()
    K = K.copy()
    if conversion == "opencv->opengl":
        R[:, :3, [1, 2]] *= -1
        K[..., 1, 2] = H - K[..., 1, 2]
    elif conversion == "opencv->pytorch3d":
        R[:, :3, [0, 1]] *= -1
        K[..., 0, 2] = W - K[..., 0, 2]
        K[..., 1, 2] = H - K[..., 1, 2]
    elif conversion == "opengl->pytorch3d":
        R[:, :3, [0, 2]] *= -1
        K[..., 0, 2] = W - K[..., 0, 2]
    elif conversion is not None:
        raise ValueError(f"Unknown camera convention conversion: {conversion}")
    return R, K


def projection_from_intrinsics(K: np.ndarray, image_size: Tuple[int, int],
                               near: float = 0.01, far: float = 10.0,
                               flip_y: bool = False, z_sign: float = -1):
    """Numpy GL projection (vhap/util/camera.py:84-134)."""
    B = K.shape[0]
    h, w = image_size
    if K.shape[-2:] == (3, 3):
        fx, fy = K[..., 0, 0], K[..., 1, 1]
        cx, cy = K[..., 0, 2], K[..., 1, 2]
    elif K.shape[-1] == 4:
        fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    else:
        raise ValueError(f"Expected K (N,3,3) or (N,4), got: {K.shape}")

    proj = np.zeros([B, 4, 4], dtype=np.float32)
    proj[:, 0, 0] = fx * 2 / w
    proj[:, 1, 1] = fy * 2 / h
    proj[:, 0, 2] = (w - 2 * cx) / w
    proj[:, 1, 2] = (h - 2 * cy) / h
    proj[:, 2, 2] = z_sign * (far + near) / (far - near)
    proj[:, 2, 3] = -2 * far * near / (far - near)
    proj[:, 3, 2] = z_sign
    if flip_y:
        proj[:, 1, 1] *= -1
    return proj

