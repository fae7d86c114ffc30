"""Camera rig utilities (numpy): axis alignment, convention conversion,
GL projection, orbit camera for viewers.

A copy of vhap_tpu/util/camera_np.py (reference: vhap/util/camera.py).
"""

from __future__ import annotations

import math
from typing import Literal, Optional, Tuple

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


class OrbitCamera:
    """Interactive orbit camera for viewers (vhap/util/camera.py:137-223)."""

    def __init__(self, W: int, H: int, r: float = 2, fovy: float = 60,
                 znear: float = 1e-8, zfar: float = 10,
                 convention: Literal["opengl", "opencv"] = "opengl"):
        self.image_width = W
        self.image_height = H
        self.radius_default = r
        self.fovy_default = fovy
        self.znear = znear
        self.zfar = zfar
        self.convention = convention
        self.up = np.array([0, 1, 0], dtype=np.float32)
        self.reset()

    def reset(self):
        self._R = np.eye(3, dtype=np.float32)
        self.look_at = np.zeros(3, dtype=np.float32)
        self.radius = self.radius_default
        self.fovy = self.fovy_default
        self.z_sign = 1 if self.convention == "opencv" else -1
        self.y_sign = 1 if self.convention == "opencv" else -1

    @property
    def fovx(self):
        return self.fovy / self.image_height * self.image_width

    @property
    def intrinsics(self):
        focal = self.image_height / (2 * np.tan(np.radians(self.fovy) / 2))
        return np.array([focal, focal, self.image_width // 2, self.image_height // 2])

    @property
    def projection_matrix(self):
        return projection_from_intrinsics(
            self.intrinsics[None], (self.image_height, self.image_width),
            self.znear, self.zfar, z_sign=self.z_sign)[0]

    @property
    def world_view_transform(self):
        return np.linalg.inv(self.pose)

    @property
    def full_proj_transform(self):
        return self.projection_matrix @ self.world_view_transform

    @property
    def pose(self):
        pose = np.eye(4, dtype=np.float32)
        pose[2, 3] += self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self._R
        pose = rot @ pose
        pose[:3, 3] -= self.look_at
        if self.convention == "opencv":
            pose[:, [1, 2]] *= -1
        return pose

    @staticmethod
    def _rotvec_to_mat(v: np.ndarray) -> np.ndarray:
        theta = np.linalg.norm(v)
        if theta < 1e-12:
            return np.eye(3, dtype=np.float32)
        k = v / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return (np.eye(3) + np.sin(theta) * K
                + (1 - np.cos(theta)) * (K @ K)).astype(np.float32)

    def orbit(self, dx, dy):
        side = self._R[:3, 0]
        rx = self._rotvec_to_mat(self.up * np.radians(-0.3 * dx))
        ry = self._rotvec_to_mat(side * np.radians(-0.3 * dy))
        self._R = rx @ ry @ self._R

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0):
        d = np.array([dx, -dy, dz])
        self.look_at += (2 * self._R @ d * self.radius / self.image_height
                         * math.tan(np.radians(self.fovy) / 2))
