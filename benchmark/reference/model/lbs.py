"""Linear blend skinning math for FLAME, on torch tensors.

Counterpart of vhap_tpu/model/lbs.py (reference: vhap/model/lbs.py), with
the same conventions so fitted parameter archives are interchangeable:
  * axis-angle -> rotation via Rodrigues with the same eps
  * pose feature excludes the root joint
  * posedirs in (V, 3, P) layout, contracted as (P,) @ (P, V*3)
The 5-joint kinematic chain is a Python loop over the joints.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def batch_rodrigues(rot_vecs: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), including the
    reference's `+1e-8` inside the norm (vhap/model/lbs.py:25-57)."""
    shape = rot_vecs.shape[:-1]
    rv = rot_vecs.reshape(-1, 3)
    angle = torch.linalg.norm(rv + epsilon, dim=1, keepdim=True)
    rot_dir = rv / angle

    cos = torch.cos(angle)[:, None]  # (N,1,1)
    sin = torch.sin(angle)[:, None]

    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1
    ).reshape(-1, 3, 3)

    ident = torch.eye(3, dtype=rv.dtype, device=rv.device)[None]
    rot_mat = ident + sin * K + (1.0 - cos) * torch.matmul(K, K)
    return rot_mat.reshape(*shape, 3, 3)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, L) x (V, 3, L) -> (B, V, 3) as one (B, L) @ (L, V*3) product."""
    V, _, L = shape_disps.shape
    out = torch.matmul(betas, shape_disps.reshape(V * 3, L).T)
    return out.reshape(betas.shape[0], V, 3)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def vertices2landmarks(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    lmk_faces_idx: torch.Tensor,
    lmk_bary_coords: torch.Tensor,
) -> torch.Tensor:
    """Barycentric landmarks: vertices (B, V, 3); faces (F, 3);
    lmk_faces_idx (L,); lmk_bary_coords (L, 3) -> (B, L, 3)."""
    lmk_faces = faces[lmk_faces_idx]              # (L, 3)
    lmk_verts = vertices[:, lmk_faces]            # (B, L, 3, 3)
    return torch.einsum("blfi,lf->bli", lmk_verts, lmk_bary_coords)


def _transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4) rigid transform."""
    top = torch.cat([R, t[..., None]], dim=-1)               # (..., 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(
    rot_mats: torch.Tensor,   # (B, J, 3, 3)
    joints: torch.Tensor,     # (B, J, 3)
    parents: Sequence[int],   # (J,), parents[0] == -1, parents[i] < i
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics over the joint tree (vhap/model/lbs.py:254-304).

    Returns posed joints (B, J, 3) and relative transforms (B, J, 4, 4).
    """
    J = joints.shape[1]
    parents = [int(p) for p in parents]
    rel_joints = torch.stack(
        [joints[:, i] - (joints[:, p] if p >= 0 else 0.0)
         for i, p in enumerate(parents)], dim=1)
    transforms_mat = _transform_mat(rot_mats, rel_joints)   # (B, J, 4, 4)

    chain = []
    for i in range(J):
        p = parents[i]
        chain.append(transforms_mat[:, i] if p < 0
                     else torch.matmul(chain[p], transforms_mat[:, i]))
    transforms = torch.stack(chain, dim=1)                  # (B, J, 4, 4)

    posed_joints = transforms[..., :3, 3]

    # rel_transforms = T - [0 | T @ (joint, 0)]  (removes rest-pose joint offset)
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    shifted = torch.einsum("bjrc,bjc->bjr", transforms, joints_homo)  # (B, J, 4)
    correction = torch.cat(
        [torch.zeros_like(transforms[..., :3]), shifted[..., None]], dim=-1)
    return posed_joints, transforms - correction


def lbs(
    pose: torch.Tensor,          # (B, J*3) axis-angle
    v_shaped: torch.Tensor,      # (B, V, 3)
    posedirs: torch.Tensor,      # (V, 3, P)
    J_regressor: torch.Tensor,   # (J, V)
    parents: Sequence[int],      # (J,)
    lbs_weights: torch.Tensor,   # (V, J)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear blend skinning (vhap/model/lbs.py:101-195).

    Returns (verts (B,V,3), posed joints (B,J,3), A[:,1] the neck transform).
    """
    B = pose.shape[0]
    J = J_regressor.shape[0]

    joints = vertices2joints(J_regressor, v_shaped)

    rot_mats = batch_rodrigues(pose.reshape(B, J, 3))      # (B, J, 3, 3)
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # (B, (J-1)*9)
    pose_offsets = blend_shapes(pose_feature, posedirs)     # (B, V, 3)

    v_posed = v_shaped + pose_offsets

    J_transformed, A = batch_rigid_transform(rot_mats, joints, parents)

    T = torch.einsum("vj,bjrc->bvrc", lbs_weights, A)       # (B, V, 4, 4)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvrc,bvc->bvr", T, v_homo)[..., :3]

    return verts, J_transformed, A[:, 1]
