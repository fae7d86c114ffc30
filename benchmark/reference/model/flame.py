"""FLAME head model as an `nn.Module` with its constants as buffers.

Counterpart of vhap_tpu/model/flame.py: mesh surgery (model/surgery.py)
and mask construction happen once in numpy at build time
(`FlameHead.build`), and `forward` is the chain of blendshape products and
LBS of vhap/model/flame.py:571-646.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.device import resolve_device
from reference.model import lbs as L
from reference.model import surgery
from reference.model.assets import FlameAssets, load_flame_assets
from reference.model.masks import FlameMasks, FlameUvMasks

def build_uniform_laplacian(num_verts: int, faces: np.ndarray):
    """Uniform graph Laplacian as a padded neighbor table.

    pytorch3d `laplacian_packed` semantics (vhap/model/flame.py:196-201):
    L[i,j] = 1/deg(i) for mesh edges, L[i,i] = -1, stored as (V, Dmax)
    neighbor indices + weights. Returns (nbr_idx int32 (V, Dmax), nbr_w
    float32 (V, Dmax)); padding entries point at vertex 0 with weight 0.
    """
    edges = set()
    f = np.asarray(faces)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        for i, j in zip(f[:, a], f[:, b]):
            if i != j:
                edges.add((min(i, j), max(i, j)))
    adj: Dict[int, list] = {}
    for i, j in edges:
        adj.setdefault(int(i), []).append(int(j))
        adj.setdefault(int(j), []).append(int(i))
    dmax = max((len(v) for v in adj.values()), default=1)
    nbr_idx = np.zeros((num_verts, dmax), dtype=np.int32)
    nbr_w = np.zeros((num_verts, dmax), dtype=np.float32)
    for i, nbrs in adj.items():
        nbr_idx[i, :len(nbrs)] = nbrs
        nbr_w[i, :len(nbrs)] = 1.0 / len(nbrs)
    return nbr_idx, nbr_w


def laplacian_apply(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """L @ x for x (..., V, C): neighbor average minus self."""
    gathered = x[..., nbr_idx, :]                 # (..., V, D, C)
    avg = torch.einsum("...vdc,vd->...vc", gathered, nbr_w)
    return avg - x


def laplacian_blur_apply(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """(L - 2*diag(L)) @ w / 2 = (w + neighbor-average) / 2.

    The vertex-weight blur from vhap/model/tracker.py:607-614.
    """
    gathered = w[..., nbr_idx, :]
    avg = torch.einsum("...vdc,vd->...vc", gathered, nbr_w)
    return (w + avg) / 2


class FlameHead(nn.Module):
    """FLAME model constants (buffers) + forward.

    Built with `FlameHead.build(...)`, which mirrors the configuration
    surface of vhap/model/flame.py:70-204.
    """

    def __init__(self, n_shape: int, n_expr: int, a: FlameAssets,
                 masks: FlameMasks, nbr_idx: np.ndarray, nbr_w: np.ndarray,
                 device: torch.device):
        super().__init__()
        self.n_shape = n_shape
        self.n_expr = n_expr
        self.parents = [int(p) for p in a.parents]
        self.masks = masks
        self.uv_masks = FlameUvMasks(a.uv_masks)
        self.assets = a

        def buf(name, arr, dtype):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(arr), dtype=dtype, device=device))

        buf("v_template", a.v_template, torch.float32)        # (V, 3)
        buf("shapedirs", a.shapedirs, torch.float32)          # (V, 3, n_shape + n_expr)
        buf("posedirs", a.posedirs, torch.float32)            # (V, 3, 36)
        buf("J_regressor", a.J_regressor, torch.float32)      # (J, V)
        buf("lbs_weights", a.lbs_weights, torch.float32)      # (V, J)
        buf("faces", a.faces, torch.long)                     # (F, 3)
        buf("verts_uvs", a.verts_uvs, torch.float32)          # (Vt, 2)
        buf("textures_idx", a.textures_idx, torch.long)       # (F, 3)
        buf("lmk_faces_idx", a.lmk_faces_idx, torch.long)     # (L,)
        buf("lmk_bary_coords", a.lmk_bary_coords, torch.float32)  # (L, 3)
        buf("lap_nbr_idx", nbr_idx, torch.long)               # (V, D)
        buf("lap_nbr_w", nbr_w, torch.float32)                # (V, D)

    @staticmethod
    def build(
        n_shape: int = 300,
        n_expr: int = 100,
        asset_dir=None,
        assets: Optional[FlameAssets] = None,
        add_teeth: bool = True,
        connect_lip_inside: bool = False,
        remove_lip_inside: bool = False,
        remove_torso: bool = False,
        disable_deformation_on_torso: bool = False,
        face_clusters: Sequence[str] = (),
        device=None,
    ) -> "FlameHead":
        device = resolve_device(device)
        a = assets if assets is not None else load_flame_assets(asset_dir)
        a = copy.copy(a)
        for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                     "lbs_weights", "faces", "verts_uvs", "textures_idx"):
            setattr(a, name, np.array(getattr(a, name)))

        # truncate basis: first n_shape identity dirs + expr dirs starting at
        # column 300 (vhap/model/flame.py:104-109)
        total = a.shapedirs.shape[2]
        expr_start = 300 if total >= 300 + n_expr else total - n_expr
        a.shapedirs = np.concatenate(
            [a.shapedirs[:, :, :n_shape],
             a.shapedirs[:, :, expr_start:expr_start + n_expr]], axis=2)

        masks = FlameMasks(a.part_masks, a.faces, a.textures_idx,
                           a.v_template.shape[0], face_clusters)

        faces_orig = a.faces.copy()  # the Laplacian's connectivity
        if add_teeth:
            surgery.add_teeth(a, masks, n_shape)
        if connect_lip_inside:
            surgery.connect_lip_inside(a, masks)
        if remove_lip_inside:
            surgery.remove_lip_inside(a, masks)
        if remove_torso:
            surgery.remove_torso(a, masks)
        if disable_deformation_on_torso:
            surgery.disable_deformation_on_torso(a, masks, n_expr)

        # the pre-surgery connectivity over the (teeth-extended) vertex
        # count, as in vhap/model/flame.py:196
        nbr_idx, nbr_w = build_uniform_laplacian(a.v_template.shape[0], faces_orig)
        return FlameHead(n_shape, n_expr, a, masks, nbr_idx, nbr_w, device)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def forward(
        self,
        shape: torch.Tensor,        # (B, n_shape)
        expr: torch.Tensor,         # (B, n_expr)
        rotation: torch.Tensor,     # (B, 3)
        neck: torch.Tensor,         # (B, 3)
        jaw: torch.Tensor,          # (B, 3)
        eyes: torch.Tensor,         # (B, 6)
        translation: torch.Tensor,  # (B, 3)
        zero_centered_at_root_node: bool = False,
        return_landmarks: bool = True,
        return_verts_cano: bool = False,
        static_offset: Optional[torch.Tensor] = None,   # (1|B, V, 3)
        dynamic_offset: Optional[torch.Tensor] = None,  # (B, V, 3)
    ):
        """FLAME forward (vhap/model/flame.py:571-646).

        Returns [verts, (verts_cano), (landmarks)] following the reference's
        return-list convention.
        """
        betas = torch.cat([shape, expr], dim=1)
        full_pose = torch.cat([rotation, neck, jaw, eyes], dim=1)

        v_shaped = self.v_template[None] + L.blend_shapes(betas, self.shapedirs)
        if static_offset is not None:
            v_shaped = v_shaped + static_offset
        if dynamic_offset is not None:
            v_shaped = v_shaped + dynamic_offset

        verts, J, _ = L.lbs(full_pose, v_shaped, self.posedirs,
                            self.J_regressor, self.parents, self.lbs_weights)

        if zero_centered_at_root_node:
            verts = verts - J[:, :1]
            J = J - J[:, :1]

        verts = verts + translation[:, None, :]

        ret = [verts]
        if return_verts_cano:
            ret.append(v_shaped)
        if return_landmarks:
            ret.append(L.vertices2landmarks(
                verts, self.faces, self.lmk_faces_idx, self.lmk_bary_coords))
        return ret if len(ret) > 1 else ret[0]


class FlameTexPainted(nn.Module):
    """Fixed painted base texture resized to tex_size (flame.py:649-662).

    Produces (1, 3, T, T) float in [0, 1] to match the reference layout.
    jax.image.resize(..., "bilinear") is a triangle filter on half-pixel
    centers, renormalized at the borders: F.interpolate with
    align_corners=False reproduces it, upsampling (512 -> 2048 here) with or
    without its antialias filter and downsampling only with it, so the
    filter stays on.
    """

    def __init__(self, tex_painted_u8: np.ndarray, tex_size: int = 512,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        tex = torch.as_tensor(tex_painted_u8.astype(np.float32) / 255.0,
                              device=device)                  # (H, W, 3)
        tex = tex.permute(2, 0, 1)[None].contiguous()         # (1, 3, H, W)
        if tex.shape[-1] != tex_size or tex.shape[-2] != tex_size:
            tex = F.interpolate(tex, size=(tex_size, tex_size),
                                mode="bilinear", align_corners=False,
                                antialias=True)
        self.register_buffer("tex_painted", tex)
        self.tex_size = tex_size

    def forward(self) -> torch.Tensor:
        return self.tex_painted


class FlameTexPCA(nn.Module):
    """PCA texture space: mean + basis @ code, BGR->RGB, /255, clamp
    (flame.py:665-687; vhap_tpu/model/flame.py FlameTexPCA)."""

    def __init__(self, tex_mean: np.ndarray, tex_basis: np.ndarray,
                 n_tex: int, tex_size: int = 512, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("mean", torch.as_tensor(
            np.asarray(tex_mean, np.float32).reshape(1, -1), device=device))
        self.register_buffer("basis", torch.as_tensor(
            np.asarray(tex_basis, np.float32)[:, :n_tex], device=device))
        self.tex_size = tex_size

    def forward(self, texcode: torch.Tensor) -> torch.Tensor:
        """(B, n_tex) -> (B, 3, T, T) in [0, 1]."""
        tex = self.mean + texcode @ self.basis.T
        B = texcode.shape[0]
        tex = tex.reshape(B, 512, 512, 3).permute(0, 3, 1, 2)
        if self.tex_size != 512:
            # jax.image.resize's bilinear (see FlameTexPainted)
            tex = F.interpolate(tex, size=(self.tex_size, self.tex_size),
                                mode="bilinear", align_corners=False,
                                antialias=True)
        tex = torch.flip(tex, dims=[1])     # BGR -> RGB (flame.py:685)
        return torch.clamp(tex / 255.0, 0.0, 1.0)
