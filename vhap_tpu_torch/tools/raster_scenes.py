"""Adversarial scenes for the visibility kernel (K1/K5) and the fused
interpolation's backward (K2b), built from a numpy seed.

Each scene is a batch of clip-space triangles aimed at one edge case of the
kernels' designs (csrc/visibility.cu, csrc/interp_bwd.cu):

  coplanar_ties   every triangle twice (same corners, and corners rotated),
                  plus triangles at z = 0 exactly: equal-z ties, which go to
                  the lowest face id, and -0.0 against +0.0;
  covering_face   one triangle over most of the image behind a random
                  scene: a face over more tiles than a tile list takes (the
                  image's shared list, tested by every tile);
  near_plane      corners behind the camera (w < 0): near-plane straddlers
                  with the clipless setup and a full-screen box;
  crowded_tile    one 16 x 16 tile under a grid of 256 one-pixel triangles
                  (256 distinct faces in a tile: K2b's slot table full) in
                  front of 1000 slivers (more candidates than K1's tile list
                  and one shared-memory chunk hold: the list spills);
  ragged          a random scene at an image size that is no multiple of the
                  16-pixel tile.

`interp_inputs` adds a random face table and per-group cotangents for K2b.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

SCENES = ("coplanar_ties", "covering_face", "near_plane", "crowded_tile",
          "ragged")


def _random(rng, B, V, F, w_lo=1.0, w_hi=3.0):
    verts = rng.uniform(-0.9, 0.9, (B, V, 3))
    w = rng.uniform(w_lo, w_hi, (B, V, 1))
    return np.concatenate([verts * w, w], -1), rng.integers(0, V, (F, 3))


def _pixel_ndc(k, n):
    return (k + 0.5) * (2.0 / n) - 1.0


def build(name: str, B: int = 2, size: Optional[Tuple[int, int]] = None,
          seed: int = 0, device=None) -> Dict:
    """-> dict(clip (B, V, 4) f32, faces (F, 3) int64, H, W, cull)."""
    rng = np.random.default_rng(seed)
    H, W = size or ((37, 91) if name == "ragged" else (96, 160))
    cull = True
    if name in ("coplanar_ties", "ragged"):
        clip, faces = _random(rng, B, 200, 300)
        if name == "coplanar_ties":
            # z = 0 exactly on 60 more corners, shared by 100 faces
            flat = np.concatenate([rng.uniform(-0.9, 0.9, (B, 60, 2)),
                                   np.zeros((B, 60, 1)), np.ones((B, 60, 1))], -1)
            clip = np.concatenate([clip, flat], 1)
            zf = 200 + rng.integers(0, 60, (100, 3))
            base = np.concatenate([faces, zf], 0)
            rot = base[:, [1, 2, 0]]
            faces = np.concatenate([base, base[::-1], rot], 0)
            cull = False
    elif name == "covering_face":
        clip, faces = _random(rng, B, 200, 300)
        big = np.array([[-2.5, -2.5, 0.8, 1.0], [2.5, -1.5, 0.8, 1.0],
                        [-1.5, 2.5, 0.8, 1.0]])
        clip = np.concatenate([clip, np.broadcast_to(big, (B, 3, 4))], 1)
        faces = np.concatenate([faces, [[200, 201, 202]]], 0)
    elif name == "near_plane":
        clip, faces = _random(rng, B, 200, 400)
        clip[:, :25, 3] = -0.5            # corners behind the camera
        cull = False
    elif name == "crowded_tile":
        clip, faces = _crowded_tile(rng, B, H, W)
    else:
        raise ValueError(f"unknown scene {name!r}; one of {SCENES}")
    return dict(clip=torch.as_tensor(clip.astype(np.float32), device=device),
                faces=torch.as_tensor(np.asarray(faces), dtype=torch.long,
                                      device=device),
                H=H, W=W, cull=cull)


def _crowded_tile(rng, B, H, W, ti=2, tj=3, n_slivers=1000):
    """Tile (ti, tj): a one-pixel triangle around each of its 256 pixel
    centers at z/w = -0.5, and n_slivers thin triangles across the tile
    behind them at random depths in (0, 0.9)."""
    tris = []
    for i in range(ti * 16, ti * 16 + 16):
        for j in range(tj * 16, tj * 16 + 16):
            cx, cy = _pixel_ndc(j, W), _pixel_ndc(i, H)
            hx, hy = 0.7 * 2.0 / W, 0.7 * 2.0 / H
            tris.append([[cx - hx, cy - hy, -0.5], [cx + hx, cy - hy, -0.5],
                         [cx, cy + hy, -0.5]])
    x0, x1 = _pixel_ndc(tj * 16, W), _pixel_ndc(tj * 16 + 15, W)
    y0, y1 = _pixel_ndc(ti * 16, H), _pixel_ndc(ti * 16 + 15, H)
    for _ in range(n_slivers):
        a = np.array([rng.uniform(x0, x1), rng.uniform(y0, y1)])
        b = np.array([rng.uniform(x0, x1), rng.uniform(y0, y1)])
        d = b - a
        perp = np.array([-d[1], d[0]]) / max(np.linalg.norm(d), 1e-6)
        c = (a + b) / 2 + perp * rng.uniform(0.2, 1.5) * 2.0 / W
        z = rng.uniform(0.0, 0.9)
        tris.append([[a[0], a[1], z], [b[0], b[1], z], [c[0], c[1], z]])
    tris = np.asarray(tris)                                   # (F, 3, 3)
    F = tris.shape[0]
    # counter-clockwise corners: the front faces of a culling render
    area = ((tris[:, 1, 0] - tris[:, 0, 0]) * (tris[:, 2, 1] - tris[:, 0, 1])
            - (tris[:, 2, 0] - tris[:, 0, 0]) * (tris[:, 1, 1] - tris[:, 0, 1]))
    tris[area < 0] = tris[area < 0][:, [0, 2, 1]]
    w = rng.uniform(1.0, 2.0, (B, F * 3, 1))
    xyz = np.broadcast_to(tris.reshape(1, F * 3, 3), (B, F * 3, 3))
    clip = np.concatenate([xyz * w, w], -1)
    return clip, np.arange(F * 3).reshape(F, 3)


def interp_inputs(scene: Dict, n_flags: int, tri_id: torch.Tensor,
                  seed: int = 0, none=("zw", "vids")):
    """A (B, 36 + nf, F) face table for the scene (its own attribute and AA
    planes, random normals, uvs and flags) and one foreground-masked random
    cotangent per fused-interp output group, None for the groups in
    `none`. Returns (packed, {group: cotangent or None})."""
    from vhap_tpu_torch.ops.interp import GROUPS, group_slices
    from vhap_tpu_torch.ops.rasterize import PLANE_KEYS, face_attribute_planes
    clip, faces = scene["clip"], scene["faces"]
    dev = clip.device
    B, F = clip.shape[0], faces.shape[0]
    H, W = tri_id.shape[1:]
    rng = np.random.default_rng(seed)

    def rnd(*shape, kind="normal"):
        x = rng.normal(size=shape) if kind == "normal" else rng.integers(0, 4, shape)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    p = face_attribute_planes(clip, faces)
    packed = torch.cat([torch.stack([p[k] for k in PLANE_KEYS], 1),
                        rnd(B, 15, F), faces.T[None].float().expand(B, 3, F),
                        rnd(B, n_flags, F, kind="int"),
                        torch.stack([p[k] for k in PLANE_KEYS[:6]], 1)],
                       1).contiguous()
    fg = (tri_id > 0).float()
    grads = {}
    for k in GROUPS:
        sl = group_slices(n_flags)[k]
        n_c = 1 if isinstance(sl, int) else sl.stop - sl.start
        g = rnd(B, n_c, H, W) * fg[:, None]
        grads[k] = None if k in none else (g[:, 0] if isinstance(sl, int) else g)
    return packed, grads
