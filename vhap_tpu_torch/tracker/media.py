"""Lightweight media logging: image grids + textured OBJ dumps.

Counterpart of vhap_tpu/tracker/media.py. Covers visualize_tracking / log_media (vhap/model/tracker.py:805-1076)
without torchvision: numpy grid assembly saved via PIL, seismic error
colormap, landmark overlays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
from PIL import Image

from vhap_tpu_torch.util.mesh_io import get_mtl_content, get_obj_content


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def seismic(x: np.ndarray) -> np.ndarray:
    """Blue-white-red colormap on [0, 1] (matplotlib 'seismic' roughly)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(2.0 * x, 0, 1)
    b = np.clip(2.0 * (1.0 - x), 0, 1)
    g = np.clip(1.0 - 2.0 * np.abs(x - 0.5), 0, 1)
    return np.stack([r, g, b], axis=-1)


def draw_points(img: np.ndarray, pts: np.ndarray, color, radius: int = 1) -> np.ndarray:
    """Draw square markers at pixel coords pts (L, 2) onto img (H, W, 3)."""
    H, W = img.shape[:2]
    out = img.copy()
    for x, y in pts:
        if not (np.isfinite(x) and np.isfinite(y)):
            continue
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            out[max(0, yi - radius):yi + radius + 1,
                max(0, xi - radius):xi + radius + 1] = color
    return out


def tracking_grid(output: Dict[str, np.ndarray], view_indices,
                  disable_jawline: bool = False,
                  stack_views_in_rows: bool = True) -> np.ndarray:
    """Assemble the per-step diagnostic grid (tracker.py:909-1038).

    output values are (B, H, W, C) numpy arrays in [0,1].
    """
    views = list(view_indices)
    panels = []  # list of (B, H, W, 3) arrays, one per diagnostic type
    gt = output["gt_rgb"]
    panels.append(gt)
    if "pred_rgb" in output:
        panels.append(np.clip(output["pred_rgb"], 0, 1))
    if "error_rgb" in output:
        e = output["error_rgb"].mean(-1) / 2 + 0.5
        panels.append(seismic(e))
    if "cid" in output:
        cid = output["cid"][..., 0]
        cid = cid / max(cid.max(), 1)
        c = np.repeat(cid[..., None], 3, -1)
        if "pred_alpha" in output:
            c[output["pred_alpha"][..., 0] == 0] = 1.0
        panels.append(c)
    if "albedo" in output:
        a = np.clip(output["albedo"], 0, 1).copy()
        if "pred_alpha" in output:
            a[output["pred_alpha"][..., 0] == 0] = 1.0
        panels.append(a)
    if "normal" in output:
        panels.append(np.clip(output["normal"] / 2 + 0.5, 0, 1))
    if "diffuse" in output:
        d = output["diffuse"]
        if d.shape[-1] == 1:
            d = np.repeat(d, 3, -1)
        panels.append(np.clip(d, 0, 1))
    if "aa" in output:
        panels.append(np.clip(output["aa"], 0, 1))

    # landmarks overlay
    if "gt_lmk2d" in output or "pred_lmk2d" in output:
        H, W = gt.shape[1:3]
        wh = np.array([[W, H]], np.float32)
        sl = slice(17, 68) if disable_jawline else slice(0, 68)
        vis = gt.copy()
        for b in range(gt.shape[0]):
            if "gt_lmk2d" in output:
                pts = (output["gt_lmk2d"][b, sl] * 0.5 + 0.5) * wh
                vis[b] = draw_points(vis[b], pts, (0.0, 1.0, 0.0))
            if "pred_lmk2d" in output:
                pts = (output["pred_lmk2d"][b, sl] * 0.5 + 0.5) * wh
                vis[b] = draw_points(vis[b], pts, (1.0, 0.0, 0.0))
        panels.append(vis)

    rows = []
    for v in views:
        rows.append(np.concatenate([p[v] for p in panels], axis=1))
    grid = np.concatenate(rows, axis=0) if stack_views_in_rows else \
        np.concatenate(rows, axis=1)
    return grid


def save_image(img01: np.ndarray, path: Path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(_to_u8(img01)).save(path)


def save_obj_with_texture(vertices, faces, uv_coords, uv_idx, albedo_chw,
                          obj_path: Path, mtl_path: Path, texture_path: Path):
    """OBJ + MTL + texture dump (vhap/model/tracker.py:805-815)."""
    tex = np.transpose(np.asarray(albedo_chw), (1, 2, 0))
    save_image(tex, texture_path)
    Path(mtl_path).write_text(get_mtl_content(Path(texture_path).name))
    Path(obj_path).write_text(
        get_obj_content(vertices, faces, uv_coords, uv_idx, Path(mtl_path).name))
