"""Bake per-region UV texel masks (vhap_tpu/generate_flame_uvmask.py;
reference: vhap/generate_flame_uvmask.py).

Rasterizes each vt-region as vertex alpha in UV space at 2048^2,
thresholds at 0.5, and writes per-region PNGs + uv_masks.npz (the asset
consumed by FlameUvMasks / the reg_tex_res_clusters regularizer).

Usage: python -m vhap_tpu_torch.generate_flame_uvmask --out asset/flame
       [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from vhap_tpu_torch.model.flame import FlameHead
from vhap_tpu_torch.ops.render_uvmap import render_uvmap_vtex


def generate(out_dir: Path, resolution: int = 2048, asset_dir=None,
             head=None, regions=None, device=None):
    """Bake and write the masks of `regions` (default: every vt-region of
    the head), returning {region: (resolution, resolution) bool}. The head
    defaults to the full FLAME head (teeth included) on `device` (default:
    the CUDA card); the masks are rendered on the head's device."""
    out_dir = Path(out_dir)
    png_dir = out_dir / "uv_masks"
    png_dir.mkdir(parents=True, exist_ok=True)

    if head is None:
        head = FlameHead.build(n_shape=300, n_expr=100, asset_dir=asset_dir,
                               add_teeth=True, device=device)
    verts_uv = head.verts_uvs
    faces_uv = head.textures_idx

    masks = {}
    names = regions if regions is not None else sorted(head.masks.vt)
    for region in names:
        vt_mask = head.masks.vt.get(region)
        if vt_mask is None:
            continue
        v_color = np.zeros((verts_uv.shape[0], 1), np.float32)
        v_color[vt_mask] = 1.0
        alpha = render_uvmap_vtex(verts_uv, faces_uv,
                                  torch.as_tensor(v_color, device=verts_uv.device),
                                  faces_uv, (resolution, resolution))
        # flip to image orientation
        alpha = torch.flip(alpha[0, :, :, 0], dims=[0]).cpu().numpy()
        mask = alpha > 0.5  # avoid overlap between hair and face
        masks[region] = mask
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            png_dir / f"{region}.png")
        print(f"saved uv mask for {region}")

    np.savez_compressed(out_dir / "uv_masks.npz", **masks)
    print(f"saved {len(masks)} uv masks to {out_dir / 'uv_masks.npz'}")
    return masks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=Path("asset/flame"))
    ap.add_argument("--resolution", type=int, default=2048)
    ap.add_argument("--asset_dir", type=Path, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    generate(args.out, args.resolution, args.asset_dir, device=args.device)


if __name__ == "__main__":
    main()
