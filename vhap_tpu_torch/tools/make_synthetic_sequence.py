"""Generate a synthetic monocular head sequence in the VideoDataset layout
(vhap_tpu/tools/make_synthetic_sequence.py).

Renders a FLAME head with known parameters into images/, alpha_maps/ and
landmark2d/STAR.npz, plus gt_params.npz, so the tracking pipeline can be
exercised end to end without real footage or the license-gated FLAME
files. Renders on the CUDA card unless given another device.

Usage: python -m vhap_tpu_torch.tools.make_synthetic_sequence \
           --out /tmp/seq/obama --frames 8 --size 256 [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from vhap_tpu_torch.model.flame import FlameHead, FlameTexPainted
from vhap_tpu_torch.ops import camera as cam
from vhap_tpu_torch.ops.render import RenderSettings, render_rgba_vis
from vhap_tpu_torch.ops.shading import uniform_sh_lights
from vhap_tpu_torch.tracker.energy import render_verts_uv


def save_frame(rgba: np.ndarray, image_path: Path, alpha_path: Path) -> None:
    """One rendered (H, W, 4) frame -> a JPEG on white and its alpha JPEG."""
    rgb = np.clip(rgba[..., :3], 0, 1)
    alpha = np.clip(rgba[..., 3], 0, 1)
    rgb = rgb * alpha[..., None] + (1 - alpha[..., None])  # white bg
    Image.fromarray((rgb * 255).astype(np.uint8)).save(image_path, quality=95)
    Image.fromarray((alpha * 255).astype(np.uint8)).save(alpha_path, quality=95)


def landmarks_2d(lmks, RT, K, size) -> np.ndarray:
    """World landmarks (1, L, 3) -> normalized [0, 1] pixel coordinates +
    confidence (L, 3), the contract of
    vhap/util/landmark_detector_star.py:370-390. `size`: the image's side,
    or its (height, width)."""
    hw = (size, size) if isinstance(size, int) else tuple(size)
    ndc = cam.world_to_ndc(lmks, RT, K, hw, flip_y=True)
    xy = ndc[0, :, :2].cpu().numpy() * 0.5 + 0.5
    return np.concatenate([xy, np.ones((xy.shape[0], 1), np.float32)], -1)


def head_inputs(head: FlameHead, tex_size: int = 256):
    """The renderer's texture, uvs (v flipped) and uniform SH lights."""
    dev = head.v_template.device
    tex = FlameTexPainted(head.assets.tex_painted, tex_size, device=dev)()
    lights = torch.as_tensor(uniform_sh_lights(), device=dev)[None]
    return tex, render_verts_uv(head, dev), lights


def generate(out_dir: Path, n_frames: int = 8, size: int = 256,
             n_shape: int = 50, n_expr: int = 20, seed: int = 0,
             head=None, return_params: bool = False, device=None):
    """Write the sequence; returns the ground-truth parameters (and the
    head with return_params). The head defaults to the synthetic-capable
    asset loader's, built on `device` (default: the CUDA card); frames
    render on the head's device."""
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    (out_dir / "alpha_maps").mkdir(exist_ok=True)
    # monocular layout stores one npz at landmark2d/STAR.npz
    # (vhap/data/video_dataset.py:359-363)
    (out_dir / "landmark2d").mkdir(parents=True, exist_ok=True)

    if head is None:
        head = FlameHead.build(n_shape=n_shape, n_expr=n_expr, add_teeth=False,
                               device=device)
    dev = head.v_template.device
    rng = np.random.default_rng(seed)

    # ground-truth trajectory: gentle sinusoidal head motion + expressions
    t = np.arange(n_frames, dtype=np.float32)
    gt = {
        "shape": rng.normal(scale=0.3, size=(head.n_shape,)).astype(np.float32),
        "expr": (0.4 * np.sin(t[:, None] * 0.7 + np.arange(head.n_expr)[None] * 1.3)
                 ).astype(np.float32),
        "rotation": np.stack([0.1 * np.sin(t * 0.5), 0.2 * np.sin(t * 0.3),
                              0.02 * t * 0], -1).astype(np.float32),
        "neck_pose": np.zeros((n_frames, 3), np.float32),
        "jaw_pose": np.stack([0.1 + 0.08 * np.sin(t), 0 * t, 0 * t], -1).astype(np.float32),
        "eyes_pose": np.zeros((n_frames, 6), np.float32),
    }
    # camera: the dataset's guessed convention (z=1 camera, head centered)
    head_center = head.v_template.cpu().numpy().mean(0)
    gt["translation"] = (
        -head_center[None]
        + np.stack([0.02 * np.sin(t * 0.4), 0.02 * np.cos(t * 0.6), 0 * t], -1)
    ).astype(np.float32)

    RT = torch.eye(3, 4, device=dev)[None]
    RT[0, 2, 3] = -1.0
    f = 1.5 * size
    K = torch.tensor([[f, f, size / 2, size / 2]], device=dev)

    settings = RenderSettings(lighting_type="SH")
    tex, verts_uv, lights = head_inputs(head)

    def frame(name, i):
        return torch.as_tensor(gt[name][i], device=dev)[None]

    lmks_all = []
    for i in range(n_frames):
        with torch.no_grad():
            verts, lmks = head(
                shape=torch.as_tensor(gt["shape"], device=dev)[None],
                expr=frame("expr", i), rotation=frame("rotation", i),
                neck=frame("neck_pose", i), jaw=frame("jaw_pose", i),
                eyes=frame("eyes_pose", i), translation=frame("translation", i))
            out = render_rgba_vis(verts, head.faces, RT, K, (size, size),
                                  settings, verts_uv=verts_uv,
                                  faces_uv=head.textures_idx, tex=tex,
                                  lights=lights)
            save_frame(out["rgba"][0].cpu().numpy(),
                       out_dir / "images" / f"{i:05d}.jpg",
                       out_dir / "alpha_maps" / f"{i:05d}.jpg")
            lmks_all.append(landmarks_2d(lmks, RT, K, size))

    np.savez(out_dir / "landmark2d/STAR.npz",
             face_landmark_2d=np.stack(lmks_all).astype(np.float32))

    np.savez(out_dir / "gt_params.npz", **gt)
    if return_params:
        return gt, head
    return gt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    generate(args.out, args.frames, args.size, seed=args.seed, device=args.device)
    print(f"wrote synthetic sequence to {args.out}")


if __name__ == "__main__":
    main()
