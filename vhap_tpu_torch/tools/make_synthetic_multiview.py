"""Generate a synthetic multiview rig sequence in the NeRSemble layout
(vhap_tpu/tools/make_synthetic_multiview.py).

Cameras on an arc around the head; writes
  <root>/camera_params/<subject>/camera_params.json   (opencv w2c, like NeRSemble)
  <root>/<subject>/<sequence>/images/cam_<id>_<ts>.jpg
  <root>/<subject>/<sequence>/alpha_maps/cam_<id>_<ts>.jpg
  <root>/<subject>/<sequence>/landmark2d/STAR/<id>.npz
  <root>/<subject>/<sequence>/gt_params.npz
  <root>/color_correction/<subject>/<id>.npy   (with color_correction=True)

Data is rendered in the *post-conversion* opengl convention and re-encoded
to opencv w2c so the NeRSembleDataset's conversion pipeline
(vhap/data/nersemble_dataset.py:75-124) round-trips to the ground truth.
Use with ``align_cameras_to_axes=False``. Every frame renders all cameras
as one batch, on the CUDA card unless given another device.

With color_correction=True each camera gets a seeded affine colour
transform near the identity (the (3, 4) matrix NeRSembleDataset applies as
rgb @ A[:, :3] + A[:, 3]), and its images are written through the
transform's inverse, so that the corrected frames are the renders.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from vhap_tpu_torch.model.flame import FlameHead
from vhap_tpu_torch.ops.render import RenderSettings, render_rgba_vis
from vhap_tpu_torch.tools.make_synthetic_sequence import (head_inputs,
                                                          landmarks_2d,
                                                          save_frame)


def _arc_cameras_gl(n_cams: int, radius: float = 1.0, span_deg: float = 60.0):
    """c2w orientations/locations (opengl: x right, y up, z back) on an arc."""
    Rs, ts = [], []
    angles = np.linspace(-span_deg / 2, span_deg / 2, n_cams) * np.pi / 180
    for a in angles:
        # camera position on the arc in the xz plane, looking at origin
        pos = np.array([radius * np.sin(a), 0.0, radius * np.cos(a)], np.float32)
        z = pos / np.linalg.norm(pos)               # opengl camera z = backward
        up = np.array([0.0, 1.0, 0.0], np.float32)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs.append(np.stack([x, y, z], axis=1))      # columns = camera axes
        ts.append(pos)
    return np.stack(Rs), np.stack(ts)


def color_corrections(n_cams: int, seed: int = 0) -> np.ndarray:
    """(n_cams, 3, 4) affine colour transforms near the identity."""
    rng = np.random.default_rng(seed + 1)
    A = np.zeros((n_cams, 3, 4))
    A[:, :, :3] = np.eye(3) + rng.normal(scale=0.03, size=(n_cams, 3, 3))
    A[:, :, 3] = rng.normal(scale=0.01, size=(n_cams, 3))
    return A


def generate_multiview(root: Path, subject: str = "001", sequence: str = "SEN-01",
                       n_cams: int = 4, n_frames: int = 4, size=128,
                       seed: int = 0, head=None, device=None,
                       color_correction: bool = False):
    """Write the rig sequence; returns (ground-truth parameters, camera
    ids). `size`: the frames' side, or their (height, width). The head
    defaults to the asset loader's, built on `device` (default: the CUDA
    card); frames render on the head's device."""
    root = Path(root)
    H, W = (size, size) if isinstance(size, int) else size
    seq_dir = root / subject / sequence
    (seq_dir / "images").mkdir(parents=True, exist_ok=True)
    (seq_dir / "alpha_maps").mkdir(exist_ok=True)
    (seq_dir / "landmark2d/STAR").mkdir(parents=True, exist_ok=True)
    (root / "camera_params" / subject).mkdir(parents=True, exist_ok=True)

    if head is None:
        head = FlameHead.build(n_shape=30, n_expr=10, add_teeth=False,
                               device=device)
    dev = head.v_template.device
    rng = np.random.default_rng(seed)

    # head near origin (see assets centering)
    t = np.arange(n_frames, dtype=np.float32)
    gt = {
        "shape": rng.normal(scale=0.3, size=(head.n_shape,)).astype(np.float32),
        "expr": (0.3 * np.sin(t[:, None] + np.arange(head.n_expr)[None])).astype(np.float32),
        "rotation": np.stack([0.05 * np.sin(t), 0.1 * np.sin(t * 0.7), 0 * t], -1).astype(np.float32),
        "neck_pose": np.zeros((n_frames, 3), np.float32),
        "jaw_pose": np.stack([0.08 + 0.05 * np.sin(t), 0 * t, 0 * t], -1).astype(np.float32),
        "eyes_pose": np.zeros((n_frames, 6), np.float32),
        "translation": np.zeros((n_frames, 3), np.float32),
    }

    # gl-convention cameras (post-dataset-conversion ground truth)
    R_gl, t_gl = _arc_cameras_gl(n_cams)
    # intrinsics in the *gl* convention at render size
    f = 1.5 * W
    K_gl = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)

    # encode to NeRSemble json: opencv orientation = gl with y/z columns
    # flipped; cy_cv = H - cy_gl; w2c = [R^T | -R^T t]
    cam_ids = [f"22{i:07d}" for i in range(n_cams)]
    world_2_cam = {}
    for i, cid in enumerate(cam_ids):
        R_cv = R_gl[i].copy()
        R_cv[:, [1, 2]] *= -1
        Rt = R_cv.T
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = Rt
        w2c[:3, 3] = Rt @ -t_gl[i]
        world_2_cam[cid] = w2c.tolist()
    K_cv = K_gl.copy()
    K_cv[1, 2] = H - K_gl[1, 2]
    with open(root / "camera_params" / subject / "camera_params.json", "w") as fh:
        json.dump({"intrinsics": K_cv.tolist(), "world_2_cam": world_2_cam,
                   "height": H, "width": W}, fh)

    # device-side camera matrices (w2c from gl convention)
    RT_gl = np.zeros((n_cams, 3, 4), np.float32)
    for i in range(n_cams):
        RT_gl[i, :3, :3] = R_gl[i].T
        RT_gl[i, :3, 3] = R_gl[i].T @ -t_gl[i]

    settings = RenderSettings(lighting_type="SH")
    tex, verts_uv, lights = head_inputs(head)
    K4 = torch.as_tensor(np.stack([np.array([f, f, W / 2, H / 2],
                                            np.float32)] * n_cams), device=dev)
    RT = torch.as_tensor(RT_gl, device=dev)

    def frame(name, i):
        return torch.as_tensor(gt[name][i], device=dev)[None]

    inv_cc = None
    if color_correction:
        cc_dir = root / "color_correction" / subject
        cc_dir.mkdir(parents=True, exist_ok=True)
        A = color_corrections(n_cams, seed)
        inv_cc = []
        for ci, cid in enumerate(cam_ids):
            np.save(cc_dir / f"{cid}.npy", A[ci])
            inv_cc.append((np.linalg.inv(A[ci, :, :3]), A[ci, :, 3]))

    lmks_per_cam = [[] for _ in range(n_cams)]
    for fi in range(n_frames):
        with torch.no_grad():
            verts, lmks = head(
                shape=torch.as_tensor(gt["shape"], device=dev)[None],
                expr=frame("expr", fi), rotation=frame("rotation", fi),
                neck=frame("neck_pose", fi), jaw=frame("jaw_pose", fi),
                eyes=frame("eyes_pose", fi), translation=frame("translation", fi))
            verts_b = verts.expand((n_cams,) + verts.shape[1:])
            out = render_rgba_vis(verts_b, head.faces, RT, K4, (H, W),
                                  settings, verts_uv=verts_uv,
                                  faces_uv=head.textures_idx, tex=tex,
                                  lights=lights)
            rgba = out["rgba"].cpu().numpy()
            ts_id = f"{fi:05d}"
            if inv_cc is not None:   # raw = (corrected - b) @ M^-1
                for ci, (M_inv, b) in enumerate(inv_cc):
                    rgba[ci, ..., :3] = (rgba[ci, ..., :3] - b) @ M_inv
            for ci, cid in enumerate(cam_ids):
                save_frame(rgba[ci], seq_dir / "images" / f"cam_{cid}_{ts_id}.jpg",
                           seq_dir / "alpha_maps" / f"cam_{cid}_{ts_id}.jpg")
                lmks_per_cam[ci].append(landmarks_2d(
                    lmks, RT[ci:ci + 1], K4[ci:ci + 1], (H, W)))

    for ci, cid in enumerate(cam_ids):
        np.savez(seq_dir / "landmark2d/STAR" / f"{cid}.npz",
                 face_landmark_2d=np.stack(lmks_per_cam[ci]).astype(np.float32))

    np.savez(seq_dir / "gt_params.npz", **gt)
    return gt, cam_ids


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--subject", default="001")
    ap.add_argument("--sequence", default="SEN-01")
    ap.add_argument("--cams", type=int, default=4)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    generate_multiview(args.out, args.subject, args.sequence, args.cams,
                       args.frames, args.size, device=args.device)
    print(f"wrote synthetic multiview sequence to {args.out}")


if __name__ == "__main__":
    main()
