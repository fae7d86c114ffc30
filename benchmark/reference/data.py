"""The reference's batches, read from the files the benchmark wrote.

What the tracker's datasets derive from those files, worked out again from
the raw files: JPEG decode (PIL, the same libjpeg the port's native loader
links), the per-camera affine colour correction and the white-background
composite, each with the truncating uint8 round trip of the reference
pipeline (vhap/data/nersemble_dataset.py:165-171,
vhap/data/video_dataset.py:305-323) in float64; landmarks scaled to pixels
with their confidence; and, for a calibrated rig, NeRSemble's camera
conversion (vhap/data/nersemble_dataset.py:75-124). The cells write frames
at the size they are tracked at, so no resize runs on either side.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from reference.util import camera_np


def _u8(path: Path) -> np.ndarray:
    with Image.open(path) as im:
        return np.array(im)


def load_frame(rgb_path: Path, alpha_path: Optional[Path] = None,
               cc: Optional[np.ndarray] = None,
               white_bg: bool = False) -> np.ndarray:
    """One (h, w, 3) float32 frame in [0, 1]."""
    rgb = _u8(rgb_path)
    if cc is not None:
        x = rgb.astype(np.float64) / 255.0
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        out = np.empty_like(x)
        for k in range(3):
            v = r * cc[0, k] + g * cc[1, k] + b * cc[2, k] + cc[k, 3]
            out[..., k] = np.clip(v, 0.0, 1.0) * 255.0
        rgb = out.astype(np.uint8)
    if white_bg:
        a = _u8(alpha_path).astype(np.float64) / 255.0
        if a.ndim == 3:
            a = a[..., 0]
        v = a[..., None] * rgb + (1.0 - a[..., None]) * 255.0
        rgb = np.clip(v, 0.0, 255.0).astype(np.uint8)
    return (rgb.astype(np.float64) / 255.0).astype(np.float32)


def _landmarks(npz_path: Path, t: int, h: int, w: int) -> np.ndarray:
    with np.load(npz_path) as z:
        lmk = np.array(z["face_landmark_2d"][t], np.float32)
    lmk[:, 2:] = 0.0 if (lmk[:, :2] == -1).sum() > 0 else 1.0
    lmk[..., 0] *= w
    lmk[..., 1] *= h
    return lmk


def monocular_batch(seq_dir: Path, frames: Sequence[int], white_bg: bool,
                    device) -> Dict[str, torch.Tensor]:
    """A batch of monocular frames (images/, alpha_maps/,
    landmark2d/STAR.npz) as the tracker's `_host_batch` builds it."""
    seq_dir = Path(seq_dir)
    ids = sorted(p.stem for p in (seq_dir / "images").glob("*.jpg"))
    rgb = np.stack([load_frame(seq_dir / "images" / f"{ids[t]}.jpg",
                               seq_dir / "alpha_maps" / f"{ids[t]}.jpg",
                               white_bg=white_bg) for t in frames])
    h, w = rgb.shape[1:3]
    lmk = np.stack([_landmarks(seq_dir / "landmark2d" / "STAR.npz", t, h, w)
                    for t in frames])
    return _to(device, rgb=rgb, timestep_index=np.asarray(frames, np.int32),
               weight=np.ones(len(frames), np.float32), lmk2d=lmk)


def rig_cameras(root: Path, subject: str, image_size_calib, n_downsample: int,
                align_cameras_to_axes: bool = True,
                conversion: Optional[str] = "opencv->opengl"):
    """(camera ids, intrinsic (N, 3, 3), extrinsic w2c (N, 3, 4)) of a
    NeRSemble camera_params.json, converted and scaled as the dataset does."""
    param = json.loads((Path(root) / "camera_params" / subject
                        / "camera_params.json").read_text())
    K = np.asarray(param["intrinsics"], np.float32)
    H, W = (param["height"], param["width"]) if "height" in param else image_size_calib
    ids = list(param["world_2_cam"].keys())
    w2c = np.asarray([param["world_2_cam"][k] for k in ids], np.float32)
    R, T = w2c[..., :3, :3], w2c[..., :3, 3]
    orientation = R.transpose(0, 2, 1)
    location = orientation @ -T[..., None]
    if align_cameras_to_axes:
        orientation, location = camera_np.align_cameras_to_axes(
            orientation, location, target_convention="opengl")
    if conversion is not None:
        orientation, K = camera_np.convert_camera_convention(
            conversion, orientation, K, H, W)
    Rw = orientation.transpose(0, 2, 1)
    extrinsic = np.concatenate([Rw, Rw @ -location], axis=-1).astype(np.float32)
    intr = np.stack([np.asarray(K if K.ndim == 2 else K[i], np.float32)
                     for i in range(len(ids))])
    intr[:, :2] *= 1.0 / n_downsample
    return ids, intr, extrinsic


def rig_batch(root: Path, subject: str, sequence: str, t: int,
              image_size_calib, n_downsample: int, color_correction: bool,
              device, align_cameras_to_axes: bool = True) -> Dict[str, torch.Tensor]:
    """Every view of timestep t of a NeRSemble rig (images_<n>/,
    landmark2d/STAR/<camera>.npz, color_correction/), as the tracker's
    `_host_batch` builds it with all views batched."""
    root = Path(root)
    seq_dir = next(p for p in (root / subject).glob(f"{sequence}*") if p.is_dir())
    ids, intr, extr = rig_cameras(root, subject, image_size_calib, n_downsample,
                                  align_cameras_to_axes)
    folder = seq_dir / f"images_{n_downsample}"
    ts_ids = sorted({p.stem.split("_")[-1] for p in folder.glob("*.jpg")})
    frames: List[np.ndarray] = []
    for cid in ids:
        cc = (np.load(root / "color_correction" / subject / f"{cid}.npy")
              if color_correction else None)
        frames.append(load_frame(folder / f"cam_{cid}_{ts_ids[t]}.jpg", cc=cc))
    rgb = np.stack(frames)
    h, w = rgb.shape[1:3]
    lmk = np.stack([_landmarks(seq_dir / "landmark2d" / "STAR" / f"{cid}.npz", t, h, w)
                    for cid in ids])
    n = len(ids)
    return _to(device, rgb=rgb, timestep_index=np.full(n, t, np.int32),
               weight=np.ones(n, np.float32), lmk2d=lmk, intrinsic=intr,
               extrinsic=extr)


def _to(device, **arrays) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in arrays.items()}
