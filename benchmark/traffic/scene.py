"""The benchmark's frames, landmarks and cameras, drawn from the seed.

One general writer for both capture layouts a configuration names:

  monocular   VHAP's video layout (images/, alpha_maps/, landmark2d/STAR.npz)
              at the dataset's guessed camera (focal 1.5 x the long side,
              the head 1 m in front, vhap/data/video_dataset.py);
  rig         NeRSemble's layout (camera_params/<subject>/camera_params.json,
              <subject>/<sequence>/images_<n>/cam_<id>_<t>.jpg,
              landmark2d/STAR/<id>.npz, color_correction/<subject>/<id>.npy)
              for a rig of cameras on two arcs around the head, frames
              written already downsampled (images_<n>, as VHAP's
              preprocessing leaves them) and through the inverse of each
              camera's colour correction.

A frame is the stand-in head (traffic/head.py) under a smooth periodic
trajectory drawn from the seed: head rotation, translation, jaw and
expressions. Its image is a ray cast of the head's ellipsoid, lit and
coloured by a seeded pattern, written as JPEG; its landmarks are the
reference FLAME's landmarks at the same parameters, projected through the
camera the tracker will use. The trajectory repeats after `period`
timesteps, so only `period` distinct timesteps are rendered and encoded;
later timesteps are hard links to them. The tracker reads every frame
file as if it were new.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
from PIL import Image

from traffic import head as head_assets

SUBJECT, SEQUENCE = "001", "SEN-01"


# ---------------------------------------------------------------------------
# trajectory, image and landmarks
# ---------------------------------------------------------------------------

def trajectory(seed: int, period: int, n_shape: int, n_expr: int) -> Dict[str, np.ndarray]:
    """(period, ...) FLAME parameters of one period of the seeded motion."""
    rng = np.random.default_rng([seed, 2])
    th = 2 * np.pi * np.arange(period) / period
    ph = rng.uniform(0, 2 * np.pi, size=6)
    f32 = np.float32
    expr = 0.3 * np.sin(th[:, None] + rng.uniform(0, 2 * np.pi, size=n_expr)[None])
    expr *= (1.0 / (1 + np.arange(n_expr)))[None] ** 0.5
    return {
        "shape": np.broadcast_to(rng.normal(scale=0.3, size=n_shape),
                                 (period, n_shape)).astype(f32),
        "expr": expr.astype(f32),
        "rotation": np.stack([0.10 * np.sin(th + ph[0]), 0.20 * np.sin(th + ph[1]),
                              0.03 * np.sin(2 * th + ph[2])], -1).astype(f32),
        "neck_pose": np.zeros((period, 3), f32),
        "jaw_pose": np.stack([0.10 + 0.08 * np.sin(th + ph[3]), 0 * th, 0 * th],
                             -1).astype(f32),
        "eyes_pose": np.zeros((period, 6), f32),
        "translation": np.stack([0.02 * np.sin(th + ph[4]), 0.02 * np.cos(th + ph[5]),
                                 0 * th], -1).astype(f32),
    }


def _rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 3, 3)."""
    angle = torch.linalg.norm(r, dim=-1, keepdim=True).clamp(min=1e-12)
    k = r / angle
    K = torch.zeros(r.shape[0], 3, 3, dtype=r.dtype, device=r.device)
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(1, 2)
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    return torch.eye(3, dtype=r.dtype, device=r.device) + s * K + (1 - c) * K @ K


def ray_cast(R: torch.Tensor, T: torch.Tensor, K4: torch.Tensor, H: int, W: int,
             rot: torch.Tensor, trans: torch.Tensor, seed: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images of the head's ellipsoid: cameras w2c R (N, 3, 3), T (N, 3),
    K4 (N, 4) = fx, fy, cx, cy in the renderer's GL convention; head pose
    rot (N, 3) axis-angle and trans (N, 3). Returns rgb (N, H, W, 3) and
    alpha (N, H, W) in [0, 1], row 0 at the top."""
    dev, dt = R.device, torch.float32
    fx, fy, cx, cy = (K4[:, i, None, None] for i in range(4))
    c = torch.arange(W, device=dev, dtype=dt)[None, None] + 0.5
    r = torch.arange(H, device=dev, dtype=dt)[None, :, None] + 0.5
    ndc_x = 2 * c / W - 1
    ndc_y = 1 - 2 * r / H
    dx = (ndc_x + (W - 2 * cx) / W) * W / (2 * fx)
    dy = (ndc_y + (H - 2 * cy) / H) * H / (2 * fy)
    d_cam = torch.stack(torch.broadcast_tensors(dx, dy, -torch.ones_like(dx)), -1)
    Rt = R.transpose(1, 2)
    origin = -(Rt @ T[..., None])[..., 0]                       # (N, 3)
    d_world = torch.einsum("nij,nhwj->nhwi", Rt, d_cam)
    G = _rodrigues(rot)                                         # model -> world
    o_m = torch.einsum("nji,nj->ni", G, origin - trans)
    d_m = torch.einsum("nji,nhwj->nhwi", G, d_world)
    radii = torch.tensor(head_assets.RADII, device=dev, dtype=dt)
    o_s, d_s = o_m[:, None, None] / radii, d_m / radii
    a = (d_s * d_s).sum(-1)
    b = 2 * (o_s * d_s).sum(-1)
    cc = (o_s * o_s).sum(-1) - 1
    disc = b * b - 4 * a * cc
    hit = disc > 0
    s = (-b - torch.sqrt(disc.clamp(min=0))) / (2 * a)
    Y = o_m[:, None, None] + s[..., None] * d_m                 # model space
    n_w = torch.einsum("nij,nhwj->nhwi", G, Y / radii ** 2)
    n_w = n_w / torch.linalg.norm(n_w, dim=-1, keepdim=True).clamp(min=1e-12)
    light = torch.tensor([0.3, 0.4, 1.0], device=dev, dtype=dt)
    shade = 0.35 + 0.65 * (n_w @ (light / torch.linalg.norm(light))).clamp(min=0)
    lat = torch.arccos((Y[..., 1] / radii[1]).clamp(-1, 1))
    lon = torch.atan2(Y[..., 2] / radii[2], Y[..., 0] / radii[0])
    g = torch.Generator().manual_seed(seed)
    albedo = torch.tensor([0.78, 0.60, 0.52], device=dev, dtype=dt).expand(Y.shape).clone()
    for _ in range(5):
        k = torch.randint(1, 7, (2,), generator=g).to(dev, dt)
        ph = float(torch.rand((), generator=g)) * 6.2832
        amp = (torch.randn(3, generator=g) * 0.08).to(dev, dt)
        albedo = albedo + amp * torch.sin(k[0] * lon + k[1] * lat + ph)[..., None]
    rgb = (albedo.clamp(0, 1) * shade[..., None]).clamp(0, 1)
    rgb = torch.where(hit[..., None], rgb, torch.ones_like(rgb))
    return rgb, hit.to(dt)


def landmarks(head, gt: Dict[str, np.ndarray], RT: torch.Tensor, K4: torch.Tensor,
              H: int, W: int) -> np.ndarray:
    """(period, N cameras, L, 3) landmarks in [0, 1] image coordinates with
    confidence 1: the reference FLAME's landmarks at the trajectory,
    projected as the tracker's landmark energy projects them."""
    from reference.ops import camera as cam
    dev = RT.device
    P = gt["expr"].shape[0]
    t = {k: torch.as_tensor(v, device=dev) for k, v in gt.items()}
    with torch.no_grad():
        _, lmks = head(shape=t["shape"], expr=t["expr"], rotation=t["rotation"],
                       neck=t["neck_pose"], jaw=t["jaw_pose"], eyes=t["eyes_pose"],
                       translation=t["translation"])
        out = []
        for ci in range(RT.shape[0]):
            ndc = cam.world_to_ndc(lmks, RT[ci:ci + 1].expand(P, 3, 4),
                                   K4[ci:ci + 1].expand(P, 4), (H, W), flip_y=True)
            xy = ndc[..., :2].cpu().numpy() * 0.5 + 0.5
            out.append(np.concatenate([xy, np.ones_like(xy[..., :1])], -1))
    return np.stack(out, 1).astype(np.float32)


def _save_jpeg(arr: np.ndarray, path: Path) -> None:
    Image.fromarray(arr).save(path, quality=95)


def _u8(x: torch.Tensor) -> np.ndarray:
    return (x.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()


def _link_all(src: Dict[int, Path], n_timesteps: int, period: int, name) -> None:
    """Hard links of the rendered period for every later timestep."""
    for t in range(period, n_timesteps):
        dst = name(t)
        if not dst.exists():
            os.link(src[t % period], dst)


# ---------------------------------------------------------------------------
# the two layouts
# ---------------------------------------------------------------------------

def _head(asset_dir: Path, model: Dict, device):
    from reference.model.flame import FlameHead
    return FlameHead.build(n_shape=model["n_shape"], n_expr=model["n_expr"],
                           asset_dir=asset_dir, add_teeth=model["add_teeth"],
                           remove_lip_inside=model["remove_lip_inside"],
                           device=device)


def write_monocular(root: Path, scene: Dict, model: Dict, n_timesteps: int,
                    seed: int, asset_dir: Path, device) -> Dict:
    seq = Path(root) / SEQUENCE
    for d in ("images", "alpha_maps", "landmark2d"):
        (seq / d).mkdir(parents=True, exist_ok=True)
    H, W = scene["image_size"]
    P = min(scene["period"], n_timesteps)
    gt = trajectory(seed, P, model["n_shape"], model["n_expr"])
    f = scene["focal"] * max(H, W)
    K4 = torch.tensor([[f, f, W / 2, H / 2]], device=device)
    R = torch.eye(3, device=device)[None]
    T = torch.tensor([[0.0, 0.0, -1.0]], device=device)
    RT = torch.cat([R, T[..., None]], -1)
    lmk = landmarks(_head(asset_dir, model, device), gt, RT, K4, H, W)[:, 0]
    img, rgb_paths, alpha_paths = {}, {}, {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = []
        for t in range(P):
            rgb, alpha = ray_cast(R, T, K4, H, W,
                                  torch.as_tensor(gt["rotation"][t:t + 1], device=device),
                                  torch.as_tensor(gt["translation"][t:t + 1], device=device),
                                  seed)
            rgb_paths[t] = seq / "images" / f"{t:05d}.jpg"
            alpha_paths[t] = seq / "alpha_maps" / f"{t:05d}.jpg"
            futs.append(pool.submit(_save_jpeg, _u8(rgb[0]), rgb_paths[t]))
            futs.append(pool.submit(_save_jpeg, _u8(alpha[0]), alpha_paths[t]))
        for fu in futs:
            fu.result()
    _link_all(rgb_paths, n_timesteps, P, lambda t: seq / "images" / f"{t:05d}.jpg")
    _link_all(alpha_paths, n_timesteps, P, lambda t: seq / "alpha_maps" / f"{t:05d}.jpg")
    np.savez(seq / "landmark2d" / "STAR.npz",
             face_landmark_2d=lmk[np.arange(n_timesteps) % P])
    return {"root_folder": str(root), "sequence": SEQUENCE}


def _arc_cameras(n: int, distance: float, span_deg: float, rows_deg):
    """OpenCV w2c (n, 4, 4) of cameras on len(rows_deg) arcs at those
    elevations, n / len(rows_deg) per arc over span_deg, looking at the
    origin, y down."""
    per = n // len(rows_deg)
    w2c = []
    for el in np.radians(rows_deg):
        for az in np.radians(np.linspace(-span_deg / 2, span_deg / 2, per)):
            pos = distance * np.array([np.sin(az) * np.cos(el), np.sin(el),
                                       np.cos(az) * np.cos(el)])
            z = -pos / np.linalg.norm(pos)                  # forward
            x = np.cross(np.array([0.0, -1.0, 0.0]), z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            Rc = np.stack([x, y, z])                        # world -> camera
            M = np.eye(4)
            M[:3, :3], M[:3, 3] = Rc, -Rc @ pos
            w2c.append(M)
    return np.stack(w2c)


def color_corrections(n: int, seed: int) -> np.ndarray:
    """(n, 3, 4) affine colour transforms near the identity."""
    rng = np.random.default_rng([seed, 3])
    A = np.zeros((n, 3, 4))
    A[:, :, :3] = np.eye(3) + rng.normal(scale=0.03, size=(n, 3, 3))
    A[:, :, 3] = rng.normal(scale=0.01, size=(n, 3))
    return A


def write_rig(root: Path, scene: Dict, model: Dict, n_timesteps: int, seed: int,
              asset_dir: Path, device) -> Dict:
    from reference.data import rig_cameras
    root = Path(root)
    seq = root / SUBJECT / SEQUENCE
    nd = scene["n_downsample"]
    folder = seq / f"images_{nd}"
    for d in (folder, seq / "landmark2d" / "STAR", root / "camera_params" / SUBJECT,
              root / "color_correction" / SUBJECT):
        d.mkdir(parents=True, exist_ok=True)
    n = scene["cameras"]
    Hc, Wc = scene["image_size_calibration"]
    H, W = Hc // nd, Wc // nd
    ids = [f"22{i:07d}" for i in range(n)]
    w2c = _arc_cameras(n, scene["distance"], scene["span_deg"], scene["rows_deg"])
    f = scene["focal_px"]
    K = [[f, 0.0, Wc / 2], [0.0, f, Hc / 2], [0.0, 0.0, 1.0]]
    (root / "camera_params" / SUBJECT / "camera_params.json").write_text(json.dumps(
        {"intrinsics": K, "world_2_cam": {c: m.tolist() for c, m in zip(ids, w2c)}}))
    A = color_corrections(n, seed)
    for c, a in zip(ids, A):
        np.save(root / "color_correction" / SUBJECT / f"{c}.npy", a)
    # the cameras as the dataset converts them: the frames are cast
    # through exactly those
    _, intr, extr = rig_cameras(root, SUBJECT, (Hc, Wc), nd)
    R = torch.as_tensor(extr[:, :, :3], device=device)
    T = torch.as_tensor(extr[:, :, 3], device=device)
    K4 = torch.as_tensor(np.stack([intr[:, 0, 0], intr[:, 1, 1], intr[:, 0, 2],
                                   intr[:, 1, 2]], -1), device=device)
    RT = torch.as_tensor(extr, device=device)
    P = min(scene["period"], n_timesteps)
    gt = trajectory(seed, P, model["n_shape"], model["n_expr"])
    lmk = landmarks(_head(asset_dir, model, device), gt, RT, K4, H, W)
    Minv = torch.as_tensor(np.linalg.inv(A[:, :, :3]), device=device, dtype=torch.float32)
    b = torch.as_tensor(A[:, :, 3], device=device, dtype=torch.float32)
    paths: Dict[Tuple[int, int], Path] = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = []
        for t in range(P):
            rgb, _ = ray_cast(R, T, K4, H, W,
                              torch.as_tensor(gt["rotation"][t:t + 1], device=device).expand(n, 3),
                              torch.as_tensor(gt["translation"][t:t + 1], device=device).expand(n, 3),
                              seed)
            raw = torch.einsum("nhwc,ncd->nhwd", rgb - b[:, None, None], Minv)
            for ci, c in enumerate(ids):
                paths[ci, t] = folder / f"cam_{c}_{t:05d}.jpg"
                futs.append(pool.submit(_save_jpeg, _u8(raw[ci]), paths[ci, t]))
        for fu in futs:
            fu.result()
    for ci, c in enumerate(ids):
        _link_all({t: paths[ci, t] for t in range(P)}, n_timesteps, P,
                  lambda t, c=c: folder / f"cam_{c}_{t:05d}.jpg")
        np.savez(seq / "landmark2d" / "STAR" / f"{c}.npz",
                 face_landmark_2d=lmk[np.arange(n_timesteps) % P, ci])
    return {"root_folder": str(root), "sequence": SEQUENCE, "subject": SUBJECT}


LAYOUTS = {"monocular": write_monocular, "rig": write_rig}


def write_scene(root: Path, scene: Dict, model: Dict, n_timesteps: int, seed: int,
                asset_dir: Path, device) -> Dict:
    """Write the configuration's layout for n_timesteps timesteps; returns
    the data fields the tracker's configuration takes."""
    return LAYOUTS[scene["layout"]](root, scene, model, n_timesteps, seed,
                                    asset_dir, device)
