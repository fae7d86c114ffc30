"""Export a tracked sequence as a NeRF/3DGS dataset (GaussianAvatars format).

Counterpart of vhap_tpu/export_as_nerf_dataset.py (reference:
vhap/export_as_nerf_dataset.py), with the same outputs:
  1. NeRFDatasetWriter      — white-bg PNGs + fg_masks + transforms.json
  2. TrackedFLAMEDatasetWriter — per-timestep flame_param/*.npz (or meshes)
     with the FLAME translation re-centered at the origin and the offset
     baked into the camera poses; canonical param/mesh with the jaw opened
     0.3 rad
  3. MaskFromFLAME          — tilted neck-line masks re-composited into the
     images/masks
  4. split_json             — train/val/test (70/30 timesteps, camera 8 or
     the last camera held out for validation)

FLAME runs on the CUDA card unless `device` (`--device cpu`) says
otherwise; frames, masks and splits are host numpy. A tracking run's
config.yml may name a dataset class of the JAX package (`data._target`
"vhap_tpu.data...."): the export reads it as the port's class of the same
name and never imports the JAX package.

Usage: python -m vhap_tpu_torch.export_as_nerf_dataset --src_folder <trackdir> \
           --tgt_folder <outdir> [--flame-mode param] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
from copy import deepcopy
from glob import glob
from pathlib import Path
from typing import Dict, List, Literal, Optional

import numpy as np
import torch
import yaml
from PIL import Image

from vhap_tpu_torch.config.base import BaseTrackingConfig, import_module
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.util.log import get_logger
from vhap_tpu_torch.util.mesh_io import get_obj_content

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# IO helpers (vhap/export_as_nerf_dataset.py:514-538)
# ---------------------------------------------------------------------------

def write_json(db, tgt_folder: Path, division: Optional[str] = None):
    fname = "transforms.json" if division is None else f"transforms_{division}.json"
    json_path = Path(tgt_folder) / fname
    logger.info(f"Writing database: {json_path}")
    with open(json_path, "w") as f:
        json.dump(db, f, indent=4)


def write_data(path2data: Dict):
    for path, data in path2data.items():
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix in (".png", ".jpg"):
            Image.fromarray(data).save(path)
        elif path.suffix in (".obj", ".txt"):
            path.write_text(data)
        elif path.suffix == ".npz":
            np.savez(path, **data)
        else:
            raise NotImplementedError(f"Unknown file type: {path.suffix}")


class AsyncWriter:
    """Threaded image writing, matching the reference's 8-thread pool
    (vhap/export_as_nerf_dataset.py:125-128). PNG encode + disk IO overlap
    the main loop's decode/compute; `drain()` propagates worker errors."""

    def __init__(self, workers: Optional[int] = None):
        import os
        from concurrent.futures import ThreadPoolExecutor
        self._ex = ThreadPoolExecutor(workers or min(8, 2 * (os.cpu_count() or 1)))
        self._futures = []

    def submit(self, path2data: Dict):
        self._futures.append(self._ex.submit(write_data, path2data))

    def drain(self):
        for f in self._futures:
            f.result()
        self._futures.clear()
        self._ex.shutdown()


# ---------------------------------------------------------------------------
# 1. frames + transforms.json (vhap/export_as_nerf_dataset.py:42-148)
# ---------------------------------------------------------------------------

class NeRFDatasetWriter:
    def __init__(self, cfg_data, tgt_folder: Path, subset=None,
                 scale_factor=None, background_color=None):
        self.tgt_folder = Path(tgt_folder)
        cfg_data.target_extrinsic_type = "c2w"
        cfg_data.background_color = "white"
        cfg_data.use_alpha_map = True
        self.dataset = import_module(cfg_data._target)(
            cfg=cfg_data, batchify_all_views=False)

    def write(self):
        self.tgt_folder.mkdir(parents=True, exist_ok=True)
        db = {"frames": []}
        timestep_indices, camera_indices = set(), set()
        writer = AsyncWriter()
        n = len(self.dataset)
        for i in range(n):
            item = self.dataset[i]
            timestep_indices.add(item["timestep_index"])
            camera_indices.add(item["camera_index"])

            extrinsic = np.asarray(item["extrinsic"], np.float64)
            transform_matrix = np.concatenate(
                [extrinsic, np.asarray([[0, 0, 0, 1.0]])], axis=0)

            K = np.asarray(item["intrinsic"], np.float64)
            cx, cy, fl_x, fl_y = K[0, 2], K[1, 2], K[0, 0], K[1, 1]
            h, w = item["rgb"].shape[:2]
            angle_x = math.atan(w / (fl_x * 2)) * 2
            angle_y = math.atan(h / (fl_y * 2)) * 2

            frame_item = {
                "timestep_index": item["timestep_index"],
                "timestep_index_original": item["timestep_index_original"],
                "timestep_id": item["timestep_id"],
                "camera_index": item["camera_index"],
                "camera_id": item["camera_id"],
                "cx": cx, "cy": cy, "fl_x": fl_x, "fl_y": fl_y,
                "h": h, "w": w,
                "camera_angle_x": angle_x, "camera_angle_y": angle_y,
                "transform_matrix": transform_matrix.tolist(),
                "file_path": f"images/{item['timestep_index']:05d}_"
                             f"{item['camera_index']:02d}.png",
            }
            path2data = {
                str(self.tgt_folder / frame_item["file_path"]): item["rgb"]}
            if "alpha_map" in item:
                frame_item["fg_mask_path"] = (
                    f"fg_masks/{item['timestep_index']:05d}_"
                    f"{item['camera_index']:02d}.png")
                path2data[str(self.tgt_folder / frame_item["fg_mask_path"])] = \
                    item["alpha_map"]
            db["frames"].append(frame_item)
            writer.submit(path2data)

        writer.drain()
        db.update({"cx": cx, "cy": cy, "fl_x": fl_x, "fl_y": fl_y, "h": h,
                   "w": w, "camera_angle_x": angle_x, "camera_angle_y": angle_y})
        db["timestep_indices"] = sorted(timestep_indices)
        db["camera_indices"] = sorted(camera_indices)
        write_json(db, self.tgt_folder)
        write_json(db, self.tgt_folder, division="backup")


# ---------------------------------------------------------------------------
# 2. FLAME params / meshes (vhap/export_as_nerf_dataset.py:151-349)
# ---------------------------------------------------------------------------

def _on(flame_model, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=flame_model.v_template.device)


def infer_flame_params(flame_model, flame_params: Dict, indices: List[int]):
    """Vertices (n, V, 3) of the tracked frames `indices`, by the FLAME
    forward on the model's device."""
    static_offset = flame_params.get("static_offset")
    if static_offset is not None:
        static_offset = _on(flame_model, static_offset)
    n = len(indices)
    idx = np.asarray(indices)
    with torch.no_grad():
        verts = flame_model(
            shape=_on(flame_model, flame_params["shape"])[None].expand(n, -1),
            expr=_on(flame_model, flame_params["expr"][idx]),
            rotation=_on(flame_model, flame_params["rotation"][idx]),
            neck=_on(flame_model, flame_params["neck_pose"][idx]),
            jaw=_on(flame_model, flame_params["jaw_pose"][idx]),
            eyes=_on(flame_model, flame_params["eyes_pose"][idx]),
            translation=_on(flame_model, flame_params["translation"][idx]),
            return_landmarks=False,
            static_offset=static_offset,
        )
    return verts.cpu().numpy()


def _flame_model(cfg_model, device):
    """The export's FLAME model: with teeth, as the reference builds it
    (vhap/export_as_nerf_dataset.py:205-208, 354-357)."""
    from vhap_tpu_torch.model.flame import FlameHead
    return FlameHead.build(cfg_model.n_shape, cfg_model.n_expr,
                           asset_dir=getattr(cfg_model, "asset_dir", None),
                           add_teeth=True, device=device)


class TrackedFLAMEDatasetWriter:
    def __init__(self, cfg_model, src_folder: Path, tgt_folder: Path,
                 mode: Literal["mesh", "param"] = "param", epoch: int = -1,
                 flame_model=None):
        self.cfg_model = cfg_model
        self.src_folder = Path(src_folder)
        self.tgt_folder = Path(tgt_folder)
        self.mode = mode

        db_backup_path = self.tgt_folder / "transforms_backup.json"
        assert db_backup_path.exists(), f"Could not find {db_backup_path}"
        self.db = json.load(open(db_backup_path))

        paths = [Path(p) for p in glob(str(self.src_folder / "tracked_flame_params*.npz"))]
        epochs = [int(p.stem.split("_")[-1]) for p in paths]
        index = int(np.argmax(epochs)) if epoch == -1 else epochs.index(epoch)
        flame_params_path = paths[index]
        logger.info(f"Loading FLAME parameters from: {flame_params_path}")
        self.flame_params = dict(np.load(flame_params_path))

        self.focal_length = (self.flame_params["focal_length"].item()
                             if "focal_length" in self.flame_params else None)
        self.M = self.relocate_flame_meshes(self.flame_params)

        if flame_model is None:
            flame_model = _flame_model(cfg_model, None)
        self.flame_model = flame_model

    def relocate_flame_meshes(self, flame_param):
        """Mean translation -> origin; bake the shift into camera poses
        (vhap/export_as_nerf_dataset.py:189-202)."""
        Ts = np.asarray(flame_param["translation"])
        T_mean = Ts.mean(0)
        M = np.eye(4, dtype=np.float64)
        M[:3, 3] = -T_mean
        flame_param["translation"] = Ts - T_mean
        return M

    def replace_cam_params(self, item):
        """Monocular: replace guessed per-frame cams with the optimized focal
        (vhap/export_as_nerf_dataset.py:204-225)."""
        c2w = np.eye(4)
        c2w[2, 3] = 1
        h, w = item["h"], item["w"]
        fl = self.focal_length * max(h, w)
        item.update({
            "cx": w / 2, "cy": h / 2, "fl_x": fl, "fl_y": fl,
            "camera_angle_x": math.atan(w / (fl * 2)) * 2,
            "camera_angle_y": math.atan(h / (fl * 2)) * 2,
            "transform_matrix": c2w.tolist(),
        })

    def write(self):
        if self.mode == "mesh":
            self.write_canonical_mesh()
            indices = self.db["timestep_indices"]
            verts = infer_flame_params(self.flame_model, self.flame_params, indices)
        else:
            self.write_canonical_flame_param()

        saved = [False] * len(self.db["timestep_indices"])
        for frame in self.db["frames"]:
            if self.focal_length is not None:
                self.replace_cam_params(frame)
            frame["transform_matrix"] = (
                self.M @ np.asarray(frame["transform_matrix"])).tolist()

            ti_orig = frame["timestep_index_original"]
            ti = frame["timestep_index"]
            if self.mode == "mesh":
                frame["exp_path"] = f"flame/exp/{ti:05d}.txt"
                frame["mesh_path"] = f"meshes/{ti:05d}.obj"
                if not saved[ti]:
                    self.write_expr_and_mesh(
                        self.tgt_folder, frame["exp_path"],
                        self.flame_params["expr"][ti_orig],
                        frame["mesh_path"], verts[ti_orig],
                        self.flame_model.faces.cpu().numpy())
                    saved[ti] = True
            else:
                frame["flame_param_path"] = f"flame_param/{ti:05d}.npz"
                if not saved[ti]:
                    self.write_flame_param(
                        self.tgt_folder, frame["flame_param_path"],
                        self.flame_params, ti_orig)
                    saved[ti] = True

        write_json(self.db, self.tgt_folder)
        write_json(self.db, self.tgt_folder, division="backup_flame")

    def write_canonical_mesh(self):
        """Canonical mesh with jaw opened 0.3 rad
        (vhap/export_as_nerf_dataset.py:278-301)."""
        fp = self.flame_params
        canonical = {
            "shape": fp["shape"],
            "expr": np.zeros_like(fp["expr"][:1]),
            "rotation": np.zeros((1, 3)), "neck_pose": np.zeros((1, 3)),
            "jaw_pose": np.asarray([[0.3, 0.0, 0.0]]),
            "eyes_pose": np.zeros((1, 6)), "translation": np.zeros((1, 3)),
        }
        if "static_offset" in fp:
            canonical["static_offset"] = fp["static_offset"]
        verts = infer_flame_params(self.flame_model, canonical, [0])
        obj_data = get_obj_content(verts[0], self.flame_model.faces.cpu().numpy())
        write_data({self.tgt_folder / "canonical.obj": obj_data})

    @staticmethod
    def write_expr_and_mesh(tgt_folder, exp_path, expr, mesh_path, verts, faces):
        path2data = {
            Path(tgt_folder) / exp_path: "\n".join(str(n) for n in expr),
            Path(tgt_folder) / mesh_path: get_obj_content(verts, faces),
        }
        write_data(path2data)

    def write_canonical_flame_param(self):
        fp = self.flame_params
        flame_param = {
            "translation": np.zeros_like(fp["translation"][:1]),
            "rotation": np.zeros_like(fp["rotation"][:1]),
            "neck_pose": np.zeros_like(fp["neck_pose"][:1]),
            "jaw_pose": np.array([[0.3, 0, 0]], np.float32),  # open mouth
            "eyes_pose": np.zeros_like(fp["eyes_pose"][:1]),
            "shape": fp["shape"],
            "expr": np.zeros_like(fp["expr"][:1]),
        }
        if "static_offset" in fp:
            flame_param["static_offset"] = fp["static_offset"]
        write_data({self.tgt_folder / "canonical_flame_param.npz": flame_param})

    @staticmethod
    def write_flame_param(tgt_folder, flame_param_path, flame_params, tid):
        params = {
            "translation": flame_params["translation"][[tid]],
            "rotation": flame_params["rotation"][[tid]],
            "neck_pose": flame_params["neck_pose"][[tid]],
            "jaw_pose": flame_params["jaw_pose"][[tid]],
            "eyes_pose": flame_params["eyes_pose"][[tid]],
            "shape": flame_params["shape"],
            "expr": flame_params["expr"][[tid]],
        }
        if "static_offset" in flame_params:
            params["static_offset"] = flame_params["static_offset"]
        if "dynamic_offset" in flame_params:
            params["dynamic_offset"] = flame_params["dynamic_offset"][[tid]]
        write_data({Path(tgt_folder) / flame_param_path: params})


# ---------------------------------------------------------------------------
# 3. neck-line masks (vhap/export_as_nerf_dataset.py:351-485)
# ---------------------------------------------------------------------------

class MaskFromFLAME:
    def __init__(self, cfg_data, cfg_model, tgt_folder, background_color,
                 flame_model=None, device=None):
        from vhap_tpu_torch.data.nerf_dataset import NeRFDataset
        background_color = (cfg_data.background_color
                            if background_color is None else background_color)
        self.background = np.asarray(
            [255, 255, 255] if background_color == "white" else [0, 0, 0],
            np.uint8)
        self.dataset = NeRFDataset(
            root_folder=tgt_folder, division=None,
            camera_convention_conversion=None, target_extrinsic_type="w2c",
            use_fg_mask=True, use_flame_param=True)
        if flame_model is None:
            flame_model = _flame_model(cfg_model, device)
        self.flame_model = flame_model

    def write(self):
        t2verts = {}
        writer = AsyncWriter()
        for i in range(len(self.dataset)):
            frame = self.dataset[i]
            t = frame["timestep_index"]
            if t not in t2verts:
                t2verts[t] = infer_flame_params(
                    self.flame_model, frame["flame_param"], [0])
            verts = t2verts[t]

            RT = frame["extrinsics"][None, :3]
            K = frame["intrinsics"][None]
            h, w = frame["image_height"], frame["image_width"]
            mask = self.get_mask_tilted_line(verts, RT, K, h, w)

            img = frame["image"].astype(np.float32)
            img = (img * mask[..., None]
                   + self.background[None, None].astype(np.float32)
                   * (1 - mask)[..., None])
            path2data = {str(frame["image_path"]): img.astype(np.uint8)}
            if "fg_mask_path" in frame and "fg_mask" in frame:
                fg = frame["fg_mask"].astype(np.float32)
                if fg.ndim == 3:
                    fg = fg * mask[..., None]
                else:
                    fg = fg * mask
                path2data[str(frame["fg_mask_path"])] = fg.astype(np.uint8)
            writer.submit(path2data)
        writer.drain()

    def get_mask_tilted_line(self, verts, RT, K, h, w):
        """Half-plane below the neck line, Gaussian blurred
        (vhap/export_as_nerf_dataset.py:460-485)."""
        from vhap_tpu_torch.ops import camera as cam
        with torch.no_grad():
            verts_ndc = cam.world_to_ndc(*(_on(self.flame_model, x)
                                           for x in (verts, RT, K)),
                                         (h, w), flip_y=True)
        verts_xy = verts_ndc[0, :, :2].cpu().numpy() * 0.5 + 0.5
        verts_xy = verts_xy * np.asarray([w, h])

        m = self.flame_model.masks
        xy_left = verts_xy[m.get_vid_by_region(["neck_right_point"])]
        xy_right = verts_xy[m.get_vid_by_region(["neck_left_point"])]
        xy_bottom = verts_xy[m.get_vid_by_region(["front_middle_bottom_point_boundary"])]

        delta = xy_left - xy_right
        assert (delta[:, 0] != 0).all()
        k = delta[:, 1] / delta[:, 0]
        b = xy_bottom[:, 1] - k * xy_bottom[:, 0]

        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((k * xx + b - yy) > 0).astype(np.float32)

        ksize = int(0.03 * w) // 2 * 2 + 1
        return _gaussian_blur(mask, ksize, sigma=ksize)


def _gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize) - ksize // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    pad = ksize // 2
    p = np.pad(img, ((pad, pad), (pad, pad)), mode="edge")
    p = np.apply_along_axis(lambda r: np.convolve(r, g, mode="valid"), 1, p)
    p = np.apply_along_axis(lambda c: np.convolve(c, g, mode="valid"), 0, p)
    return p


# ---------------------------------------------------------------------------
# 4. train/val/test split (vhap/export_as_nerf_dataset.py:540-598)
# ---------------------------------------------------------------------------

def split_json(tgt_folder: Path, train_ratio: float = 0.7):
    db = json.load(open(Path(tgt_folder) / "transforms.json"))
    db_train = {k: v for k, v in db.items()
                if k not in ("frames", "timestep_indices", "camera_indices")}
    db_train["frames"] = []
    db_val = deepcopy(db_train)
    db_test = deepcopy(db_train)

    nt = len(db["timestep_indices"])
    assert 0 < train_ratio <= 1
    nt_train = int(np.ceil(nt * train_ratio))
    nt_test = nt - nt_train

    timestep_indices = sorted(db["timestep_indices"])
    db_train["timestep_indices"] = timestep_indices[:nt_train]
    db_val["timestep_indices"] = timestep_indices[:nt_train]
    db_test["timestep_indices"] = timestep_indices[nt_train:]

    if len(db["camera_indices"]) > 1:
        if 8 in db["camera_indices"]:
            db_train["camera_indices"] = [i for i in db["camera_indices"] if i != 8]
            db_val["camera_indices"] = [8]
        else:
            db_train["camera_indices"] = db["camera_indices"][:-1]
            db_val["camera_indices"] = [db["camera_indices"][-1]]
        db_test["camera_indices"] = db["camera_indices"]
    else:
        db_train["camera_indices"] = db["camera_indices"]
        db_val["camera_indices"] = []
        db_test["camera_indices"] = db["camera_indices"]

    range_train = (range(db_train["timestep_indices"][0],
                         db_train["timestep_indices"][-1] + 1)
                   if nt_train > 0 else [])
    range_test = (range(db_test["timestep_indices"][0],
                        db_test["timestep_indices"][-1] + 1)
                  if nt_test > 0 else [])
    for f in db["frames"]:
        if f["timestep_index"] in range_train:
            if f["camera_index"] in db_train["camera_indices"]:
                db_train["frames"].append(f)
            elif f["camera_index"] in db_val["camera_indices"]:
                db_val["frames"].append(f)
            else:
                raise ValueError(f"Unknown camera index: {f['camera_index']}")
        elif f["timestep_index"] in range_test:
            db_test["frames"].append(f)
            assert f["camera_index"] in db_test["camera_indices"]
        else:
            raise ValueError(f"Unknown timestep index: {f['timestep_index']}")

    write_json(db_train, tgt_folder, division="train")
    write_json(db_val, tgt_folder, division="val")
    write_json(db_test, tgt_folder, division="test")


# ---------------------------------------------------------------------------
# entry (vhap/export_as_nerf_dataset.py:600-653)
# ---------------------------------------------------------------------------

def load_config(src_folder: Path):
    config_path = src_folder / "config.yml"
    if not config_path.exists():
        src_folder = sorted(src_folder.iterdir())[-1]
        config_path = src_folder / "config.yml"
    assert config_path.exists(), f"File not found: {config_path}"
    raw = yaml.safe_load(config_path.read_text())
    cfg = _config_from_dict(raw)
    return src_folder, cfg


def _config_from_dict(raw: dict) -> BaseTrackingConfig:
    """Rebuild a config object from the yaml dump (plain dicts)."""
    import dataclasses
    from pathlib import Path as _P

    def fill(cls, d):
        obj = cls()
        hints = {f.name: f for f in dataclasses.fields(cls)}
        for k, v in (d or {}).items():
            if k not in hints:
                continue
            cur = getattr(obj, k)
            if dataclasses.is_dataclass(cur):
                setattr(obj, k, fill(type(cur), v))
            elif isinstance(cur, _P) or (v is not None and "folder" in k):
                setattr(obj, k, _P(v) if v is not None else None)
            elif isinstance(cur, tuple) and isinstance(v, list):
                setattr(obj, k, tuple(v))
            else:
                setattr(obj, k, v)
        return obj

    target = (raw.get("data", {}) or {}).get("_target", "")
    if "nersemble_v2" in target:
        from vhap_tpu_torch.config.nersemble_v2 import NersembleV2TrackingConfig as C
    elif "nersemble" in target:
        from vhap_tpu_torch.config.nersemble import NersembleTrackingConfig as C
    else:
        C = BaseTrackingConfig
    cfg = fill(C, raw)
    cfg.data._target = port_target(cfg.data._target)
    return cfg


def port_target(target: str) -> str:
    """A dataset class named by a JAX-package run ("vhap_tpu.data.X.C") ->
    the port's class of the same name ("vhap_tpu_torch.data.X.C")."""
    if target.startswith("vhap_tpu."):
        return "vhap_tpu_torch." + target[len("vhap_tpu."):]
    return target


def export(src_folder: Path, tgt_folder: Path, subset=None, scale_factor=None,
           background_color=None, flame_mode: str = "param",
           create_mask_from_mesh: bool = True, epoch: int = -1,
           flame_model=None, device=None):
    """The four writers in order; FLAME on `device` (default: the CUDA
    card) unless `flame_model` is given."""
    src_folder = Path(src_folder)
    assert src_folder.exists(), f"Folder not found: {src_folder}"
    src_folder, cfg = load_config(src_folder)
    if epoch != -1:
        tgt_folder = Path(str(tgt_folder) + f"_epoch{epoch}")
    tgt_folder = Path(tgt_folder)
    if flame_model is None:
        flame_model = _flame_model(cfg.model, resolve_device(device))

    NeRFDatasetWriter(cfg.data, tgt_folder, subset, scale_factor,
                      background_color).write()
    TrackedFLAMEDatasetWriter(cfg.model, src_folder, tgt_folder,
                              mode=flame_mode, epoch=epoch,
                              flame_model=flame_model).write()
    if create_mask_from_mesh:
        MaskFromFLAME(cfg.data, cfg.model, tgt_folder, background_color,
                      flame_model=flame_model).write()
    split_json(tgt_folder)
    logger.info("Export finished.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src_folder", type=Path, required=True)
    ap.add_argument("--tgt_folder", type=Path, required=True)
    ap.add_argument("--subset", default=None)
    ap.add_argument("--scale_factor", type=float, default=None)
    ap.add_argument("--background-color", default=None)
    ap.add_argument("--flame-mode", choices=["mesh", "param"], default="param")
    ap.add_argument("--no-mask-from-mesh", action="store_true")
    ap.add_argument("--epoch", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device of FLAME (default: the CUDA card)")
    args = ap.parse_args(argv)
    export(args.src_folder, args.tgt_folder, args.subset, args.scale_factor,
           args.background_color, args.flame_mode,
           not args.no_mask_from_mesh, args.epoch, device=args.device)


if __name__ == "__main__":
    main()
