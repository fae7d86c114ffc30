"""Generic video-folder dataset (numpy and PIL).

Counterpart of vhap_tpu/data/video_dataset.py (reference:
vhap/data/video_dataset.py): same folder layout (images/, alpha_maps/,
landmark2d/{face-alignment,STAR,...}), same subset DSL (ti/tj/tn/ts +
ci/cn/cs), same guessed intrinsics for uncalibrated video, same transforms
(scale factor, background colour). Samples are channel-last float arrays
ready for upload to the device. A batch of frames is decoded, colour
corrected, resized and composited by the native C++ loader
(data/native_loader.py) when the configuration qualifies
(`supports_native_batch`) and the loader builds, else frame by frame with
PIL; `native_batches` and `pil_batches` count which path each batch took.
"""

from __future__ import annotations

import os
from copy import deepcopy
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from vhap_tpu_torch.config.base import DataConfig
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

# landmark source -> property folder (vhap_tpu/preprocess/landmarks.py:255-258)
SOURCE_DIRS = {"star": "landmark2d/STAR",
               "face-alignment": "landmark2d/face-alignment",
               "fan-jax": "landmark2d/fan-jax",
               "star-jax": "landmark2d/star-jax"}


def default_collate(items: List[Dict]) -> Dict:
    """Stack a list of sample dicts into batched arrays."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


class VideoDataset:
    def __init__(self, cfg: DataConfig, img_to_tensor: bool = False,
                 batchify_all_views: bool = False):
        self.cfg = cfg
        self.img_to_tensor = img_to_tensor  # channel-last float [0,1]
        self.batchify_all_views = batchify_all_views
        self.native_batches = 0   # batches the C++ loader decoded
        self.pil_batches = 0      # batches decoded frame by frame with PIL

        sequence_paths = self.match_sequences()
        if len(sequence_paths) > 1:
            raise ValueError(f"Found multiple sequences by '{cfg.sequence}': "
                             + ", ".join(str(x) for x in sequence_paths))
        if len(sequence_paths) == 0:
            raise ValueError(f"Cannot find sequence: {cfg.sequence}")
        self.sequence_path = Path(sequence_paths[0])
        logger.info(f"Initializing dataset from {self.sequence_path}")

        self.define_properties()
        self.load_camera_params()

        rgb_folder = self.sequence_path / self.properties["rgb"]["folder"]
        suffix = self.properties["rgb"]["suffix"]
        self.timestep_ids = sorted(set(
            f.split(".")[0].split("_")[-1]
            for f in os.listdir(rgb_folder) if f.endswith(suffix)))
        self.timestep_indices = list(range(len(self.timestep_ids)))

        self.filter_division(cfg.division)
        self.filter_subset(cfg.subset)
        logger.info(f"number of timesteps: {self.num_timesteps}, "
                    f"number of cameras: {self.num_cameras}")

        self.items = []
        for fi, timestep_index in enumerate(self.timestep_indices):
            for ci, camera_id in enumerate(self.camera_ids):
                self.items.append(dict(
                    timestep_index=fi,
                    timestep_index_original=timestep_index,
                    timestep_id=self.timestep_ids[timestep_index],
                    camera_index=ci,
                    camera_id=camera_id,
                ))

    # -- discovery -----------------------------------------------------------

    def match_sequences(self):
        logger.info(f"Looking for sequence '{self.cfg.sequence}' at {self.cfg.root_folder}")
        return [x for x in Path(self.cfg.root_folder).glob(f"{self.cfg.sequence}*")
                if x.is_dir()]

    def define_properties(self):
        self.properties = {
            "rgb": {
                "folder": (f"images_{self.cfg.n_downsample_rgb}"
                           if self.cfg.n_downsample_rgb else "images"),
                "per_timestep": True, "suffix": "jpg",
            },
            "alpha_map": {"folder": "alpha_maps", "per_timestep": True, "suffix": "jpg"},
        }
        # one property path per landmark source dir (reference scheme
        # vhap/data/video_dataset.py:325-365, extended with the JAX
        # package's detector backends)
        for prop in SOURCE_DIRS.values():
            self.properties[prop] = {
                "folder": prop, "per_timestep": False, "suffix": "npz"}

    @staticmethod
    def get_number_after_prefix(string: str, prefix: str) -> Optional[int]:
        i = string.find(prefix)
        if i == -1:
            return None
        begin = i + len(prefix)
        assert begin < len(string) and string[begin].isdigit(), \
            f"No number found behind prefix '{prefix}'"
        end = begin
        while end < len(string) and string[end].isdigit():
            end += 1
        return int(string[begin:end])

    def filter_division(self, division):
        pass

    def filter_subset(self, subset):
        """ti/tj/tn/ts timestep filters + ci/cn/cs camera filters
        (vhap/data/video_dataset.py:136-163)."""
        if subset is None:
            return
        g = self.get_number_after_prefix
        if "ti" in subset:
            ti = g(subset, "ti")
            if "tj" in subset:
                tj = g(subset, "tj")
                self.timestep_indices = self.timestep_indices[ti:tj + 1]
            else:
                self.timestep_indices = self.timestep_indices[ti:ti + 1]
        elif "tn" in subset:
            tn = min(g(subset, "tn"), len(self.timestep_indices))
            self.timestep_indices = self.timestep_indices[::len(self.timestep_indices) // tn][:tn]
        elif "ts" in subset:
            self.timestep_indices = self.timestep_indices[::g(subset, "ts")]
        if "ci" in subset:
            ci = g(subset, "ci")
            self.camera_ids = self.camera_ids[ci:ci + 1]
        elif "cn" in subset:
            cn = min(g(subset, "cn"), len(self.camera_ids))
            self.camera_ids = self.camera_ids[::len(self.camera_ids) // cn][:cn]
        elif "cs" in subset:
            self.camera_ids = self.camera_ids[::g(subset, "cs")]

    def load_camera_params(self):
        """Guessed camera for uncalibrated video
        (vhap/data/video_dataset.py:165-195)."""
        self.camera_ids = ["0"]
        f, h, w = 512, 512, 512
        K = np.array([[f, 0, w], [0, f, h], [0, 0, 1]], np.float32)

        orientation = np.eye(3, dtype=np.float32)[None]
        location = np.array([0, 0, 1], np.float32)[None, :, None]
        c2w = np.concatenate([orientation, location], axis=-1)
        if self.cfg.target_extrinsic_type == "w2c":
            R = orientation.transpose(0, 2, 1)
            T = R @ -location
            extrinsic = np.concatenate([R, T], axis=-1)
        elif self.cfg.target_extrinsic_type == "c2w":
            extrinsic = c2w
        else:
            raise NotImplementedError(self.cfg.target_extrinsic_type)

        self.camera_params = {
            cid: {"intrinsic": K.copy(), "extrinsic": extrinsic[i].astype(np.float32)}
            for i, cid in enumerate(self.camera_ids)}
        return self.camera_params

    # -- fast batch path (native loader) ---------------------------------------

    def supports_native_batch(self) -> bool:
        """The C++ loader covers the full transform chain (decode,
        per-camera affine colour correction, PIL-BILINEAR scale_factor
        resize, background composite), so every jpg-backed configuration
        qualifies (NeRSemble with use_color_correction and scale_factor
        included)."""
        return (self.img_to_tensor
                and self.cfg.scale_factor <= 1.0
                and self.properties["rgb"]["suffix"] == "jpg")

    def load_batch_native(self, indices):
        """Threaded decode + colour correction + resize + composite of a
        batch of items -> (rgb float32 (n, h, w, 3), alpha (n, h, w)), or
        None when the configuration does not qualify, the loader is
        unavailable or a frame fails (the caller then takes PIL)."""
        if not self.supports_native_batch():
            return None
        from vhap_tpu_torch.data import native_loader
        rgb_paths = [str(self.get_property_path("rgb", i)) for i in indices]
        use_alpha = self.cfg.use_alpha_map or self.cfg.background_color is not None
        alpha_paths = ([str(self.get_property_path("alpha_map", i))
                        for i in indices] if use_alpha else None)
        bg = {None: None, "white": (1.0, 1.0, 1.0),
              "black": (0.0, 0.0, 0.0)}[self.cfg.background_color]
        H, W = self._resolve_image_hw(rgb_paths[0])
        h, w = int(H * self.cfg.scale_factor), int(W * self.cfg.scale_factor)
        cc = None
        if getattr(self.cfg, "use_color_correction", False):
            mats = [np.asarray(self.color_correction[
                self.items[i]["camera_id"]], np.float64) for i in indices]
            if any(m.ndim != 2 or m.shape[0] not in (3, 4) or m.shape[1] != 4
                   for m in mats):
                return None  # non-affine CC (NeRSemble v2 CCM): PIL path
            cc = np.stack([m[:3, :4] for m in mats])
        out = native_loader.load_batch(rgb_paths, alpha_paths, h, w, bg,
                                       color_correction=cc)
        if out is not None:
            self.native_batches += 1
        return out

    _image_hw = None

    def _resolve_image_hw(self, sample_path=None):
        if self._image_hw is None:
            p = sample_path or self.get_property_path("rgb", 0)
            with Image.open(p) as im:
                self._image_hw = (im.height, im.width)
        return self._image_hw

    def load_lmk2d(self, i):
        """Landmarks for item i in pixel coords (cached npz per camera)."""
        if not self.cfg.use_landmark:
            return None
        source = SOURCE_DIRS[self.cfg.landmark_source]
        cam = self.items[i]["camera_id"]
        if not hasattr(self, "_lmk_cache"):
            self._lmk_cache = {}
        if cam not in self._lmk_cache:
            npz = np.load(self.get_property_path(source, i))
            self._lmk_cache[cam] = np.array(npz["face_landmark_2d"], np.float32)
        lmk = self._lmk_cache[cam][self.items[i]["timestep_index"]].copy()
        if (lmk[:, :2] == -1).sum() > 0:
            lmk[:, 2:] = 0.0
        else:
            lmk[:, 2:] = 1.0
        h, w = self._resolve_image_hw()
        lmk[..., 0] *= w * self.cfg.scale_factor
        lmk[..., 1] *= h * self.cfg.scale_factor
        return lmk

    # -- access ---------------------------------------------------------------

    def __len__(self):
        return self.num_timesteps if self.batchify_all_views else len(self.items)

    def __getitem__(self, i):
        if self.batchify_all_views:
            return self.getitem_by_timestep(i)
        return self.getitem_single_image(i)

    def getitem_single_image(self, i):
        item = deepcopy(self.items[i])

        rgb_path = self.get_property_path("rgb", i)
        item["rgb"] = np.array(Image.open(rgb_path))

        camera_param = self.camera_params[item["camera_id"]]
        item["intrinsic"] = camera_param["intrinsic"].copy()
        item["extrinsic"] = camera_param["extrinsic"].copy()

        if self.cfg.use_alpha_map or self.cfg.background_color is not None:
            alpha_path = self.get_property_path("alpha_map", i)
            item["alpha_map"] = np.array(Image.open(alpha_path))

        if self.cfg.use_landmark:
            timestep_index = self.items[i]["timestep_index"]
            source = SOURCE_DIRS[self.cfg.landmark_source]
            npz = np.load(self.get_property_path(source, i))
            lmk = np.array(npz["face_landmark_2d"][timestep_index], np.float32)
            # -1 rows mean "no face found" -> zero confidence
            # (vhap/data/video_dataset.py:235-238)
            if (lmk[:, :2] == -1).sum() > 0:
                lmk[:, 2:] = 0.0
            else:
                lmk[:, 2:] = 1.0
            item["lmk2d"] = lmk

        return self.apply_transforms(item)

    def getitem_meta(self, i):
        """getitem_single_image without the image IO: camera parameters and
        landmarks with the same scale transforms (the native batch loader
        supplies rgb and alpha)."""
        item = deepcopy(self.items[i])
        camera_param = self.camera_params[item["camera_id"]]
        item["intrinsic"] = camera_param["intrinsic"].copy()
        item["extrinsic"] = camera_param["extrinsic"].copy()
        if self.cfg.use_landmark:
            item["lmk2d"] = self.load_lmk2d(i)
        n_downsample = self.cfg.n_downsample_rgb or 1
        scale_factor = self.cfg.scale_factor / n_downsample
        item["scale_factor"] = scale_factor
        if scale_factor < 1.0:
            item["intrinsic"][:2] *= scale_factor
        return item

    def getitem_by_timestep(self, timestep_index, views=None):
        """Every view of one timestep, or the views `views` (camera
        positions, in that order, repeats allowed: one rank's rows of a
        sharded batch); cameras travel with their views."""
        begin = timestep_index * self.num_cameras
        if views is None:
            views = range(self.num_cameras)
        idx = [begin + int(v) for v in views]
        native = self.load_batch_native(idx)
        if native is not None:
            # C++ decode/CC/resize/composite; Python only for metadata
            item = default_collate([self.getitem_meta(i) for i in idx])
            item["rgb"] = native[0]
            if self.cfg.use_alpha_map:
                item["alpha_map"] = native[1]
        else:
            item = default_collate([self.getitem_single_image(i) for i in idx])
            self.pil_batches += 1
        item["num_cameras"] = self.num_cameras
        return item

    # -- transforms -------------------------------------------------------------

    def apply_transforms(self, item):
        item = self.apply_scale_factor(item)
        item = self.apply_background_color(item)
        item = self.apply_to_tensor(item)
        return item

    def apply_to_tensor(self, item):
        if self.img_to_tensor:
            if "rgb" in item:
                item["rgb"] = item["rgb"].astype(np.float32) / 255.0
            if "alpha_map" in item:
                item["alpha_map"] = item["alpha_map"].astype(np.float32) / 255.0
        return item

    def apply_scale_factor(self, item):
        assert self.cfg.scale_factor <= 1.0
        if "rgb" in item:
            H, W = item["rgb"].shape[:2]
            h, w = int(H * self.cfg.scale_factor), int(W * self.cfg.scale_factor)
            if (h, w) != (H, W):
                item["rgb"] = np.array(
                    Image.fromarray(item["rgb"]).resize((w, h), Image.BILINEAR))
        else:
            h = w = None

        if "lmk2d" in item and w is not None:
            item["lmk2d"][..., 0] *= w
            item["lmk2d"][..., 1] *= h

        n_downsample = self.cfg.n_downsample_rgb or 1
        scale_factor = self.cfg.scale_factor / n_downsample
        item["scale_factor"] = scale_factor
        if scale_factor < 1.0:
            if "intrinsic" in item:
                item["intrinsic"][:2] *= scale_factor
            if "alpha_map" in item and "rgb" in item:
                h, w = item["rgb"].shape[:2]
                item["alpha_map"] = np.array(
                    Image.fromarray(item["alpha_map"]).resize((w, h), Image.BILINEAR))
        return item

    def apply_background_color(self, item):
        if self.cfg.background_color is not None:
            assert "alpha_map" in item, "'alpha_map' required for background color"
            fg = item["rgb"]
            if self.cfg.background_color == "white":
                bg = np.full_like(fg, 255)
            elif self.cfg.background_color == "black":
                bg = np.zeros_like(fg)
            else:
                raise NotImplementedError(self.cfg.background_color)
            w = item["alpha_map"][..., None] / 255
            item["rgb"] = (w * fg + (1 - w) * bg).astype(np.uint8)
        return item

    # -- paths --------------------------------------------------------------------

    def get_property_path(self, name, index=None, timestep_id=None, camera_id=None):
        p = self.properties[name]
        path = self.sequence_path
        if p.get("folder"):
            path = path / p["folder"]

        if self.num_cameras > 1:
            if camera_id is None:
                assert index is not None
                camera_id = self.items[index]["camera_id"]
            if "cam_id_prefix" in p:
                camera_id = p["cam_id_prefix"] + camera_id
        else:
            camera_id = ""

        if p["per_timestep"]:
            if timestep_id is None:
                assert index is not None
                timestep_id = self.items[index]["timestep_id"]
            if camera_id:
                path = path / f"{camera_id}_{timestep_id}.{p['suffix']}"
            else:
                path = path / f"{timestep_id}.{p['suffix']}"
        else:
            if camera_id:
                path = path / f"{camera_id}.{p['suffix']}"
            else:
                path = Path(str(path) + f".{p['suffix']}")
        return path

    def get_property_path_list(self, name):
        return [self.get_property_path(name, i) for i in range(len(self.items))]

    @property
    def num_timesteps(self):
        return len(self.timestep_indices)

    @property
    def num_cameras(self):
        return len(self.camera_ids)
