"""NeRSemble multiview dataset (v1): 16-camera calibrated rig.

Counterpart of vhap_tpu/data/nersemble_dataset.py (reference:
vhap/data/nersemble_dataset.py): camera_params.json parsing (w2c -> c2w,
rig axis alignment, opencv -> opengl conversion), per-camera affine colour
correction, camera train/val divisions, and batchify_all_views=True (one
sample = the collated views of a timestep). Frames are decoded with PIL and
colour-corrected in numpy (the JAX package's PIL path).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from vhap_tpu_torch.data.video_dataset import VideoDataset
from vhap_tpu_torch.util import camera_np as camera
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)


class NeRSembleDataset(VideoDataset):
    def __init__(self, cfg, img_to_tensor: bool = False,
                 batchify_all_views: bool = True):
        assert cfg.subject != "", "Please specify the subject name"
        super().__init__(cfg=cfg, img_to_tensor=img_to_tensor,
                         batchify_all_views=batchify_all_views)
        self.load_color_correction()

    def match_sequences(self):
        logger.info(f"Subject: {self.cfg.subject}, sequence: {self.cfg.sequence}")
        return [x for x in (Path(self.cfg.root_folder) / self.cfg.subject)
                .glob(f"{self.cfg.sequence}*") if x.is_dir()]

    def define_properties(self):
        super().define_properties()
        self.properties["rgb"]["cam_id_prefix"] = "cam_"
        self.properties["alpha_map"]["cam_id_prefix"] = "cam_"

    def load_camera_params(self, camera_params_path=None):
        """camera_params.json -> aligned/converted per-camera K, RT
        (vhap/data/nersemble_dataset.py:75-124)."""
        if camera_params_path is None:
            camera_params_path = (Path(self.cfg.root_folder) / "camera_params"
                                  / self.cfg.subject / "camera_params.json")
        assert Path(camera_params_path).exists(), camera_params_path
        param = json.load(open(camera_params_path))

        K = np.asarray(param["intrinsics"], np.float32)
        if "height" not in param or "width" not in param:
            assert self.cfg.image_size_during_calibration is not None
            H, W = self.cfg.image_size_during_calibration
        else:
            H, W = param["height"], param["width"]

        self.camera_ids = list(param["world_2_cam"].keys())
        w2c = np.asarray([param["world_2_cam"][k] for k in self.camera_ids],
                         np.float32)                         # (N, 4, 4)
        R = w2c[..., :3, :3]
        T = w2c[..., :3, 3]
        orientation = R.transpose(0, 2, 1)                   # (N, 3, 3)
        location = orientation @ -T[..., None]               # (N, 3, 1)

        if self.cfg.align_cameras_to_axes:
            orientation, location = camera.align_cameras_to_axes(
                orientation, location, target_convention="opengl")

        if self.cfg.camera_convention_conversion is not None:
            orientation, K = camera.convert_camera_convention(
                self.cfg.camera_convention_conversion, orientation, K, H, W)

        c2w = np.concatenate([orientation, location], axis=-1)
        if self.cfg.target_extrinsic_type == "w2c":
            Rw = orientation.transpose(0, 2, 1)
            Tw = Rw @ -location
            extrinsic = np.concatenate([Rw, Tw], axis=-1)
        elif self.cfg.target_extrinsic_type == "c2w":
            extrinsic = c2w
        else:
            raise NotImplementedError(self.cfg.target_extrinsic_type)

        self.camera_params = {}
        for i, camera_id in enumerate(self.camera_ids):
            Ki = K if K.ndim == 2 else K[i]
            self.camera_params[camera_id] = {
                "intrinsic": np.asarray(Ki, np.float32),
                "extrinsic": extrinsic[i].astype(np.float32)}

    def load_color_correction(self):
        """Per-camera affine color transform npy files
        (vhap/data/nersemble_dataset.py:126-133)."""
        if self.cfg.use_color_correction:
            self.color_correction = {}
            for camera_id in self.camera_ids:
                p = (Path(self.cfg.root_folder) / "color_correction"
                     / self.cfg.subject / f"{camera_id}.npy")
                assert p.exists(), f"Color correction file not found: {p}"
                self.color_correction[camera_id] = np.load(p)

    def filter_division(self, division):
        """Named camera subsets (vhap/data/nersemble_dataset.py:135-158)."""
        if division is None:
            return
        cam_for_train = [8, 7, 9, 4, 10, 5, 13, 2, 12, 1, 14, 0]
        n = len(self.camera_ids)
        if division == "train":
            self.camera_ids = [self.camera_ids[i] for i in range(n)
                               if i in cam_for_train]
        elif division == "val":
            self.camera_ids = [self.camera_ids[i] for i in range(n)
                               if i not in cam_for_train]
        elif division == "front-view":
            self.camera_ids = self.camera_ids[8:9]
        elif division == "side-view":
            self.camera_ids = self.camera_ids[0:1]
        elif division == "six-view":
            self.camera_ids = [self.camera_ids[i] for i in [0, 1, 7, 8, 14, 15]]
        else:
            raise NotImplementedError(f"Unknown division type: {division}")
        logger.info(f"division: {division}")

    def apply_transforms(self, item):
        item = self.apply_color_correction(item)
        return super().apply_transforms(item)

    def apply_color_correction(self, item):
        """Affine color transform in [0,1] space
        (vhap/data/nersemble_dataset.py:165-171)."""
        if self.cfg.use_color_correction:
            A = self.color_correction[item["camera_id"]]
            rgb = item["rgb"] / 255
            rgb = rgb @ A[:3, :3] + A[np.newaxis, :3, 3]
            item["rgb"] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        return item
