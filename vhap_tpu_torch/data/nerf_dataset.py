"""Reader for exported NeRF-style datasets (numpy and PIL).

Counterpart of vhap_tpu/data/nerf_dataset.py (reference:
vhap/data/nerf_dataset.py): transforms[_train/_val/_test].json with
per-frame intrinsics/extrinsics, optional fg masks and FLAME param npz.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image

from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)


class NeRFDataset:
    def __init__(self, root_folder, division=None,
                 camera_convention_conversion=None,
                 target_extrinsic_type="w2c",
                 use_fg_mask=False, use_flame_param=False):
        self.root_folder = Path(root_folder)
        self.division = division
        self.camera_convention_conversion = camera_convention_conversion
        self.target_extrinsic_type = target_extrinsic_type
        self.use_fg_mask = use_fg_mask
        self.use_flame_param = use_flame_param

        logger.info(f"Loading NeRF scene from: {root_folder}")
        name = {None: "transforms.json", "train": "transforms_train.json",
                "val": "transforms_val.json", "test": "transforms_test.json"}[division]
        self.transforms = json.load(open(self.root_folder / name))
        logger.info(
            f"number of timesteps: {len(self.transforms['timestep_indices'])}, "
            f"number of cameras: {len(self.transforms['camera_indices'])}")
        assert (len(self.transforms["timestep_indices"])
                == max(self.transforms["timestep_indices"]) + 1)

    def __len__(self):
        return len(self.transforms["frames"])

    def __getitem__(self, i):
        frame = self.transforms["frames"][i]
        K = np.eye(3, dtype=np.float32)
        K[0, 0], K[1, 1] = frame["fl_x"], frame["fl_y"]
        K[0, 2], K[1, 2] = frame["cx"], frame["cy"]

        c2w = np.asarray(frame["transform_matrix"], np.float32)
        if self.target_extrinsic_type == "w2c":
            extrinsic = np.linalg.inv(c2w)
        elif self.target_extrinsic_type == "c2w":
            extrinsic = c2w
        else:
            raise NotImplementedError(self.target_extrinsic_type)

        img_path = self.root_folder / frame["file_path"]
        item = {
            "timestep_index": frame["timestep_index"],
            "camera_index": frame["camera_index"],
            "intrinsics": K,
            "extrinsics": extrinsic,
            "image_height": frame["h"],
            "image_width": frame["w"],
            "image": np.array(Image.open(img_path)),
            "image_path": img_path,
        }
        if self.use_fg_mask and "fg_mask_path" in frame:
            p = self.root_folder / frame["fg_mask_path"]
            item["fg_mask"] = np.array(Image.open(p))
            item["fg_mask_path"] = p
        if self.use_flame_param and "flame_param_path" in frame:
            npz = np.load(self.root_folder / frame["flame_param_path"],
                          allow_pickle=True)
            item["flame_param"] = dict(npz)
        return item
