"""Flat image-folder dataset with optional per-camera background plates.

Counterpart of vhap_tpu/data/image_folder_dataset.py (reference:
vhap/data/image_folder_dataset.py, used by BackgroundMattingV2).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image


class ImageFolderDataset:
    def __init__(self, image_folder: Path,
                 background_folder: Optional[Path] = None,
                 background_fname2camId=None, image_fname2camId=None):
        self.image_folder = Path(image_folder)
        self.image_paths = sorted(self.image_folder.glob("*.jpg")) \
            + sorted(self.image_folder.glob("*.png"))
        self.image_fname2camId = image_fname2camId

        self.backgrounds = {}
        if background_folder is not None:
            for p in sorted(Path(background_folder).glob("*.jpg")) \
                    + sorted(Path(background_folder).glob("*.png")):
                cam = (background_fname2camId(p.name)
                       if background_fname2camId else p.stem)
                self.backgrounds[cam] = np.array(Image.open(p))

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, i):
        p = self.image_paths[i]
        item = {"image_path": str(p), "image": np.array(Image.open(p))}
        if self.backgrounds:
            cam = (self.image_fname2camId(p.name)
                   if self.image_fname2camId else p.stem.split("_")[0])
            if cam in self.backgrounds:
                item["background"] = self.backgrounds[cam]
        return item
