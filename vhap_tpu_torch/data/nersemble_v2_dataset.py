"""NeRSemble v2 dataset: per-subject calibration folder + Cheung-2004 CCM.

Counterpart of vhap_tpu/data/nersemble_v2_dataset.py (reference:
vhap/data/nersemble_v2_dataset.py).

NOTE (the JAX package's deviation from the reference, kept): the reference's
apply_color_correction computes the corrected image but writes back the
*uncorrected* rgb (vhap/data/nersemble_v2_dataset.py:67 uses `rgb` instead
of `image_corrected`), making v2 color correction a no-op. We apply the
corrected image; set ``use_color_correction=False`` to match the
reference's effective behavior bit-for-bit.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from vhap_tpu_torch.data.nersemble_dataset import NeRSembleDataset
from vhap_tpu_torch.util.color_correction import (cctf_decoding, cctf_encoding,
                                            color_correction_Cheung2004_precomputed)
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)


class NeRSembleV2Dataset(NeRSembleDataset):
    def match_sequences(self):
        logger.info(f"Subject: {self.cfg.subject}, sequence: {self.cfg.sequence}")
        return [x for x in (Path(self.cfg.root_folder) / self.cfg.subject / "sequences")
                .glob(f"{self.cfg.sequence}*") if x.is_dir()]

    def load_camera_params(self):
        super().load_camera_params(
            Path(self.cfg.root_folder) / self.cfg.subject / "calibration"
            / "camera_params.json")

    def load_color_correction(self):
        if self.cfg.use_color_correction:
            p = (Path(self.cfg.root_folder) / self.cfg.subject / "calibration"
                 / "color_calibration.json")
            self.color_correction = {
                serial: np.array(ccm)
                for serial, ccm in json.load(open(p)).items()}

    def apply_color_correction(self, item):
        """Cheung-2004 CCM in linear light (nersemble_v2_dataset.py:60-68)."""
        if self.cfg.use_color_correction:
            rgb = item["rgb"] / 255
            image_linear = cctf_decoding(rgb)
            ccm = self.color_correction[item["camera_id"]]
            corrected = cctf_encoding(
                color_correction_Cheung2004_precomputed(image_linear, ccm))
            item["rgb"] = (np.clip(corrected, 0, 1) * 255).astype(np.uint8)
        return item
