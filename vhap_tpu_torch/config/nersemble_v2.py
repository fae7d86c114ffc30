"""NeRSemble v2 tracking configuration.

Counterpart of vhap_tpu/config/nersemble_v2.py (reference:
vhap/config/nersemble_v2.py); `data._target` names the port's dataset class.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from vhap_tpu_torch.config.nersemble import NersembleDataConfig, NersembleTrackingConfig


@dataclass
class NersembleV2DataConfig(NersembleDataConfig):
    _target: str = "vhap_tpu_torch.data.nersemble_v2_dataset.NeRSembleV2Dataset"


@dataclass
class NersembleV2TrackingConfig(NersembleTrackingConfig):
    data: NersembleV2DataConfig = field(default_factory=NersembleV2DataConfig)
