"""NeRSemble multiview tracking configuration.

Counterpart of vhap_tpu/config/nersemble.py (reference:
vhap/config/nersemble.py); `data._target` names the port's dataset class.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple

from reference.config.base import (BaseTrackingConfig, DataConfig,
                                        LossWeightConfig, PipelineConfig,
                                        StageRgbGlobalTrackingConfig,
                                        StageRgbSequentialTrackingConfig)
from reference.util.log import get_logger

logger = get_logger(__name__)


@dataclass
class NersembleDataConfig(DataConfig):
    _target: str = "reference.data.nersemble_dataset.NeRSembleDataset"
    calibrated: bool = True
    image_size_during_calibration: Optional[Tuple[int, int]] = (3208, 2200)
    background_color: Optional[Literal["white", "black"]] = None
    landmark_source: Optional[
        Literal["face-alignment", "star", "fan-jax", "star-jax"]] = "star"
    subject: str = ""
    use_color_correction: bool = True


@dataclass
class NersembleLossWeightConfig(LossWeightConfig):
    landmark: Optional[float] = 3.0        # should not be lower (collapse)
    always_enable_jawline_landmarks: bool = False
    reg_expr: float = 1e-2                  # best expressiveness
    reg_tex_tv: Optional[float] = 1e5       # 10x base
    smooth_expr: float = 0.0


@dataclass
class NersembleStageRgbSequentialTrackingConfig(StageRgbSequentialTrackingConfig):
    optimizable_params: Tuple[str, ...] = ("pose", "joints", "expr", "dynamic_offset")
    # FLAME's lower neck is stiff; relax alignment there (config/nersemble.py:45-60)
    align_texture_except: Tuple[str, ...] = ("boundary",)
    align_boundary_except: Tuple[str, ...] = ("boundary",)


@dataclass
class NersembleStageRgbGlobalTrackingConfig(StageRgbGlobalTrackingConfig):
    align_texture_except: Tuple[str, ...] = ("boundary",)
    align_boundary_except: Tuple[str, ...] = ("boundary",)


@dataclass
class NersemblePipelineConfig(PipelineConfig):
    rgb_sequential_tracking: NersembleStageRgbSequentialTrackingConfig = field(
        default_factory=NersembleStageRgbSequentialTrackingConfig)
    rgb_global_tracking: NersembleStageRgbGlobalTrackingConfig = field(
        default_factory=NersembleStageRgbGlobalTrackingConfig)


@dataclass
class NersembleTrackingConfig(BaseTrackingConfig):
    data: NersembleDataConfig = field(default_factory=NersembleDataConfig)
    w: NersembleLossWeightConfig = field(default_factory=NersembleLossWeightConfig)
    pipeline: NersemblePipelineConfig = field(default_factory=NersemblePipelineConfig)

    def get_occluded(self):
        occluded_table = {
            "018": ("neck_lower",),
            "218": ("neck_lower",),
            "251": ("neck_lower", "boundary"),
            "253": ("neck_lower",),
        }
        if self.data.subject in occluded_table:
            logger.info(f"Automatically setting cfg.model.occluded to "
                        f"{occluded_table[self.data.subject]}")
            self.model.occluded = occluded_table[self.data.subject]
