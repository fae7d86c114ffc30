"""Tracking configuration read by the port's steps and its tracker loop.

Same field names and defaults as vhap_tpu/config/base.py (and through it
the reference's vhap/config/base.py), so recipes and command lines carry
over unchanged; CLI parsing is in reference.config.cli. Two fields
differ by design: `data._target` names the port's dataset class, and
`device` (None = the CUDA card) is the torch device the tracker computes
on. The JAX package's TPU-only render knobs stay in the dataclasses, but
the port accepts each only at the values its one path serves: any other
value selects a TPU layout or workaround the port does not carry (ROADMAP.md
"Not to port"), and `RenderConfig.check_portable` raises on it.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal, Optional, Tuple

from reference.util.log import get_logger

logger = get_logger(__name__)


def import_module(module_name: str):
    """'pkg.mod.Class' -> Class (vhap/config/base.py:19-22)."""
    module_name, class_name = module_name.rsplit(".", 1)
    return getattr(importlib.import_module(module_name), class_name)


class Config:
    def __getitem__(self, name: str):
        if hasattr(self, name):
            return getattr(self, name)
        raise AttributeError(f"{self.__class__.__name__} has no attribute '{name}'")


@dataclass
class DataConfig(Config):
    root_folder: Path = Path(".")
    sequence: str = ""
    _target: str = "reference.data.video_dataset.VideoDataset"
    division: Optional[str] = None
    subset: Optional[str] = None
    calibrated: bool = False
    align_cameras_to_axes: bool = True
    camera_convention_conversion: str = "opencv->opengl"
    target_extrinsic_type: Literal["w2c", "c2w"] = "w2c"
    n_downsample_rgb: Optional[int] = None
    scale_factor: float = 1.0
    background_color: Optional[Literal["white", "black"]] = "white"
    use_alpha_map: bool = False
    use_landmark: bool = True
    landmark_source: Optional[
        Literal["face-alignment", "star", "fan-jax", "star-jax"]] = "star"
    landmark_detector_njobs: int = 8


@dataclass
class ModelConfig(Config):
    n_shape: int = 300
    n_expr: int = 100
    n_tex: int = 100
    use_static_offset: bool = True
    use_dynamic_offset: bool = False
    add_teeth: bool = True
    remove_lip_inside: bool = False
    tex_resolution: int = 2048
    tex_painted: bool = True
    tex_extra: bool = True
    tex_clusters: Tuple[str, ...] = ("skin", "hair", "boundary", "lips_tight",
                                     "teeth", "sclerae", "irises")
    residual_tex: bool = True
    occluded: Tuple[str, ...] = ()
    flame_params_path: Optional[Path] = None
    asset_dir: Optional[Path] = None
    """Directory holding the FLAME asset files."""


# TPU-only render knobs and the values of each the port accepts. The port
# has one implementation of each stage (exact visibility with no bin
# budget, the fused per-pixel interpolation, the image layout at any H x W,
# a float32 color chain, exact trilinear texel fetches and the sampling
# cluster disturbance) and reads none of these fields but disturb_impl,
# whose "auto" resolves to "sample" as in the JAX package. Every bin_mode
# selects that one path: the JAX package's flat bins (its K2 kernel) and
# dense per-tile lists (its K7 kernel) are two TPU layouts of the fused
# interpolation, which the port computes per pixel from the winning face.
# A list cap (max_faces_per_tile, plane_max_list) would drop faces; the port
# has no lists to cap, so both stay at 0.
_PORTABLE_ONLY = {
    "plane_impl": ("auto",),
    "interp_impl": ("auto",),
    "bin_mode": ("auto", "flat", "dense"),
    "pad_to_tiles": (True,),
    "max_faces_per_tile": (0,),
    "plane_max_list": (0,),
    "backend": ("auto",),
    "layout": ("auto",),
    "color_dtype": ("auto",),
    "texture_grad_mode": ("trilinear",),
    "texture_grad_impl": ("auto",),
    "disturb_impl": ("auto", "sample"),
}


@dataclass
class RenderConfig(Config):
    backend: Literal["auto", "pallas", "xla"] = "auto"
    background_train: Literal["white", "black", "target"] = "target"
    disturb_rate_fg: Optional[float] = 0.5
    disturb_rate_bg: Optional[float] = 0.5
    background_eval: Literal["white", "black", "target"] = "target"
    lighting_type: Literal["constant", "front", "front-range", "SH"] = "SH"
    lighting_space: Literal["world", "camera"] = "world"
    disturb_pool_stride: int = 4
    disturb_impl: Literal["auto", "pairswap", "sample"] = "auto"
    texture_grad_mode: Literal["trilinear", "bilinear", "nearest"] = "trilinear"
    texture_grad_impl: Literal["auto", "pallas", "pallas_bf16", "xla",
                               "xla_fetch"] = "auto"
    max_faces_per_tile: int = 0
    plane_impl: Literal["auto", "pallas", "pallas_interpret", "xla"] = "auto"
    plane_max_list: int = 0
    color_dtype: Literal["auto", "bf16", "f32"] = "auto"
    interp_impl: Literal["auto", "fused", "fused_interpret",
                         "planes"] = "auto"
    bin_mode: Literal["auto", "flat", "dense"] = "auto"
    antialias: bool = True
    pad_to_tiles: bool = True
    layout: Literal["auto", "tiled", "image"] = "auto"

    def __post_init__(self):
        self.check_portable()

    def check_portable(self):
        """Raise on a TPU-only knob set away from what the port carries."""
        for name, allowed in _PORTABLE_ONLY.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"render.{name}={value!r} selects a TPU-only layout or "
                    f"workaround that vhap_tpu_torch does not port; use one "
                    f"of {allowed}")


@dataclass
class LearningRateConfig(Config):
    base: float = 5e-3
    translation: float = 1e-3
    expr: float = 5e-2
    static_offset: float = 5e-4
    dynamic_offset: float = 5e-4
    camera: float = 5e-3
    light: float = 5e-3


@dataclass
class LossWeightConfig(Config):
    landmark: Optional[float] = 10.0
    always_enable_jawline_landmarks: bool = True
    photo: Optional[float] = 30.0

    reg_shape: float = 3e-1
    reg_neck: float = 3e-1
    reg_jaw: float = 3e-1
    reg_eyes: float = 3e-2
    reg_expr: float = 3e-2

    reg_tex_res_clusters: Optional[float] = 1e1
    reg_tex_res_for: Tuple[str, ...] = ("sclerae", "teeth")
    reg_tex_tv: Optional[float] = 1e4
    reg_tex_pca: float = 1e-4

    reg_light: Optional[float] = None
    reg_diffuse: Optional[float] = 1e2

    reg_offset: Optional[float] = 3e2
    reg_offset_relax_coef: float = 1.0
    reg_offset_relax_for: Tuple[str, ...] = ("hair", "ears")

    reg_offset_lap: Optional[float] = 1e6
    reg_offset_lap_relax_coef: float = 0.1
    reg_offset_lap_relax_for: Tuple[str, ...] = ("hair", "ears")

    reg_offset_rigid: Optional[float] = 3e2
    reg_offset_rigid_for: Tuple[str, ...] = ("left_ear", "right_ear", "neck",
                                             "left_eye", "right_eye", "lips_tight")

    reg_offset_dynamic: Optional[float] = 3e5
    blur_iter: int = 0

    smooth_trans: float = 3e2
    smooth_rot: float = 3e1
    smooth_neck: float = 3e1
    smooth_jaw: float = 1e-1
    smooth_eyes: float = 0.0
    smooth_expr: float = 1e0


@dataclass
class LogConfig(Config):
    interval_scalar: Optional[int] = 100
    interval_media: Optional[int] = 500
    image_format: Literal["jpg", "png"] = "jpg"
    view_indices: Tuple[int, ...] = ()
    max_num_views: int = 3
    stack_views_in_rows: bool = True


@dataclass
class ExperimentConfig(Config):
    output_folder: Path = Path("output/track")
    reuse_landmarks: bool = True
    keyframes: Tuple[int, ...] = ()
    photometric: bool = True
    resume_run_state: Optional[Path] = None
    """Resume mid-run from a run_state.npz of a previous (interrupted) run."""
    num_devices: int = 0
    """Devices to shard the batch (frame/camera) axis over, one process
    each (parallel/sharding.py): 0 = every visible CUDA card (1 on the
    CPU); 1 = one process; n > 1 = min(n, available) cards with NCCL, or,
    with `--device cpu`, n gloo processes. Batches are padded with weight-0
    rows and partitioned on axis 0, parameters and Adam's state replicated,
    and the gradients all-reduced before Adam. The reference is single-GPU
    (vhap/config/base.py:329)."""


@dataclass
class StageConfig(Config):
    disable_jawline_landmarks: bool = False


@dataclass
class StageLmkInitRigidConfig(StageConfig):
    num_steps: int = 500
    optimizable_params: Tuple[str, ...] = ("cam", "pose")


@dataclass
class StageLmkInitAllConfig(StageConfig):
    num_steps: int = 500
    optimizable_params: Tuple[str, ...] = ("cam", "pose", "shape", "joints", "expr")


@dataclass
class StageLmkSequentialTrackingConfig(StageConfig):
    num_steps: int = 50
    optimizable_params: Tuple[str, ...] = ("pose", "joints", "expr")


@dataclass
class StageLmkGlobalTrackingConfig(StageConfig):
    num_epochs: int = 30
    optimizable_params: Tuple[str, ...] = ("cam", "pose", "shape", "joints", "expr")


@dataclass
class PhotometricStageConfig(StageConfig):
    align_texture_except: Tuple[str, ...] = ()
    align_boundary_except: Tuple[str, ...] = ("bottomline",)


@dataclass
class StageRgbInitTextureConfig(PhotometricStageConfig):
    num_steps: int = 500
    optimizable_params: Tuple[str, ...] = ("cam", "shape", "texture", "lights")
    align_texture_except: Tuple[str, ...] = ("hair", "boundary", "neck")
    align_boundary_except: Tuple[str, ...] = ("hair", "boundary")


@dataclass
class StageRgbInitAllConfig(PhotometricStageConfig):
    num_steps: int = 500
    optimizable_params: Tuple[str, ...] = ("cam", "pose", "shape", "joints",
                                           "expr", "texture", "lights")
    disable_jawline_landmarks: bool = True
    align_texture_except: Tuple[str, ...] = ("hair", "boundary", "neck")
    align_boundary_except: Tuple[str, ...] = ("hair", "bottomline")


@dataclass
class StageRgbInitOffsetConfig(PhotometricStageConfig):
    num_steps: int = 500
    optimizable_params: Tuple[str, ...] = ("cam", "pose", "shape", "joints",
                                           "expr", "texture", "lights",
                                           "static_offset")
    disable_jawline_landmarks: bool = True
    align_texture_except: Tuple[str, ...] = ("hair", "boundary", "neck")


@dataclass
class StageRgbSequentialTrackingConfig(PhotometricStageConfig):
    num_steps: int = 50
    optimizable_params: Tuple[str, ...] = ("pose", "joints", "expr", "texture",
                                           "dynamic_offset")
    disable_jawline_landmarks: bool = True


@dataclass
class StageRgbGlobalTrackingConfig(PhotometricStageConfig):
    num_epochs: int = 30
    optimizable_params: Tuple[str, ...] = ("cam", "pose", "shape", "joints",
                                           "expr", "texture", "lights",
                                           "static_offset", "dynamic_offset")
    disable_jawline_landmarks: bool = True


@dataclass
class PipelineConfig(Config):
    lmk_init_rigid: StageLmkInitRigidConfig = field(default_factory=StageLmkInitRigidConfig)
    lmk_init_all: StageLmkInitAllConfig = field(default_factory=StageLmkInitAllConfig)
    lmk_sequential_tracking: StageLmkSequentialTrackingConfig = field(
        default_factory=StageLmkSequentialTrackingConfig)
    lmk_global_tracking: StageLmkGlobalTrackingConfig = field(
        default_factory=StageLmkGlobalTrackingConfig)
    rgb_init_texture: StageRgbInitTextureConfig = field(default_factory=StageRgbInitTextureConfig)
    rgb_init_all: StageRgbInitAllConfig = field(default_factory=StageRgbInitAllConfig)
    rgb_init_offset: StageRgbInitOffsetConfig = field(default_factory=StageRgbInitOffsetConfig)
    rgb_sequential_tracking: StageRgbSequentialTrackingConfig = field(
        default_factory=StageRgbSequentialTrackingConfig)
    rgb_global_tracking: StageRgbGlobalTrackingConfig = field(
        default_factory=StageRgbGlobalTrackingConfig)


@dataclass
class BaseTrackingConfig(Config):
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    log: LogConfig = field(default_factory=LogConfig)
    exp: ExperimentConfig = field(default_factory=ExperimentConfig)
    lr: LearningRateConfig = field(default_factory=LearningRateConfig)
    w: LossWeightConfig = field(default_factory=LossWeightConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    begin_stage: Optional[str] = None
    begin_timestep: int = 0
    batch_size: Optional[int] = 16
    async_func: bool = True
    device: Optional[str] = None
    """torch device of the tracker: None = the CUDA card; "cpu" on request."""

    def get_occluded(self):
        occluded_table = {}
        if self.data.sequence in occluded_table:
            logger.info(f"Automatically setting cfg.model.occluded to "
                        f"{occluded_table[self.data.sequence]}")
            self.model.occluded = occluded_table[self.data.sequence]

    def __post_init__(self):
        self.get_occluded()
        if not self.model.use_static_offset and not self.model.use_dynamic_offset:
            # without offsets, boundary alignment of hair is hopeless
            # (vhap/config/base.py:341-342)
            self.model.occluded = tuple(list(self.model.occluded) + ["hair"])

        for cfg_stage in self.pipeline.__dict__.values():
            if isinstance(cfg_stage, PhotometricStageConfig):
                cfg_stage.align_texture_except = tuple(
                    list(cfg_stage.align_texture_except) + list(self.model.occluded))
                cfg_stage.align_boundary_except = tuple(
                    list(cfg_stage.align_boundary_except) + list(self.model.occluded))

        if self.begin_stage is not None:
            if self.begin_stage not in self.pipeline.__dict__:
                raise ValueError(f"begin_stage {self.begin_stage} not found in pipeline")
            for stage, cfg_stage in self.pipeline.__dict__.items():
                if stage != self.begin_stage:
                    cfg_stage.num_steps = 0
                    logger.info(f"Skipping stage: {stage}")
                else:
                    logger.info(f"Starting stage: {stage}")
                    break
