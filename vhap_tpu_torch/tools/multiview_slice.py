"""The calibrated multiview train step of bench.py's metric 3, on a
NeRSemble rig, with the teeth head.

One `rgb_sequential_tracking` step of BaseTrackingConfig (render -> energy
with the stage's regularizers and the cluster disturbance -> backward ->
leaf-lr Adam; pose, joints, expression and the texture optimized) on all
views of one timestep, as bench.py:227-286 sets it up (calibrated, one
timestep x all views per batch, static offset), plus the teeth head that
NeRSemble tracking builds by default. Full width by default: 16 calibrated
cameras on an arc at 512x512, texture 2048, n_shape=300, n_expr=100.
track_nersemble's own sequential step (NersembleTrackingConfig) freezes the
texture; chip_smoke.py runs that one through the tracker.

`write_rig` renders the rig with tools/make_synthetic_multiview.py (the
teeth head of tools/surgery_regions.py with its inner lips removed, so that
the teeth show through the mouth; per-camera affine colour correction);
`build_multiview_slice` reads it through the port's NeRSembleDataset and
returns a TrainSlice whose parameters start from the rig's ground truth,
perturbed from a numpy seed. Used by chip_smoke.py; the tests build it at a
small size. Under a process group of n ranks (parallel/sharding.py) the
step's batch is this rank's block of the views padded to a multiple of n
(weight-0 rows), loaded alone, as the tracker shards a timestep.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from vhap_tpu_torch.config.base import BaseTrackingConfig
from vhap_tpu_torch.config.nersemble import NersembleDataConfig
from vhap_tpu_torch.data.nersemble_dataset import NeRSembleDataset
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.model.flame import FlameHead, FlameTexPainted
from vhap_tpu_torch.parallel import sharding
from vhap_tpu_torch.tools.eval_slice import EvalSlice
from vhap_tpu_torch.tools.make_synthetic_multiview import generate_multiview
from vhap_tpu_torch.tools.surgery_regions import write_region_assets
from vhap_tpu_torch.tools.train_slice import STAGE, TrainSlice
from vhap_tpu_torch.tracker import params as P
from vhap_tpu_torch.tracker.energy import make_albedo_fn, make_energy_fn
from vhap_tpu_torch.tracker.optim import leaf_learning_rates, stage_optimizable_leaves

SUBJECT, SEQUENCE = "001", "SEN-01"
TIMESTEP, SEED = 0, 0       # the timestep the step fits; the perturbation's seed


def write_rig(root, n_cams: int = 16, n_frames: int = 4, size=512,
              n_shape: int = 300, n_expr: int = 100, seed: int = 0,
              device=None):
    """Render the rig under root/data with the teeth head whose regions
    root/assets holds (inner lips removed: track it with
    --model.remove-lip-inside). Returns (ground truth, camera ids)."""
    root = Path(root)
    write_region_assets(root / "assets")
    head = FlameHead.build(n_shape=n_shape, n_expr=n_expr,
                           asset_dir=root / "assets", remove_lip_inside=True,
                           device=device)
    return generate_multiview(root / "data", SUBJECT, SEQUENCE, n_cams=n_cams,
                              n_frames=n_frames, size=size, seed=seed, head=head,
                              color_correction=True)


def slice_config(root, n_shape: int = 300, n_expr: int = 100,
                 tex_res: int = 2048) -> BaseTrackingConfig:
    """bench.py's metric-3 config (BaseTrackingConfig, calibrated, static
    offset; build_multiview_slice sets the batch to all views) on the rig
    of `write_rig`, whose cameras are written in the converted convention
    (no axis alignment)."""
    root = Path(root)
    cfg = BaseTrackingConfig()
    cfg.data = NersembleDataConfig(root_folder=root / "data", subject=SUBJECT,
                                   sequence=SEQUENCE, align_cameras_to_axes=False)
    cfg.model.n_shape, cfg.model.n_expr = n_shape, n_expr
    cfg.model.tex_resolution = tex_res
    cfg.model.use_static_offset = True
    cfg.model.asset_dir = root / "assets"
    cfg.model.remove_lip_inside = True
    cfg.__post_init__()
    return cfg


def build_multiview_slice(root, device=None, n_shape: int = 300,
                          n_expr: int = 100, tex_res: int = 2048,
                          stage: str = STAGE) -> TrainSlice:
    """The step on timestep TIMESTEP of the rig at `root` (write_rig), on
    this process's rank."""
    dev = resolve_device(device)
    cfg = slice_config(root, n_shape, n_expr, tex_res)
    head = FlameHead.build(n_shape=n_shape, n_expr=n_expr,
                           asset_dir=cfg.model.asset_dir,
                           face_clusters=cfg.model.tex_clusters,
                           remove_lip_inside=True, device=dev)
    get_albedo = make_albedo_fn(
        cfg, FlameTexPainted(head.assets.tex_painted, tex_res, device=dev), None)
    ds = NeRSembleDataset(cfg.data, img_to_tensor=True)
    n = cfg.batch_size = ds.num_cameras
    rows = sharding.shard_padded({"view": np.arange(n), "weight": np.ones(n, np.float32)})
    item = ds.getitem_by_timestep(TIMESTEP, rows["view"])
    image_size: Tuple[int, int] = tuple(item["rgb"].shape[1:3])

    def on_dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    batch = {k: on_dev(item[k]) for k in ("rgb", "lmk2d", "intrinsic", "extrinsic")}
    batch["timestep_index"] = torch.full((len(rows["view"]),), TIMESTEP,
                                         dtype=torch.int32, device=dev)
    batch["weight"] = on_dev(rows["weight"])

    T = ds.num_timesteps
    params = P.init_params(T, n_shape, n_expr, cfg.model.n_tex, head.num_verts,
                           tex_res, cfg.model.tex_painted, cfg.model.tex_extra,
                           True, cfg.model.use_static_offset,
                           cfg.model.use_dynamic_offset, True, device=dev)
    rng = np.random.default_rng(SEED)
    with np.load(Path(ds.sequence_path) / "gt_params.npz") as gt:
        params["shape"] = on_dev(gt["shape"])
        for name, scale in (("expr", 0.1), ("rotation", 0.02),
                            ("jaw_pose", 0.02), ("translation", 0.005)):
            params[name] = on_dev(gt[name] + rng.normal(0, scale, gt[name].shape))
    params["tex_extra"] = on_dev(rng.normal(0, 0.05, params["tex_extra"].shape))
    params["lights"] = params["lights"] + on_dev(rng.normal(0, 0.05, (9, 3)))
    params["static_offset"] = on_dev(rng.normal(0, 1e-3, params["static_offset"].shape))

    def make_eval_energy(use_kernels: bool = True):
        return make_energy_fn(head, cfg, get_albedo, image_size, T, None,
                              with_aux=True, device=dev, use_kernels=use_kernels)

    def make_energy(use_kernels: bool = True, disturb: bool = True):
        c = cfg
        if not disturb:
            c = copy.deepcopy(cfg)
            c.render.disturb_rate_fg = c.render.disturb_rate_bg = None
        return make_energy_fn(head, c, get_albedo, image_size, T, stage,
                              with_aux=False, device=dev, use_kernels=use_kernels)

    s = EvalSlice(cfg, head, params, batch, image_size, get_albedo, make_eval_energy)
    return TrainSlice(s, stage, stage_optimizable_leaves(cfg, stage, params),
                      leaf_learning_rates(cfg), make_energy)
