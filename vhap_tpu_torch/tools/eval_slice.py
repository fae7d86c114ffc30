"""The tracker's evaluation step, set up as the bench sets it up.

Defaults are the bench's full width (bench.py:101-171): batch 16, 512x512,
texture 2048, n_shape=300, n_expr=100, SH lighting, antialias, residual
texture and static offset, on the FLAME asset loader's head. The targets
are rendered from perturbed parameters and composited on white; every
random number comes from one numpy seed. Used by chip_smoke.py and
tools/profile_eval.py, and by tools/train_slice.py for the train step's
scene; the tests build it at a tiny size on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from vhap_tpu_torch.config.base import BaseTrackingConfig
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.model.assets import load_flame_assets
from vhap_tpu_torch.model.flame import FlameHead, FlameTexPainted
from vhap_tpu_torch.tracker import params as P
from vhap_tpu_torch.tracker.energy import make_albedo_fn, make_energy_fn

N_TIMESTEPS = 64            # frames in the parameter store (bench.py:115)


@dataclass
class EvalSlice:
    cfg: BaseTrackingConfig
    head: FlameHead
    params: P.Params
    batch: Dict[str, torch.Tensor]
    image_size: Tuple[int, int]
    get_albedo: Callable     # params -> (1, 3, T, T) albedo
    make_energy: Callable    # use_kernels -> energy(params, batch)


def build_eval_slice(device=None, batch_size: int = 16,
                     image_size: Tuple[int, int] = (512, 512),
                     tex_res: int = 2048, n_shape: int = 300,
                     n_expr: int = 100, seed: int = 0) -> EvalSlice:
    dev = resolve_device(device)
    H, W = image_size
    B = batch_size
    cfg = BaseTrackingConfig()
    cfg.model.n_shape, cfg.model.n_expr = n_shape, n_expr
    cfg.model.tex_resolution = tex_res
    cfg.model.use_static_offset = True
    cfg.batch_size = B
    assets = load_flame_assets(seed=seed)
    head = FlameHead.build(n_shape=n_shape, n_expr=n_expr, assets=assets,
                           add_teeth=False, face_clusters=cfg.model.tex_clusters,
                           device=dev)
    get_albedo = make_albedo_fn(
        cfg, FlameTexPainted(assets.tex_painted, tex_res, device=dev), None)
    params = P.init_params(N_TIMESTEPS, n_shape, n_expr, cfg.model.n_tex,
                           head.num_verts, tex_res, True, True, True, True,
                           False, False, device=dev)
    rng = np.random.default_rng(seed)

    def noise(shape, scale):
        return torch.as_tensor(rng.normal(0.0, scale, shape).astype(np.float32),
                               device=dev)

    # a textured residual and off-white light make every texel and SH band
    # count in the comparisons
    params["tex_extra"] = noise(params["tex_extra"].shape, 0.05)
    params["lights"] = params["lights"] + noise((9, 3), 0.05)
    batch = {
        "rgb": torch.zeros((B, H, W, 3), device=dev),
        "lmk2d": torch.zeros((B, head.lmk_faces_idx.shape[0], 3), device=dev),
        "timestep_index": torch.arange(B, device=dev) % N_TIMESTEPS,
        "weight": torch.ones(B, device=dev),
    }

    def make_energy(use_kernels: bool = True):
        return make_energy_fn(head, cfg, get_albedo, (H, W), N_TIMESTEPS, None,
                              with_aux=True, device=dev, use_kernels=use_kernels)

    gt_params = dict(params)
    for name, scale in (("expr", 0.3), ("rotation", 0.1), ("jaw_pose", 0.05),
                        ("translation", 0.01)):          # bench.py:156-159
        gt_params[name] = gt_params[name] + noise(gt_params[name].shape, scale)
    with torch.no_grad():
        _, (_, aux) = make_energy()(gt_params, batch)
    alpha = aux["pred_alpha"]
    batch["rgb"] = aux["pred_rgb"] * alpha + (1.0 - alpha)   # on white
    xy = aux["pred_lmk2d"]
    batch["lmk2d"] = torch.cat([(xy[..., :1] * W + W) / 2,
                                (xy[..., 1:] * H + H) / 2,
                                torch.ones_like(xy[..., :1])], -1)
    return EvalSlice(cfg, head, params, batch, (H, W), get_albedo, make_energy)
