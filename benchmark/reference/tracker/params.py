"""Tracked FLAME parameters as a flat dict of tensors.

Counterpart of vhap_tpu/tracker/params.py (reference:
vhap/model/tracker.py:1279-1341): per-frame leaves are (T, ...) tensors
indexed by the batch's timesteps.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference.device import resolve_device
from reference.ops.shading import uniform_sh_lights

Params = Dict[str, torch.Tensor]

# per-frame leaves (first axis = timestep)
PER_FRAME = ("expr", "neck_pose", "jaw_pose", "eyes_pose",
             "translation", "rotation", "dynamic_offset")


def init_params(
    n_timesteps: int,
    n_shape: int,
    n_expr: int,
    n_tex: int,
    num_verts: int,
    tex_resolution: int,
    tex_painted: bool,
    tex_extra: bool,
    lighting_sh: bool,
    use_static_offset: bool,
    use_dynamic_offset: bool,
    calibrated: bool,
    device=None,
) -> Params:
    """Zero-initialized parameter dict (vhap/model/tracker.py:1279-1341)."""
    dev = resolve_device(device)
    T = n_timesteps

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    p: Params = {
        "shape": zeros(n_shape),
        "expr": zeros(T, n_expr),
        "neck_pose": zeros(T, 3),
        "jaw_pose": zeros(T, 3),
        "eyes_pose": zeros(T, 6),
        "translation": zeros(T, 3),
        "rotation": zeros(T, 3),
    }
    if not tex_painted:
        p["tex_pca"] = zeros(n_tex)
    if tex_extra:
        p["tex_extra"] = zeros(3, tex_resolution, tex_resolution)
    if lighting_sh:
        p["lights"] = torch.as_tensor(uniform_sh_lights(), device=dev)
    if use_static_offset:
        p["static_offset"] = zeros(1, num_verts, 3)
    if use_dynamic_offset:
        p["dynamic_offset"] = zeros(T, num_verts, 3)
    if not calibrated:
        # normalized focal length; denormalized by max(h, w) at use site
        # (vhap/model/tracker.py:1335, :153)
        p["focal_length"] = torch.tensor([1.5], dtype=torch.float32, device=dev)
    return p


def slice_batch(params: Params, timesteps: torch.Tensor) -> Params:
    """Gather per-frame leaves at `timesteps`; shared leaves pass through."""
    return {k: (v[timesteps.long()] if k in PER_FRAME else v)
            for k, v in params.items()}
