"""Tracked FLAME parameters as a flat dict of tensors.

Counterpart of vhap_tpu/tracker/params.py (reference:
vhap/model/tracker.py:1279-1341): per-frame leaves are (T, ...) tensors
indexed by the batch's timesteps. Saved and loaded in the reference npz
schema (tracked_flame_params_*.npz, vhap/model/tracker.py:1152-1218), so
archives are interchangeable with the JAX package's and the original
pipeline's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.ops.shading import uniform_sh_lights
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

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


def copy_forward(params: Params, t_src: int, t_targets) -> Params:
    """Warm-start: copy frame t_src's params into t_targets
    (initialize_next_timtestep, vhap/model/tracker.py:1515-1529). Returns a
    new dict; the input tensors are not modified."""
    out = dict(params)
    for k in PER_FRAME:
        if k in out:
            v = out[k].clone()
            v[torch.as_tensor(t_targets, device=v.device).long()] = v[t_src].clone()
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Reference-schema npz checkpointing
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_result(params: Params, out_path: Path, timestep_ids, n_processed,
                image_size, calibrated: bool, tex_painted: bool) -> Path:
    """Write tracked_flame_params npz (vhap/model/tracker.py:1152-1218)."""
    export = {k: _np(params[k]) for k in
              ("rotation", "translation", "neck_pose", "jaw_pose",
               "eyes_pose", "shape", "expr")}
    export.update(timestep_id=np.asarray(timestep_ids),
                  n_processed_frames=np.asarray(n_processed),
                  image_size=np.asarray(image_size))
    if not calibrated and "focal_length" in params:
        export["focal_length"] = _np(params["focal_length"])
    if not tex_painted and "tex_pca" in params:
        export["tex"] = _np(params["tex_pca"])
    for k in ("tex_extra", "lights", "static_offset", "dynamic_offset"):
        if k in params:
            export[k] = _np(params[k])
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **export)
    return out_path


def load_from_tracked_flame_params(params: Params, fp: Path) -> Params:
    """Warm-start from a reference-schema npz
    (vhap/model/tracker.py:79-129). Leaves missing from the archive keep
    their current values; per-frame arrays are loaded up to min length."""
    out = dict(params)
    with np.load(fp) as report:

        def load_full(key, npz_key):
            if key in out and npz_key in report:
                arr = np.asarray(report[npz_key], np.float32)
                if tuple(out[key].shape) == arr.shape:
                    out[key] = torch.as_tensor(arr, device=out[key].device)
                else:
                    logger.warning(f"shape mismatch for {key}: "
                                   f"{tuple(out[key].shape)} vs {arr.shape}")

        def load_per_frame(key, npz_key):
            if key in out and npz_key in report:
                arr = np.asarray(report[npz_key], np.float32)
                n = min(out[key].shape[0], arr.shape[0])
                v = out[key].clone()
                v[:n] = torch.as_tensor(arr[:n], device=v.device)
                out[key] = v

        for k in ("rotation", "translation", "neck_pose", "jaw_pose",
                  "eyes_pose", "expr"):
            load_per_frame(k, k)
        load_full("shape", "shape")
        load_full("lights", "lights")
        load_full("focal_length", "focal_length")
        load_full("tex_pca", "tex")
        load_full("tex_extra", "tex_extra")
        load_full("static_offset", "static_offset")
        load_per_frame("dynamic_offset", "dynamic_offset")
        for k in ("tex_extra", "static_offset"):
            if k in out and k not in report:
                logger.warning(f"No {k} found in flame_params!")
    return out
