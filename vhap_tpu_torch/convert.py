"""Carry weights and state from the JAX package's form to the port's.

Both packages keep their state in numpy-convertible arrays: parameters in
a flat dict of per-leaf arrays, FLAME constants in a `FlameAssets`-shaped
bundle of numpy arrays, the preprocess networks' weights in a nested
parameter tree (the bundled `assets/*_weights.npz` files hold it). These
helpers take that form (not the JAX
package's types, which this package does not import) so that both sides
compute on identical numbers.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.model.assets import FlameAssets
from vhap_tpu_torch.model.flame import FlameHead
from vhap_tpu_torch.model.masks import FlameMasks
from vhap_tpu_torch.tracker.params import Params

# tracked-run npz key -> parameter leaf (vhap/model/tracker.py:1152-1218)
TRACKED_KEYS = {"rotation": "rotation", "translation": "translation",
                "neck_pose": "neck_pose", "jaw_pose": "jaw_pose",
                "eyes_pose": "eyes_pose", "shape": "shape", "expr": "expr",
                "focal_length": "focal_length", "tex": "tex_pca",
                "tex_extra": "tex_extra", "lights": "lights",
                "static_offset": "static_offset",
                "dynamic_offset": "dynamic_offset"}


def _tree_state(tree: Mapping[str, object], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A preprocess network's parameter tree -> its nn.Module state dict.

    The tree's paths are the module's names: a 4-D leaf is a conv kernel
    (HWIO -> OIHW `.weight`), a `<name>_bias` leaf that conv's `.bias`, a
    `{scale, bias[, mean, var]}` node a norm's weight, bias and running
    statistics; `meta` holds no tensor."""
    state: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if key == "meta":
            continue
        path = prefix + key
        if isinstance(value, Mapping):
            if "scale" in value:
                for src, dst in (("scale", "weight"), ("bias", "bias"),
                                 ("mean", "running_mean"), ("var", "running_var")):
                    if src in value:
                        state[f"{path}.{dst}"] = _f32(value[src])
            else:
                state.update(_tree_state(value, path + "."))
        elif key.endswith("_bias"):
            state[f"{prefix}{key[:-len('_bias')]}.bias"] = _f32(value)
        else:
            w = np.asarray(value)
            if w.ndim != 4:
                raise ValueError(f"{path}: expected an HWIO conv kernel, got shape {w.shape}")
            state[f"{path}.weight"] = _f32(w.transpose(3, 2, 0, 1))
    return state


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _checked_state(params: Mapping[str, object], net: str, meta_keys) -> Dict[str, torch.Tensor]:
    missing = [k for k in meta_keys if k not in params.get("meta", {})]
    if missing:
        raise ValueError(f"not a {net} parameter tree: meta lacks {missing}")
    return _tree_state(params)


def fan_params_to_torch(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A FAN parameter tree in the JAX package's form (numpy, HWIO kernels,
    BN scale/bias/mean/var, meta) -> the state dict of the port's
    `preprocess.fan.FAN` of that meta."""
    return _checked_state(params, "FAN", ("num_modules", "depth", "feats", "num_landmarks"))


def star_params_to_torch(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A STAR parameter tree (as fan_params_to_torch's) -> the state dict of
    the port's `preprocess.star.STAR`."""
    return _checked_state(params, "STAR", ("nstack", "depth", "feats", "num_landmarks"))


def unet_params_to_torch(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A matting U-Net parameter tree -> the state dict of the port's
    `preprocess.matting.UNet`."""
    return _checked_state(params, "matting U-Net", ("base", "levels", "in_ch"))


def params_from_numpy(np_params: Mapping[str, object], device=None) -> Params:
    """A parameter dict of array-likes (e.g. `{k: np.asarray(v)}` of the JAX
    package's params) -> the port's dict of float32 tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in np_params.items()}


def head_from_assets(assets, n_shape: int, n_expr: int,
                     face_clusters: Sequence[str] = (), device=None) -> FlameHead:
    """FLAME assets (any object with FlameAssets' fields, such as the JAX
    package's) -> the port's FlameHead, without mesh surgery."""
    fields = {f: copy.deepcopy(getattr(assets, f))
              for f in FlameAssets.__dataclass_fields__}
    return FlameHead.build(n_shape=n_shape, n_expr=n_expr,
                           assets=FlameAssets(**fields), add_teeth=False,
                           face_clusters=face_clusters, device=device)


def head_from_built_head(head, device=None) -> FlameHead:
    """A FLAME head already built, mesh surgery included (any object with
    the fields of the JAX package's FlameHead: n_shape, n_expr, its arrays,
    `assets` after surgery and `masks` of plain numpy state) -> the port's
    FlameHead with the same buffers and region tables, without running the
    surgery again."""
    a = head.assets
    assets = FlameAssets(**{f: copy.deepcopy(getattr(a, f))
                            for f in FlameAssets.__dataclass_fields__})
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "lbs_weights", "faces", "verts_uvs", "textures_idx"):
        setattr(assets, name, np.array(getattr(head, name)))
    masks = FlameMasks.__new__(FlameMasks)
    masks.__dict__.update(copy.deepcopy(vars(head.masks)))
    return FlameHead(int(head.n_shape), int(head.n_expr), assets, masks,
                     np.array(head.lap_nbr_idx), np.array(head.lap_nbr_w),
                     resolve_device(device))


def params_from_tracked_run(run: Union[str, Path, Mapping[str, object]],
                            device=None) -> Params:
    """A tracked run's `tracked_flame_params_*.npz` (a path, or its arrays)
    -> the port's parameter dict: each leaf the archive holds, as float32
    on `device`; the run's metadata (timestep ids, image size) left out."""
    z = np.load(run) if isinstance(run, (str, Path)) else run
    try:
        return params_from_numpy({leaf: z[key] for key, leaf in TRACKED_KEYS.items()
                                  if key in z}, device)
    finally:
        if hasattr(z, "close"):
            z.close()
