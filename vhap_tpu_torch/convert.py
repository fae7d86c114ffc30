"""Carry weights and state from the JAX package's form to the port's.

Both packages keep their state in numpy-convertible arrays: parameters in
a flat dict of per-leaf arrays, FLAME constants in a `FlameAssets`-shaped
bundle of numpy arrays. These helpers take that form (not the JAX
package's types, which this package does not import) so that both sides
compute on identical numbers.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Mapping, Sequence, Union

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
