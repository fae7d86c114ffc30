"""A cell's files, found by name, and the tracking configuration they give.

    benchmark/workloads/<cell>.json   config, traffic, chips, limits
    benchmark/configs/<config>.json   the recipe and its sizes, as run
    benchmark/traffic/<traffic>.json  the stage, the loop and its length

A configuration's `tracker` group holds the fields it sets on the recipe's
tracking configuration (nested as the dataclasses nest them); `scene` holds
the capture the benchmark writes (traffic/scene.py). The same fields are
applied to the port's configuration classes and to the reference's copies.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

HERE = Path(__file__).resolve().parent


def load(kind: str, name: str) -> Dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def cell(workload: str, overrides: Optional[Dict] = None) -> Dict:
    """{"name", "workload", "config", "traffic"}; `overrides` (tests only)
    is merged into the three groups by key: {"config": {...}, ...}."""
    w = load("workloads", workload)
    spec = {"name": workload, "workload": w,
            "config": load("configs", w["config"]),
            "traffic": load("traffic", w["traffic"])}
    for group, extra in (overrides or {}).items():
        spec[group] = merge(spec[group], extra)
    return spec


def merge(base: Dict, extra: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _coerce(value: Any, current: Any) -> Any:
    if isinstance(value, list):
        return tuple(value)
    if isinstance(current, Path) and isinstance(value, str):
        return Path(value)
    return value


def apply(obj: Any, fields: Dict) -> None:
    """Set nested fields on a (dataclass) configuration; unknown names raise."""
    for k, v in fields.items():
        if not hasattr(obj, k):
            raise AttributeError(f"{type(obj).__name__} has no field {k!r}")
        cur = getattr(obj, k)
        if isinstance(v, dict) and dataclasses.is_dataclass(cur):
            apply(cur, v)
        else:
            setattr(obj, k, _coerce(v, cur))


def tracking_config(spec: Dict, classes: Dict[str, type], data: Dict,
                    asset_dir: Path, out_dir: Path, device: Optional[str]):
    """The recipe's configuration (`classes[recipe]`) with the cell's fields,
    its data folder, asset folder, output folder and device."""
    c = spec["config"]
    cfg = classes[c["recipe"]]()
    apply(cfg, c["tracker"])
    sc = c["scene"]
    if sc["layout"] == "rig":      # the calibration size and downsampling written
        data = {**data, "image_size_during_calibration": sc["image_size_calibration"],
                "n_downsample_rgb": sc["n_downsample"]}
    apply(cfg, {"data": data, "model": {"asset_dir": str(asset_dir)},
                "exp": {"output_folder": str(out_dir)}, "device": device})
    for stage, steps in spec["traffic"].get("pipeline", {}).items():
        apply(cfg.pipeline, {stage: steps})
    return cfg


def n_timesteps(spec: Dict) -> int:
    """Timesteps the scene holds: the traffic's batches of the config's
    batch (one timestep a batch for a rig, whose batch is its views)."""
    t = spec["traffic"]
    if spec["config"]["scene"]["layout"] == "rig":
        return t["batches"]
    return t["batches"] * spec["config"]["tracker"]["batch_size"]
