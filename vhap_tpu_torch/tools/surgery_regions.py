"""The FLAME regions mesh surgery and export read, on the synthetic head.

The asset loader's stand-in head (a UV sphere of 48 latitude rows x 64
longitude columns, 3,072 vertices) has none of the FLAME regions whose
indices exceed its vertex count (model/masks.py drops them): the lip rings
add_teeth builds the teeth from, the inner lips, the lower neck, and the
three neck points export's tilted neck-line mask is drawn through. Without
them `FlameHead.build(add_teeth=True)` raises KeyError.

`with_surgery_regions(assets)` returns a copy of the assets whose
`part_masks` also hold those regions, picked deterministically from the
head's own vertices (front = +z, up = +y):

  lip_outside_ring_upper / _lower   15 ordered vertices each (left to
        right), on the front of the head below its middle, the upper ring
        two rows above the lower;
  lip_inside                        the rings and the row between them
        (56 faces: remove_lip_inside opens a mouth there);
  neck_lower                        rows 40-42 (into the top of the
        stand-in's `boundary`, the bottom 15 % of its vertices);
  neck_left_point / neck_right_point  one vertex each on the head's +x and
        -x sides, at the neck line's height;
  front_middle_bottom_point_boundary  the front vertex of the same row;

The torso's `boundary` region is the stand-in's own.

Any FlameHead.build that takes `assets=` accepts the result unchanged.
`write_region_assets(dir)` writes the stand-in's part masks with these
regions as the asset folder's FLAME_masks.pkl, so that a run given
`--model.asset_dir dir` (the tracker, export) builds the teeth head through
the asset loader's own path; the rest of the head is synthesized as
without the folder. It is a test and smoke aid: real FLAME assets carry
these regions already.
"""

from __future__ import annotations

import copy
import pickle
from pathlib import Path
from typing import Dict, List

import numpy as np

N_RING = 15                 # vertices per lip ring (add_teeth's layout)
ROW_LIP_UPPER = 28          # latitude rows of the 48-row stand-in (0 = top)
ROW_LIP_LOWER = 30
ROW_NECK = 38
ROWS_NECK_LOWER = (40, 41, 42)


def _rows(v: np.ndarray) -> List[np.ndarray]:
    """Vertex ids grouped into rows of equal height, top row first."""
    y = np.round(v[:, 1], 6)
    levels = np.unique(y)[::-1]
    return [np.flatnonzero(y == lv) for lv in levels]


def _front(v: np.ndarray, ids: np.ndarray, n: int) -> np.ndarray:
    """The n vertices of `ids` nearest the front (+z) by azimuth, ordered
    left (-x) to right (+x)."""
    az = np.abs(np.arctan2(v[ids, 0], v[ids, 2]))
    pick = ids[np.argsort(az, kind="stable")[:n]]
    return pick[np.argsort(v[pick, 0], kind="stable")]


def surgery_regions(v_template: np.ndarray) -> Dict[str, np.ndarray]:
    """The regions above for a head of latitude rows (the stand-in)."""
    v = np.asarray(v_template, np.float64)
    rows = _rows(v)
    if len(rows) <= max(ROWS_NECK_LOWER) + 2:
        raise ValueError(f"{len(rows)} vertex rows: not the synthetic stand-in "
                         "head these regions are picked from")
    upper = _front(v, rows[ROW_LIP_UPPER], N_RING)
    lower = _front(v, rows[ROW_LIP_LOWER], N_RING)
    inside = np.concatenate([_front(v, rows[r], N_RING)
                             for r in range(ROW_LIP_UPPER, ROW_LIP_LOWER + 1)])
    neck = rows[ROW_NECK]
    return {
        "lip_outside_ring_upper": upper,
        "lip_outside_ring_lower": lower,
        "lip_inside": inside,
        "neck_lower": np.concatenate([rows[r] for r in ROWS_NECK_LOWER]),
        "neck_left_point": neck[[np.argmax(v[neck, 0])]],
        "neck_right_point": neck[[np.argmin(v[neck, 0])]],
        "front_middle_bottom_point_boundary": _front(v, neck, 1),
    }


def with_surgery_regions(assets):
    """A copy of `assets` (FlameAssets of either package) whose part_masks
    also hold the surgery and export regions."""
    out = copy.copy(assets)
    masks = {k: np.array(m) for k, m in assets.part_masks.items()}
    masks.update({k: m.astype(np.int64) for k, m in
                  surgery_regions(assets.v_template).items()})
    out.part_masks = masks
    return out


def write_region_assets(asset_dir, seed: int = 0) -> Path:
    """Write `asset_dir`/FLAME_masks.pkl: the synthetic head's part masks
    (load_flame_assets without files, `seed`) with the regions above."""
    from vhap_tpu_torch.model.assets import _ASSET_FILES, load_flame_assets
    asset_dir = Path(asset_dir)
    asset_dir.mkdir(parents=True, exist_ok=True)
    a = with_surgery_regions(load_flame_assets(asset_dir / "none", seed=seed))
    path = asset_dir / _ASSET_FILES["parts"]
    with open(path, "wb") as fh:
        pickle.dump(a.part_masks, fh)
    return path
