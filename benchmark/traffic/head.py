"""The stand-in FLAME head the benchmark tracks, written as asset files.

FLAME 2023 is license-gated, so the benchmark writes its own head into the
run's asset folder and hands that folder to the tracker
(`model.asset_dir`) and to the plain reference alike:

  head_template_mesh.obj   a latitude-longitude grid of ROWS x COLS = 59 x
                           86 vertices on an ellipsoid of a head's size,
                           5,074 vertices (FLAME: 5,023) and exactly 9,976
                           faces (FLAME: 9,976), with lat-long uvs;
  FLAME_masks.pkl          the loader's geometric part masks of that grid
                           plus the regions mesh surgery needs (the lip
                           rings the teeth are built from, the inner lips,
                           the lower neck and the neck-line points), picked
                           by grid row and column;
  tex_mean_painted.png     a 512 x 512 painted base texture drawn from the
                           seed.

The FLAME model arrays (300 shape and 100 expression blendshapes, pose
correctives, joint regressor, skinning weights) and the landmark embedding
are not written: the asset loader synthesizes them from the template, as
both sides do with their own copy of the loader.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict

import numpy as np
from PIL import Image

ROWS, COLS = 59, 86          # 58 bands x 86 quads x 2 = 9,976 faces
RADII = (0.09, 0.11, 0.09)   # x, y (up), z (front): a head's half-extents, m
LAT_MARGIN = 0.05            # radians kept open at each pole

# surgery regions, by grid row (0 = top) of the 59-row grid
N_RING = 15                  # vertices per lip ring (the teeth's layout)
ROW_LIP_UPPER = 34
ROW_LIP_LOWER = 36
ROW_NECK = 47
ROWS_NECK_LOWER = (49, 50, 51)


def grid_mesh():
    """(verts (V, 3), faces (F, 3), uvs (V, 2)) of the stand-in grid."""
    lats = np.linspace(LAT_MARGIN, np.pi - LAT_MARGIN, ROWS)
    lons = np.linspace(0, 2 * np.pi, COLS, endpoint=False)
    la, lo = np.meshgrid(lats, lons, indexing="ij")
    rx, ry, rz = RADII
    verts = np.stack([rx * np.sin(la) * np.cos(lo), ry * np.cos(la),
                      rz * np.sin(la) * np.sin(lo)], -1).reshape(-1, 3)
    uvs = np.stack([np.broadcast_to(np.arange(COLS) / COLS, (ROWS, COLS)),
                    np.broadcast_to((np.arange(ROWS) / (ROWS - 1))[:, None],
                                    (ROWS, COLS))], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(ROWS - 1), np.arange(COLS), indexing="ij")
    a = i * COLS + j
    b = i * COLS + (j + 1) % COLS
    c = (i + 1) * COLS + j
    d = (i + 1) * COLS + (j + 1) % COLS
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)],
                     2).reshape(-1, 3)
    return verts.astype(np.float32), faces.astype(np.int64), uvs.astype(np.float32)


def write_obj(path: Path, verts, faces, uvs) -> None:
    lines = [f"v {x:.7f} {y:.7f} {z:.7f}" for x, y, z in verts]
    lines += [f"vt {u:.7f} {v:.7f}" for u, v in uvs]
    lines += [f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}" for a, b, c in faces]
    Path(path).write_text("\n".join(lines) + "\n")


def _row(r: int) -> np.ndarray:
    return np.arange(r * COLS, (r + 1) * COLS)


def _front(verts: np.ndarray, ids: np.ndarray, n: int) -> np.ndarray:
    """The n vertices of `ids` nearest the front (+z) by azimuth, ordered
    left (-x) to right (+x)."""
    az = np.abs(np.arctan2(verts[ids, 0], verts[ids, 2]))
    pick = ids[np.argsort(az, kind="stable")[:n]]
    return pick[np.argsort(verts[pick, 0], kind="stable")]


def surgery_regions(verts: np.ndarray) -> Dict[str, np.ndarray]:
    """The regions mesh surgery and export read, on the 59-row grid."""
    upper = _front(verts, _row(ROW_LIP_UPPER), N_RING)
    lower = _front(verts, _row(ROW_LIP_LOWER), N_RING)
    inside = np.concatenate([_front(verts, _row(r), N_RING)
                             for r in range(ROW_LIP_UPPER, ROW_LIP_LOWER + 1)])
    neck = _row(ROW_NECK)
    return {
        "lip_outside_ring_upper": upper,
        "lip_outside_ring_lower": lower,
        "lip_inside": inside,
        "neck_lower": np.concatenate([_row(r) for r in ROWS_NECK_LOWER]),
        "neck_left_point": neck[[np.argmax(verts[neck, 0])]],
        "neck_right_point": neck[[np.argmin(verts[neck, 0])]],
        "front_middle_bottom_point_boundary": _front(verts, neck, 1),
    }


def painted_texture(seed: int, size: int = 512) -> np.ndarray:
    """(size, size, 3) uint8: a skin tone with smooth seeded variation."""
    rng = np.random.default_rng([seed, 1])
    u, v = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size))
    base = np.array([0.78, 0.60, 0.52])
    tex = np.broadcast_to(base, (size, size, 3)).copy()
    for _ in range(6):
        k = rng.uniform(2, 9, size=2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.normal(scale=0.04, size=3)
        tex += amp * np.sin(2 * np.pi * (k[0] * u + k[1] * v) + ph)[..., None]
    return (np.clip(tex, 0, 1) * 255).astype(np.uint8)


def write_assets(asset_dir: Path, seed: int) -> Path:
    """Write the stand-in head's asset files into asset_dir."""
    from reference.model.assets import _synth_part_masks
    asset_dir = Path(asset_dir)
    asset_dir.mkdir(parents=True, exist_ok=True)
    verts, faces, uvs = grid_mesh()
    write_obj(asset_dir / "head_template_mesh.obj", verts, faces, uvs)
    centred = verts - verts.mean(0, keepdims=True)   # as the loader centres it
    masks = {k: np.asarray(m, np.int64) for k, m in
             _synth_part_masks(centred, None).items()}
    masks.update({k: m.astype(np.int64) for k, m in surgery_regions(centred).items()})
    with open(asset_dir / "FLAME_masks.pkl", "wb") as fh:
        pickle.dump(masks, fh)
    Image.fromarray(painted_texture(seed)).save(asset_dir / "tex_mean_painted.png")
    return asset_dir
