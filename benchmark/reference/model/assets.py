"""FLAME asset loading and synthesis.

The FLAME 2023 model files (flame2023.pkl, FLAME_masks.pkl, FLAME_texture.npz)
are license-gated by MPI and must be supplied by the user; the remaining
assets (head_template_mesh.obj, landmark_embedding_with_eyes.npy,
uv_masks.npz, tex_mean_painted.png) ship with the reference distribution.

This module
  * decodes the FLAME pickle without requiring chumpy (handles chumpy
    arrays, scipy sparse matrices and plain ndarrays),
  * parses the template OBJ (verts + UVs + faces), replacing
    pytorch3d.io.load_obj used at vhap/model/flame.py:149,
  * synthesizes statistically-plausible stand-ins for any missing
    license-gated file so that tests and benchmarks run with the *real*
    tensor shapes (V=5023, F=9976, 300 shape + 100 expr basis, 5 joints).

Asset search order: explicit path argument, $VHAP_TPU_ASSET_DIR,
./asset/flame.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from reference.util.log import get_logger

logger = get_logger(__name__)

TOPOLOGY_NPZ = Path(__file__).resolve().parents[1] / "assets" / "flame_topology.npz"

# Standard FLAME part-mask names (contents of FLAME_masks.pkl, see
# vhap/model/flame.py:761-765).

_ASSET_FILES = {
    "model": "flame2023.pkl",
    "parts": "FLAME_masks.pkl",
    "lmk": "landmark_embedding_with_eyes.npy",
    "mesh": "head_template_mesh.obj",
    "tex_space": "FLAME_texture.npz",
    "tex_painted": "tex_mean_painted.png",
    "uv_masks": "uv_masks.npz",
}


def default_asset_dir() -> Optional[Path]:
    candidates = []
    env = os.environ.get("VHAP_TPU_ASSET_DIR")
    if env:
        candidates.append(Path(env))
    candidates.append(Path("asset/flame"))
    for c in candidates:
        if c.is_dir():
            return c
    return None


# ---------------------------------------------------------------------------
# Decoders
# ---------------------------------------------------------------------------

def _to_np(x, dtype=np.float64) -> np.ndarray:
    """Convert chumpy arrays / scipy sparse / ndarray to a dense ndarray.

    Mirrors the intent of vhap/model/flame.py:52-55 without importing chumpy:
    chumpy `Ch` objects expose `.r` (the evaluated ndarray).
    """
    if hasattr(x, "todense"):  # scipy sparse
        x = np.asarray(x.todense())
    if hasattr(x, "r") and not isinstance(x, np.ndarray):  # chumpy
        x = np.asarray(x.r)
    return np.asarray(x, dtype=dtype)


class _ChumpyShim:
    """Unpickle stand-in for chumpy objects: keeps raw state for `.r` access."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @property
    def r(self):
        for key in ("x", "a", "v"):
            if key in self.__dict__:
                return np.asarray(self.__dict__[key])
        raise ValueError("cannot evaluate chumpy object without chumpy installed")


class _FlameUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShim
        return super().find_class(module, name)


def decode_flame_pkl(path: Path) -> dict:
    """Load a FLAME model pickle into a dict of dense float64 ndarrays."""
    with open(path, "rb") as f:
        raw = _FlameUnpickler(f, encoding="latin1").load()
    out = {}
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights"):
        out[k] = _to_np(raw[k])
    out["kintree_table"] = np.asarray(_to_np(raw["kintree_table"], dtype=np.int64),
                                      dtype=np.int64)
    return out


def parse_obj(path: Path):
    """Minimal OBJ parser: vertices, faces (0-based), UV verts, UV faces.

    Replaces pytorch3d.io.load_obj (vhap/model/flame.py:149). Supports
    `v`, `vt`, and `f a/b` or `f a/b/c` or `f a` face tokens, triangles only.
    """
    verts, uvs, faces_v, faces_vt = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(t) for t in line.split()[1:3]])
            elif line.startswith("f "):
                toks = line.split()[1:]
                assert len(toks) == 3, "triangle meshes only"
                fv, fvt = [], []
                for t in toks:
                    parts = t.split("/")
                    fv.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        fvt.append(int(parts[1]) - 1)
                faces_v.append(fv)
                if fvt:
                    faces_vt.append(fvt)
    return (
        np.asarray(verts, dtype=np.float32),
        np.asarray(faces_v, dtype=np.int32),
        np.asarray(uvs, dtype=np.float32) if uvs else None,
        np.asarray(faces_vt, dtype=np.int32) if faces_vt else None,
    )


def load_topology_tables() -> Dict[str, np.ndarray]:
    """Load the committed FLAME topology tables (region indices, teeth faces)."""
    with np.load(TOPOLOGY_NPZ) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# Asset bundle
# ---------------------------------------------------------------------------

@dataclass
class FlameAssets:
    """Raw numpy arrays backing a FlameHead. Shapes follow FLAME 2023."""

    v_template: np.ndarray        # (V, 3)
    shapedirs: np.ndarray         # (V, 3, 300 shape + 100 expr) full basis
    posedirs: np.ndarray          # (V, 3, P) with P = 36 (4 joints x 9)
    J_regressor: np.ndarray       # (J, V), J = 5
    parents: np.ndarray           # (J,), parents[0] = -1
    lbs_weights: np.ndarray       # (V, J)
    faces: np.ndarray             # (F, 3) int
    verts_uvs: np.ndarray         # (Vt, 2)
    textures_idx: np.ndarray      # (F, 3) int, indexes verts_uvs
    lmk_faces_idx: np.ndarray     # (L,) int
    lmk_bary_coords: np.ndarray   # (L, 3)
    part_masks: Dict[str, np.ndarray]         # region name -> vertex ids
    tex_mean: Optional[np.ndarray] = None     # (512*512*3,) PCA texture mean
    tex_basis: Optional[np.ndarray] = None    # (512*512*3, 200) PCA basis
    tex_painted: Optional[np.ndarray] = None  # (H, W, 3) uint8
    uv_masks: Dict[str, np.ndarray] = field(default_factory=dict)  # name -> (2048,2048) bool
    synthetic_parts: tuple = ()   # which pieces were synthesized

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]


# ---------------------------------------------------------------------------
# Synthesis of missing license-gated pieces
# ---------------------------------------------------------------------------

def _synth_model_arrays(v_template: np.ndarray, rng: np.random.Generator) -> dict:
    """Synthesize FLAME-shaped model arrays anchored on a real template mesh.

    Blendshape magnitudes are matched to published FLAME statistics order
    (mm-scale displacements for unit coefficients); joints are placed at
    anatomically-plausible template locations so the kinematic chain bends
    sensibly in tests.
    """
    V = v_template.shape[0]
    J = 5
    # Smooth random blendshapes: random low-frequency fields over the mesh.
    def smooth_field(n_basis, scale):
        # random directions modulated by random 3D plane waves -> spatially smooth
        k = rng.normal(size=(8, 3)) * 20.0
        amps = rng.normal(size=(8, n_basis, 3)) * scale / np.sqrt(8)
        phase = v_template @ k.T  # (V, 8)
        field = np.einsum("vw,wbc->vcb", np.sin(phase), amps)
        field += np.einsum("vw,wbc->vcb", np.cos(phase), amps[::-1])
        return field  # (V, 3, n_basis)

    shapedirs = smooth_field(400, 0.001)
    posedirs = smooth_field(36, 0.0005)

    # Joint locations: global(head center), neck(below), jaw, left eye, right eye.
    center = v_template.mean(0)
    ymin, ymax = v_template[:, 1].min(), v_template[:, 1].max()
    zmax = v_template[:, 2].max()
    joints = np.stack([
        center,
        center + np.array([0.0, (ymin - center[1]) * 0.6, 0.0]),
        center + np.array([0.0, (ymin - center[1]) * 0.3, (zmax - center[2]) * 0.3]),
        center + np.array([-0.03, 0.02, (zmax - center[2]) * 0.5]),
        center + np.array([0.03, 0.02, (zmax - center[2]) * 0.5]),
    ])
    # J_regressor: softmax over negative distance to each joint (sparse-ish).
    d = np.linalg.norm(v_template[None, :, :] - joints[:, None, :], axis=-1)  # (J, V)
    w = np.exp(-(d / 0.01) ** 2)
    w_sum = w.sum(1, keepdims=True)
    # guard degenerate rows
    w = np.where(w_sum > 1e-12, w / np.maximum(w_sum, 1e-12), 1.0 / V)
    J_regressor = w

    # LBS weights: distance-based soft assignment, mostly root.
    d_v = d.T  # (V, J)
    lbs = np.exp(-(d_v / 0.05) ** 2)
    lbs[:, 0] += 0.3
    lbs_weights = lbs / lbs.sum(1, keepdims=True)

    parents = np.array([-1, 0, 1, 1, 1], dtype=np.int64)
    return dict(shapedirs=shapedirs, posedirs=posedirs, J_regressor=J_regressor,
                lbs_weights=lbs_weights, parents=parents)


def _synth_part_masks(v_template: np.ndarray, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Heuristic geometric part masks when FLAME_masks.pkl is unavailable."""
    v = v_template
    V = v.shape[0]
    y, z, x = v[:, 1], v[:, 2], v[:, 0]
    yq = np.quantile(y, [0.15, 0.3, 0.55, 0.8])
    zq = np.quantile(z, [0.5, 0.7])
    ids = np.arange(V)
    masks = {
        "boundary": ids[y < yq[0]],
        "neck": ids[(y >= yq[0]) & (y < yq[1])],
        "face": ids[(y >= yq[1]) & (z > zq[0])],
        "scalp": ids[(y >= yq[2]) & (z <= zq[1])],
        "forehead": ids[(y >= yq[3]) & (z > zq[0])],
        "nose": ids[(z > np.quantile(z, 0.97))],
        "lips": ids[(z > zq[1]) & (y > yq[1]) & (y < yq[2])],
        "left_ear": ids[x < np.quantile(x, 0.02)],
        "right_ear": ids[x > np.quantile(x, 0.98)],
    }
    eye_c_l = np.array([-0.03, 0.04, 0.08])
    eye_c_r = np.array([0.03, 0.04, 0.08])
    center = v.mean(0)
    dl = np.linalg.norm(v - (center + eye_c_l), axis=1)
    drr = np.linalg.norm(v - (center + eye_c_r), axis=1)
    masks["left_eyeball"] = ids[dl < 0.012]
    masks["right_eyeball"] = ids[drr < 0.012]
    masks["left_eye_region"] = ids[dl < 0.025]
    masks["right_eye_region"] = ids[drr < 0.025]
    masks["eye_region"] = np.union1d(masks["left_eye_region"], masks["right_eye_region"])
    # ensure no mask is empty
    for k, m in masks.items():
        if len(m) == 0:
            masks[k] = ids[:1]
    return masks


def _synth_lmk_embedding(faces: np.ndarray, rng: np.random.Generator, n_lmk: int = 70):
    lmk_faces = rng.integers(0, faces.shape[0], size=(n_lmk,))
    bary = rng.dirichlet(np.ones(3), size=(n_lmk,)).astype(np.float64)
    return lmk_faces.astype(np.int64), bary


def load_flame_assets(
    asset_dir: Optional[Path] = None,
    allow_synthetic: bool = True,
    seed: int = 0,
) -> FlameAssets:
    """Load FLAME assets, synthesizing any missing license-gated pieces.

    With a fully-populated asset dir this reproduces the reference's inputs
    (vhap/model/flame.py:37-44). With only the freely-distributable files
    (template OBJ, landmark embedding, painted texture, uv masks) present,
    the model basis / part masks are synthesized at real FLAME shapes.
    """
    asset_dir = Path(asset_dir) if asset_dir is not None else default_asset_dir()
    rng = np.random.default_rng(seed)
    synthetic = []

    # --- template mesh (required; synthesized sphere as last resort) ---
    mesh_path = asset_dir / _ASSET_FILES["mesh"] if asset_dir else None
    if mesh_path is not None and mesh_path.exists():
        v_template_obj, faces, verts_uvs, textures_idx = parse_obj(mesh_path)
    else:
        if not allow_synthetic:
            raise FileNotFoundError("head_template_mesh.obj not found")
        synthetic.append("mesh")
        v_template_obj, faces, verts_uvs, textures_idx = _synth_sphere_mesh(rng)

    # --- model pickle ---
    model_path = asset_dir / _ASSET_FILES["model"] if asset_dir else None
    if model_path is not None and model_path.exists():
        m = decode_flame_pkl(model_path)
        v_template = m["v_template"].astype(np.float32)
        shapedirs = m["shapedirs"].astype(np.float32)
        num_pose_basis = m["posedirs"].shape[-1]
        posedirs = m["posedirs"].astype(np.float32)
        J_regressor = m["J_regressor"].astype(np.float32)
        parents = m["kintree_table"][0].copy()
        parents[0] = -1
        lbs_weights = m["weights"].astype(np.float32)
    else:
        if not allow_synthetic:
            raise FileNotFoundError("flame2023.pkl not found")
        synthetic.append("model")
        # the shipped template OBJ places the head ~1.5m up (body coords);
        # the real pkl's v_template is origin-centered — match that here
        v_template = v_template_obj - v_template_obj.mean(0, keepdims=True)
        s = _synth_model_arrays(v_template.astype(np.float64), rng)
        shapedirs = s["shapedirs"].astype(np.float32)
        posedirs = s["posedirs"].astype(np.float32)
        J_regressor = s["J_regressor"].astype(np.float32)
        parents = s["parents"]
        lbs_weights = s["lbs_weights"].astype(np.float32)

    # --- landmark embedding ---
    lmk_path = asset_dir / _ASSET_FILES["lmk"] if asset_dir else None
    if lmk_path is not None and lmk_path.exists():
        lmk = np.load(lmk_path, allow_pickle=True, encoding="latin1")[()]
        lmk_faces_idx = np.asarray(lmk["full_lmk_faces_idx"], dtype=np.int64).reshape(-1)
        lmk_bary_coords = np.asarray(lmk["full_lmk_bary_coords"], dtype=np.float32).reshape(-1, 3)
    else:
        if not allow_synthetic:
            raise FileNotFoundError("landmark embedding not found")
        synthetic.append("lmk")
        lmk_faces_idx, lmk_bary_coords = _synth_lmk_embedding(faces, rng)
        lmk_bary_coords = lmk_bary_coords.astype(np.float32)

    # --- part masks ---
    parts_path = asset_dir / _ASSET_FILES["parts"] if asset_dir else None
    if parts_path is not None and parts_path.exists():
        with open(parts_path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
        part_masks = {k: np.asarray(v, dtype=np.int64) for k, v in raw.items()}
    else:
        if not allow_synthetic:
            raise FileNotFoundError("FLAME_masks.pkl not found")
        synthetic.append("parts")
        part_masks = _synth_part_masks(v_template, rng)

    # --- textures ---
    tex_mean = tex_basis = tex_painted = None
    tex_space_path = asset_dir / _ASSET_FILES["tex_space"] if asset_dir else None
    if tex_space_path is not None and tex_space_path.exists():
        z = np.load(tex_space_path)
        tex_mean = z["mean"].reshape(-1).astype(np.float32)
        tex_basis = z["tex_dir"].reshape(-1, 200).astype(np.float32)
    painted_path = asset_dir / _ASSET_FILES["tex_painted"] if asset_dir else None
    if painted_path is not None and painted_path.exists():
        from PIL import Image
        tex_painted = np.asarray(Image.open(painted_path))[:, :, :3]
    else:
        synthetic.append("tex_painted")
        tex_painted = np.full((512, 512, 3), 160, dtype=np.uint8)

    # --- uv masks ---
    uv_masks: Dict[str, np.ndarray] = {}
    uvmask_path = asset_dir / _ASSET_FILES["uv_masks"] if asset_dir else None
    if uvmask_path is not None and uvmask_path.exists():
        with np.load(uvmask_path, allow_pickle=True) as z:
            uv_masks = {k: np.asarray(z[k], dtype=bool) for k in z.files}

    if synthetic:
        logger.warning(f"FLAME assets synthesized for: {synthetic} "
                       f"(asset_dir={asset_dir}); fine for tests/bench, "
                       "supply real files for production tracking.")

    return FlameAssets(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=_posedirs_as_vcp(posedirs, v_template.shape[0]),
        J_regressor=J_regressor,
        parents=np.asarray(parents, dtype=np.int64),
        lbs_weights=lbs_weights,
        faces=faces.astype(np.int32),
        verts_uvs=verts_uvs,
        textures_idx=textures_idx.astype(np.int32),
        lmk_faces_idx=lmk_faces_idx,
        lmk_bary_coords=lmk_bary_coords,
        part_masks=part_masks,
        tex_mean=tex_mean,
        tex_basis=tex_basis,
        tex_painted=tex_painted,
        uv_masks=uv_masks,
        synthetic_parts=tuple(synthetic),
    )


def _posedirs_as_vcp(posedirs: np.ndarray, V: int) -> np.ndarray:
    """Normalize posedirs to (V, 3, P) layout regardless of source layout.

    FLAME pickles store (V, 3, P); our synthesizer already emits that.
    """
    if posedirs.ndim == 3 and posedirs.shape[0] == V:
        return posedirs
    if posedirs.ndim == 2:  # (P, V*3) transposed storage
        P = posedirs.shape[0]
        return posedirs.T.reshape(V, 3, P)
    raise ValueError(f"unrecognized posedirs shape {posedirs.shape}")


def _synth_sphere_mesh(rng: np.random.Generator, n_lat: int = 48, n_lon: int = 64):
    """UV-sphere fallback template with UVs (used only when no OBJ exists)."""
    lats = np.linspace(0.05, np.pi - 0.05, n_lat)
    lons = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts, uvs = [], []
    for i, la in enumerate(lats):
        for j, lo in enumerate(lons):
            verts.append([0.09 * np.sin(la) * np.cos(lo),
                          0.11 * np.cos(la),
                          0.09 * np.sin(la) * np.sin(lo)])
            uvs.append([j / n_lon, i / (n_lat - 1)])
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            faces.append([a, b, c])
            faces.append([b, d, c])
    v = np.asarray(verts, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    uv = np.asarray(uvs, dtype=np.float32)
    return v, f, uv, f.copy()
