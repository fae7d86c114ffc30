"""Port parity of mesh surgery (model/surgery.py) and the FLAME head with
teeth against the JAX package on the CPU, on the synthetic head with the
regions of tools/surgery_regions.py: every surgery function's arrays bit
for bit, the teeth head's tables and forward, the reference's teeth checks
(tests/test_flame_model.py::TestFullHead), and heads built with the two
options that leave textures_idx stale (connect_lip_inside, remove_torso)
rendered by render_rgba_vis.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.model import assets as jassets
from vhap_tpu.model import masks as jmasks
from vhap_tpu.model import surgery as jsurgery
from vhap_tpu.model.flame import FlameHead as JHead
from vhap_tpu.ops import render as jrender
from vhap_tpu_torch.model import assets as tassets
from vhap_tpu_torch.model import masks as tmasks
from vhap_tpu_torch.model import surgery as tsurgery
from vhap_tpu_torch.model.flame import FlameHead as THead
from vhap_tpu_torch.ops import render as trender
from vhap_tpu_torch.tools.surgery_regions import surgery_regions, with_surgery_regions

NS, NE = 20, 10
CLUSTERS = ("skin", "hair", "boundary", "lips_tight", "teeth", "sclerae", "irises")
ARRAYS = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
          "faces", "verts_uvs", "textures_idx")
FUNCS = ("add_teeth", "connect_lip_inside", "remove_lip_inside", "remove_torso",
         "disable_deformation_on_torso")


def _assets(mod):
    return with_surgery_regions(
        mod.load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0))


def _lip_connect_tables(mod, monkeypatch):
    """connect_lip_inside's 30 stitching faces are FLAME vertex ids beyond
    the stand-in's: give both packages' surgery 30 faces across the
    fixture's lips, from the row above the upper ring to the row below the
    lower (rows 27 and 31 of the sphere). Returns their vertex ids."""
    v = mod.load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0).v_template
    up, lo = (surgery_regions(v)[k] for k in ("lip_outside_ring_upper",
                                             "lip_outside_ring_lower"))
    up, lo = up - 64, lo + 64          # one row above / below the rings
    f = np.concatenate([np.stack([up[:-1], lo[:-1], lo[1:]], 1),
                        np.stack([up[:-1], lo[1:], up[1:]], 1)])[:30]
    tables = dict(mod.load_topology_tables())
    tables["faces/f_lip_connect"] = f.astype(np.int64)
    for m in (jsurgery, tsurgery):
        monkeypatch.setattr(m, "load_topology_tables", lambda t=tables: t)
    return np.unique(f)


def _masks_equal(a, b):
    for attr in ("v", "f", "vt"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert x.keys() == y.keys(), attr
        for k in x:
            assert np.array_equal(x[k], y[k]), (attr, k)
    assert np.array_equal(a.fid2cid, b.fid2cid)
    assert a.num_verts == b.num_verts and a.num_clusters == b.num_clusters


@pytest.mark.parametrize("func", FUNCS)
def test_surgery_function_matches_jax(func, monkeypatch):
    """Each surgery function on the fixture's assets (after add_teeth for
    the others, as FlameHead.build orders them): arrays and region tables
    bit for bit."""
    _lip_connect_tables(jassets, monkeypatch)
    out = []
    for assets_mod, masks_mod, surgery in ((jassets, jmasks, jsurgery),
                                          (tassets, tmasks, tsurgery)):
        a = copy.copy(_assets(assets_mod))
        for name in ARRAYS:
            setattr(a, name, np.array(getattr(a, name)))
        a.shapedirs = np.concatenate([a.shapedirs[:, :, :NS],
                                      a.shapedirs[:, :, 300:300 + NE]], axis=2)
        m = masks_mod.FlameMasks(a.part_masks, a.faces, a.textures_idx,
                                 a.v_template.shape[0], CLUSTERS)
        if func != "add_teeth":
            surgery.add_teeth(a, m, NS)
        args = {"add_teeth": (NS,), "disable_deformation_on_torso": (NE,)}.get(func, ())
        getattr(surgery, func)(a, m, *args)
        out.append((a, m))
    (ja, jm), (ta, tm) = out
    for name in ARRAYS:
        x, y = getattr(ja, name), getattr(ta, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    _masks_equal(jm, tm)


@pytest.fixture(scope="module")
def heads():
    ja, ta = _assets(jassets), _assets(tassets)
    jh = JHead.build(n_shape=NS, n_expr=NE, assets=ja, add_teeth=True,
                     face_clusters=CLUSTERS)
    th = THead.build(n_shape=NS, n_expr=NE, assets=ta, add_teeth=True,
                     face_clusters=CLUSTERS, device="cpu")
    return jh, th


def test_teeth_head_tables_match(heads):
    """The default head (add_teeth=True): 120 teeth vertices, 168 faces,
    every buffer (the Laplacian on the pre-surgery faces) bit for bit."""
    jh, th = heads
    V0 = jassets.load_flame_assets(asset_dir="/nonexistent_force_synth").num_verts
    assert th.num_verts == V0 + 120 and th.num_faces == jh.num_faces
    assert int(th.lap_nbr_w[V0:].abs().sum()) == 0    # teeth: no neighbours
    for name in ARRAYS + ("lmk_faces_idx", "lmk_bary_coords", "lap_nbr_idx",
                          "lap_nbr_w"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, name)),
                                      getattr(th, name).numpy(), err_msg=name)
    _masks_equal(jh.masks, th.masks)


def _pose_args(B, seed, jaw=None):
    rng = np.random.default_rng(seed)
    args = {"shape": rng.normal(0, 1, (B, NS)), "expr": rng.normal(0, 1, (B, NE)),
            "rotation": rng.normal(0, 0.2, (B, 3)), "neck": rng.normal(0, 0.1, (B, 3)),
            "jaw": rng.normal(0, 0.1, (B, 3)), "eyes": rng.normal(0, 0.1, (B, 6)),
            "translation": rng.normal(0, 0.05, (B, 3))}
    if jaw is not None:
        args = {k: np.zeros_like(v) for k, v in args.items()}
        args["jaw"][:, 0] = jaw
    return {k: v.astype(np.float32) for k, v in args.items()}


@pytest.mark.parametrize("offsets", [False, True])
def test_teeth_forward_matches_jax(heads, offsets):
    jh, th = heads
    args = _pose_args(3, 1)
    kw = {}
    if offsets:
        rng = np.random.default_rng(2)
        kw = {"static_offset": rng.normal(0, 1e-3, (1, th.num_verts, 3)).astype(np.float32),
              "dynamic_offset": rng.normal(0, 1e-3, (3, th.num_verts, 3)).astype(np.float32)}
    jv, jcano, jl = jh(**{k: jnp.asarray(v) for k, v in {**args, **kw}.items()},
                       return_verts_cano=True)
    tv, tcano, tl = th(**{k: torch.as_tensor(v) for k, v in {**args, **kw}.items()},
                       return_verts_cano=True)
    for a, b in ((jv, tv), (jcano, tcano), (jl, tl)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


def test_teeth_checks_of_the_reference(heads):
    """tests/test_flame_model.py::TestFullHead's checks on the port's teeth
    head: teeth added, the cluster table, the LBS binding (upper teeth to
    the neck, lower to the jaw) and the jaw moving the lower teeth only."""
    _, th = heads
    m = th.masks
    assert len(m.v["teeth"]) == 120 and th.num_faces == th.textures_idx.shape[0]
    assert m.fid2cid.shape[0] == th.num_faces + 1 and m.fid2cid[0] == 0
    assert m.fid2cid[1:].min() >= 1 and m.num_clusters >= 3
    teeth_cid = 2 + CLUSTERS.index("teeth")
    assert (m.fid2cid[1 + m.f["teeth"]] == teeth_cid).all()
    w = th.lbs_weights.numpy()
    up, lo = m.v["teeth_upper"], m.v["teeth_lower"]
    assert np.allclose(w[up, 1], 1.0) and np.allclose(w[up, 2], 0.0)
    assert np.allclose(w[lo, 2], 1.0) and np.allclose(w[lo, 1], 0.0)
    v0, v1 = (th(**{k: torch.as_tensor(v) for k, v in _pose_args(1, 0, j).items()},
                 return_landmarks=False)[0].numpy() for j in (0.0, 0.3))
    d_lo, d_up = np.abs(v1[lo] - v0[lo]).max(), np.abs(v1[up] - v0[up]).max()
    assert d_lo > 1e-3 and d_up < d_lo * 0.2


@pytest.mark.parametrize("options", ["connect_lip_inside", "remove_torso"])
def test_stale_uv_table_heads_render_like_jax(options, monkeypatch):
    """connect_lip_inside leaves textures_idx 30 rows short of faces, and
    remove_torso leaves it longer: render_rgba_vis with the texture through
    both packages, every output within 1e-5 (NaN where JAX's gather fills
    the missing uv rows with NaN), and the port reads no table out of
    bounds. A static offset brings the stitching faces' vertices 1 cm
    forward, so that the faces, chords of the convex head, win pixels."""
    from test_torch_vis import _jax_rasterize_with, _jax_tri_id, _np
    from vhap_tpu_torch.ops import camera as tcam
    from vhap_tpu_torch.ops.shading import uniform_sh_lights
    from vhap_tpu_torch.tracker.energy import render_verts_uv
    stitched = _lip_connect_tables(jassets, monkeypatch)
    kw = {options: True}
    jh = JHead.build(n_shape=NS, n_expr=NE, assets=_assets(jassets), **kw)
    th = THead.build(n_shape=NS, n_expr=NE, assets=_assets(tassets), device="cpu", **kw)
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(jh, name)),
                                      getattr(th, name).numpy(), err_msg=name)
    n_uv, n_f = th.textures_idx.shape[0], th.num_faces
    assert (n_uv < n_f) if options == "connect_lip_inside" else (n_uv > n_f)

    H = W = 32
    args = _pose_args(2, 5)
    args["jaw"][:, 0] = 0.2
    offset = np.zeros((1, th.num_verts, 3), np.float32)
    if options == "connect_lip_inside":
        offset[0, stitched, 2] = 0.01
    verts = th(**{k: torch.as_tensor(v) for k, v in args.items()},
               static_offset=torch.as_tensor(offset), return_landmarks=False)
    f = 1.5 * H
    K = torch.tensor([[f, f, W / 2, H / 2]] * 2)
    RT = torch.eye(3, 4).expand(2, 3, 4).clone()
    RT[:, 2, 3] = -0.45
    rng = np.random.default_rng(4)
    tex = torch.as_tensor(rng.uniform(size=(1, 3, 64, 64)).astype(np.float32))
    lights = torch.as_tensor(uniform_sh_lights())[None]
    uv = render_verts_uv(th, "cpu")
    got = trender.render_rgba_vis(verts, th.faces, RT, K, (H, W),
                                  trender.RenderSettings(), verts_uv=uv,
                                  faces_uv=th.textures_idx, tex=tex, lights=lights)
    clip = tcam.world_to_clip(verts, RT, K, (H, W))
    tri_id = _jax_tri_id(_np(clip), _np(th.faces), (H, W))
    won = np.unique(np.asarray(tri_id))
    monkeypatch.setattr(jrender, "rasterize", _jax_rasterize_with(tri_id))
    ref = jrender.render_rgba_vis(
        jnp.asarray(_np(verts)), jnp.asarray(_np(th.faces)), jnp.asarray(_np(RT)),
        jnp.asarray(_np(K)), (H, W),
        jrender.RenderSettings(backend="xla", color_dtype="f32"),
        verts_uv=jnp.asarray(_np(uv)), faces_uv=jnp.asarray(_np(th.textures_idx)),
        tex=jnp.asarray(_np(tex)), lights=jnp.asarray(_np(lights)))
    if options == "connect_lip_inside":      # stitching faces won pixels
        assert (won > n_uv).any()
    assert float((got["rgba"][..., 3] > 0).float().mean()) > 0.05
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
