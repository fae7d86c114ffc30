"""Port parity: camera, rasterizer setup, visibility (K1's plain version)
and the fused interpolation (K2's plain version) against the JAX package.

The JAX side's Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them (tests/test_flat_bins.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.ops import camera as jcam
from vhap_tpu.ops import rasterize as jr
from vhap_tpu.ops.interp_pallas import fused_interp_flat
from vhap_tpu.ops.rasterize_pallas import visibility_pallas_flat
from vhap_tpu_torch.ops import camera as tcam
from vhap_tpu_torch.ops import rasterize as tr
from vhap_tpu_torch.ops.interp import N_FIXED_IN, fused_interp_plain


def _random_scene(B=2, V=80, F=120, seed=0):
    """Random clip-space triangles, all in front of the camera."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-0.9, 0.9, (B, V, 3)).astype(np.float32)
    w = rng.uniform(1.0, 3.0, (B, V, 1)).astype(np.float32)
    verts_clip = np.concatenate([verts * w, w], axis=-1).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    return verts_clip, faces


@functools.lru_cache(maxsize=None)
def _head_scene(B=2, H=32, W=128, seed=0):
    """The synthetic head seen by the tracker's default camera (cached:
    callers only read the arrays)."""
    from vhap_tpu.model.assets import load_flame_assets
    from vhap_tpu.model.flame import FlameHead
    rng = np.random.default_rng(seed)
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    head = FlameHead.build(n_shape=4, n_expr=2, assets=a, add_teeth=False)
    z = lambda n: jnp.asarray(rng.normal(0, 0.2, (B, n)), jnp.float32)
    trans = jnp.asarray([[0.0, 0.0, -0.3]] * B, jnp.float32)
    verts = head(shape=z(4), expr=z(2), rotation=z(3) * 0.5, neck=z(3),
                 jaw=z(3), eyes=z(6), translation=trans,
                 return_landmarks=False)
    K = jnp.asarray([[1.5 * W, 1.5 * W, W / 2, H / 2]] * B, jnp.float32)
    RT = jnp.broadcast_to(jnp.eye(3, 4).at[2, 3].set(-1.0), (B, 3, 4))
    clip = jcam.world_to_clip(verts, RT, K, (H, W))
    return np.asarray(clip), np.asarray(head.faces)


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# (c) camera, face_setup, face_attribute_planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_form", ["vec4", "mat3"])
def test_camera_matches(k_form):
    rng = np.random.default_rng(5)
    B, V, H, W = 3, 50, 32, 128
    f = rng.uniform(100, 200, B)
    K = np.stack([f, f * 1.1, rng.uniform(50, 70, B), rng.uniform(10, 20, B)], 1)
    if k_form == "mat3":
        M = np.zeros((B, 3, 3))
        M[:, 0, 0], M[:, 1, 1], M[:, 0, 2], M[:, 1, 2], M[:, 2, 2] = \
            K[:, 0], K[:, 1], K[:, 2], K[:, 3], 1.0
        K = M
    K = K.astype(np.float32)
    R = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0]
    RT = np.concatenate([R, rng.normal(0, 0.2, (B, 3, 1))], -1).astype(np.float32)
    v = rng.normal(0, 0.2, (B, V, 3)).astype(np.float32)
    v[..., 2] -= 2.0
    pairs = [
        (jcam.projection_from_intrinsics(jnp.asarray(K), (H, W)),
         tcam.projection_from_intrinsics(_t(K), (H, W))),
        (jcam.world_to_camera(jnp.asarray(v), jnp.asarray(RT)),
         tcam.world_to_camera(_t(v), _t(RT))),
        (jcam.world_to_clip(jnp.asarray(v), jnp.asarray(RT), jnp.asarray(K), (H, W)),
         tcam.world_to_clip(_t(v), _t(RT), _t(K), (H, W))),
        (jcam.world_to_ndc(jnp.asarray(v), jnp.asarray(RT), jnp.asarray(K),
                           (H, W), flip_y=True),
         tcam.world_to_ndc(_t(v), _t(RT), _t(K), (H, W), flip_y=True)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def _straddling_scene(seed=4):
    """A random scene where some faces cross the near plane (w <= eps)."""
    verts_clip, faces = _random_scene(seed=seed)
    verts_clip[:, :8, 3] = -0.5
    return verts_clip, faces


@pytest.mark.parametrize("scene", ["random", "straddling", "head"])
def test_face_setup_matches(scene):
    verts_clip, faces = {"random": _random_scene, "head": _head_scene,
                         "straddling": _straddling_scene}[scene]()
    js = jr.face_setup(jnp.asarray(verts_clip), jnp.asarray(faces), True,
                       clip_straddling=True)
    ts = tr.face_setup(_t(verts_clip), _t(faces).long(), True)
    valid = np.asarray(js["valid"])
    np.testing.assert_array_equal(ts["valid"].numpy(), valid)
    assert valid.sum() > 10
    for k in ("abc", "zpln", "bbox", "wsign"):
        a, b = np.asarray(js[k])[valid], ts[k].numpy()[valid]
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=k)

    jp = jr.face_attribute_planes(jnp.asarray(verts_clip), jnp.asarray(faces))
    tp = tr.face_attribute_planes(_t(verts_clip), _t(faces).long())
    for k in jr.PLANE_KEYS:
        np.testing.assert_allclose(tp[k].numpy()[valid], np.asarray(jp[k])[valid],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# (d) plain visibility (K1's reference) vs the JAX backends
# ---------------------------------------------------------------------------

def _assert_visibility_agrees(tri, ref, verts_clip, faces, H, W):
    """Equal on >= 99.9 % of pixels; every mismatch lies on an edge of one
    of the two candidate faces (min |b| < 1e-5: XLA may contract products
    into FMAs there, PyTorch's eager ops do not)."""
    mism = np.argwhere(tri != ref)
    assert len(mism) <= 1e-3 * tri.size, f"{len(mism)} of {tri.size} differ"
    if len(mism) == 0:
        return
    s = tr.face_setup(_t(verts_clip), _t(faces).long(), True)
    abc = s["abc"].numpy()
    px, py = (np.arange(W) + 0.5) * (2.0 / W) - 1.0, (np.arange(H) + 0.5) * (2.0 / H) - 1.0
    for b, i, j in mism:
        bmin = np.inf
        for fid1 in (tri[b, i, j], ref[b, i, j]):
            if fid1 > 0:
                p = abc[b, fid1 - 1]
                b0 = p[0, 0] * px[j] + p[0, 1] * py[i] + p[0, 2]
                b1 = p[1, 0] * px[j] + p[1, 1] * py[i] + p[1, 2]
                bmin = min(bmin, abs(b0), abs(b1), abs(1 - b0 - b1))
        assert bmin < 1e-5, (b, i, j, tri[b, i, j], ref[b, i, j], bmin)


@pytest.mark.parametrize("scene,H,W", [("random0", 64, 256), ("random2", 32, 128),
                                       ("head", 32, 128)])
def test_plain_visibility_matches_jax(scene, H, W):
    if scene == "head":
        verts_clip, faces = _head_scene(H=H, W=W)
    else:
        verts_clip, faces = _random_scene(seed=int(scene[-1]))
    tri, ovf = tr.visibility(_t(verts_clip), _t(faces).long(), H, W)
    tri = tri.numpy()
    assert ovf == 0 and tri.dtype == np.int32
    assert (tri > 0).sum() > 100
    ref_xla = np.asarray(jr._visibility_xla(jnp.asarray(verts_clip),
                                            jnp.asarray(faces), H, W))
    ref_pl, bins = visibility_pallas_flat(jnp.asarray(verts_clip),
                                          jnp.asarray(faces), H, W,
                                          interpret=True)
    assert int(bins["overflow"]) == 0
    _assert_visibility_agrees(tri, ref_xla, verts_clip, faces, H, W)
    _assert_visibility_agrees(tri, np.asarray(ref_pl), verts_clip, faces, H, W)


def test_visibility_clips_near_plane_straddlers_like_xla():
    """The port keeps the visible part of a straddling face, as the JAX
    xla backend does (the JAX Pallas kernel drops it whole)."""
    verts_clip, faces = _straddling_scene()
    H, W = 32, 128
    tri = tr.visibility(_t(verts_clip), _t(faces).long(), H, W)[0].numpy()
    ref = np.asarray(jr._visibility_xla(jnp.asarray(verts_clip),
                                        jnp.asarray(faces), H, W))
    _assert_visibility_agrees(tri, ref, verts_clip, faces, H, W)


def _assert_winners_binned(verts_clip, faces, H, W, cull=True):
    """Every covered pixel of the plain visibility lies in its winning
    face's pixel box, and that face is a candidate of the pixel's tile or
    in its image's shared list, by K1's tile rule (tile_bins_plain)."""
    tri, _ = tr.visibility_plain(verts_clip, faces, H, W, cull)
    rows = tr.pack_setup_rows(tr.face_setup(verts_clip, faces, cull))
    listed, large = tr.tile_bins_plain(rows, H, W)
    i0, i1, j0, j1, _ = tr.face_pixel_boxes(rows, H, W)
    b, i, j = torch.nonzero(tri > 0, as_tuple=True)
    assert len(b) > 100
    f = tri[b, i, j].long() - 1
    tile = (i // tr.VIS_TILE) * -(-W // tr.VIS_TILE) + j // tr.VIS_TILE
    in_box = (i0[b, f] <= i) & (i <= i1[b, f]) & (j0[b, f] <= j) & (j <= j1[b, f])
    assert bool(in_box.all())
    assert bool((listed[b, tile, f] | large[b, f]).all())
    assert not bool((listed.any(1) & large).any())   # one list per face
    return int(large.sum())


@pytest.mark.parametrize("scene,H,W", [("random0", 32, 128), ("random3", 37, 91),
                                       ("straddling", 61, 203), ("head", 32, 128),
                                       ("head", 37, 91)])
def test_tile_bins_hold_every_winner(scene, H, W):
    """K1's binning rule, in the kernel's float32 steps, on the CPU scenes
    at ragged sizes too (the head's 32 x 128 clip-space scene, rasterized
    at 37 x 91 as well)."""
    if scene == "head":
        verts_clip, faces = _head_scene(H=32, W=128)
    elif scene == "straddling":
        verts_clip, faces = _straddling_scene()
    else:
        verts_clip, faces = _random_scene(seed=int(scene[-1]))
    _assert_winners_binned(_t(verts_clip), _t(faces).long(), H, W)


@pytest.mark.parametrize("name", ["coplanar_ties", "covering_face", "near_plane",
                                  "crowded_tile", "ragged"])
def test_tile_bins_hold_every_winner_on_adversarial_scenes(name):
    """The same on tools/raster_scenes.py's scenes: large faces, the
    crowded tile (1256 candidates, 256 winning faces), ties, straddlers."""
    from vhap_tpu_torch.tools import raster_scenes as rs
    sc = rs.build(name)
    n_large = _assert_winners_binned(sc["clip"], sc["faces"], sc["H"], sc["W"],
                                     sc["cull"])
    if name in ("covering_face", "near_plane"):
        assert n_large > 0
    if name == "crowded_tile":
        assert int(torch.unique(tr.visibility_plain(
            sc["clip"], sc["faces"], sc["H"], sc["W"])[0][0, 32:48, 48:64]).numel()) == 256


def test_tile_bins_crowded_tile_spills():
    """K1 keeps VIS_TILE_CAP candidates in a tile's list and moves the rest
    to its image's shared list: the crowded scene's tile has more, so the
    card's K1 tests on it run the spill path."""
    from vhap_tpu_torch.tools import raster_scenes as rs
    sc = rs.build("crowded_tile")
    rows = tr.pack_setup_rows(tr.face_setup(sc["clip"], sc["faces"], sc["cull"]))
    listed, _ = tr.tile_bins_plain(rows, sc["H"], sc["W"])
    per_tile = listed.sum(-1)
    tile = 2 * -(-sc["W"] // tr.VIS_TILE) + 3        # pixels 32:48, 48:64
    assert int(per_tile[0, tile]) > tr.VIS_TILE_CAP
    assert int((per_tile > tr.VIS_TILE_CAP).sum()) < per_tile.numel()


def test_pack_setup_rows_layout():
    verts_clip, faces = _random_scene(seed=1)
    s = tr.face_setup(_t(verts_clip), _t(faces).long(), True)
    rows = tr.pack_setup_rows(s)
    assert rows.shape == (2, faces.shape[0], tr.SETUP_ROW) and rows.is_contiguous()
    np.testing.assert_array_equal(rows[..., 0:6].numpy(),
                                  s["abc"].reshape(2, -1, 6).numpy())
    np.testing.assert_array_equal(rows[..., 9:13].numpy(), s["bbox"].numpy())
    np.testing.assert_array_equal(rows[..., 16].numpy() > 0, s["valid"].numpy())


# ---------------------------------------------------------------------------
# (e) plain fused interpolation (K2's reference) vs fused_interp_flat
# ---------------------------------------------------------------------------

def _bf16_hi_lo_exact(x):
    """Round f32 values to what the Pallas kernel's bf16 hi + lo split
    represents exactly, so both sides start from identical numbers."""
    hi = (x.view(np.int32) & np.int32(-65536)).view(np.float32)
    lo = torch.as_tensor(x - hi).to(torch.bfloat16).to(torch.float32).numpy()
    return (hi + lo).astype(np.float32)


@pytest.mark.parametrize("scene,nf", [("random4", 2), ("head", 0)])
def test_plain_fused_interp_matches_pallas(scene, nf):
    H, W = 32, 128
    if scene == "head":
        verts_clip, faces = _head_scene(H=H, W=W, seed=3)
    else:
        verts_clip, faces = _random_scene(seed=4)
    B, F = verts_clip.shape[0], faces.shape[0]
    rng = np.random.default_rng(11)
    tri_id, _, bins = jr.visibility_dispatch(
        jnp.asarray(verts_clip), jnp.asarray(faces), H, W, "xla", True,
        return_lists="flat")
    assert int(bins["overflow"]) == 0 and int((tri_id > 0).sum()) > 200
    p = jr.face_attribute_planes(jnp.asarray(verts_clip), jnp.asarray(faces))
    geo = np.stack([np.asarray(p[k]) for k in jr.PLANE_KEYS], 1)
    nrm = rng.normal(size=(B, 9, F))
    uv = rng.uniform(size=(B, 6, F))
    vid = np.broadcast_to(faces.T[None], (B, 3, F))
    flags = rng.integers(0, 4, (B, nf, F))
    aa = geo[:, :6] * rng.uniform(0.9, 1.1, (B, 6, F))
    packed = _bf16_hi_lo_exact(np.concatenate(
        [geo, nrm, uv, vid, flags, aa], 1).astype(np.float32))
    assert packed.shape[1] == N_FIXED_IN + nf

    ref, ovf = fused_interp_flat(jnp.asarray(packed), tri_id, bins, nf, 16, 128,
                                 interpret=True)
    assert int(ovf) == 0
    got, ovf_t = fused_interp_plain(_t(packed), _t(tri_id), nf)
    assert ovf_t == 0
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (B, 20 + nf, H, W)
    fg = np.asarray(tri_id > 0)[:, None]
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert (err * fg).max() <= 1e-5, (err * fg).max(axis=(0, 2, 3))
    # background pixels carry 0 in every channel; match is 1 on foreground
    assert np.all(got[np.broadcast_to(~fg, got.shape)] == 0)
    np.testing.assert_array_equal(got[:, -1], fg[:, 0].astype(np.float32))
