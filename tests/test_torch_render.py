"""Port parity: shading, antialias and render_rgba (image layout) against
the JAX package, on the same tri_id."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.model.assets import load_flame_assets
from vhap_tpu.model.flame import FlameHead
from vhap_tpu.ops import antialias as jaa
from vhap_tpu.ops import rasterize as jr
from vhap_tpu.ops import render as jrender
from vhap_tpu.ops import shading as jsh
from vhap_tpu_torch.ops import antialias as taa
from vhap_tpu_torch.ops import render as trender
from vhap_tpu_torch.ops import shading as tsh

B, H, W, T = 2, 32, 128, 64


@pytest.fixture(scope="module")
def scene():
    """Posed synthetic head, camera, texture and lights, as numpy."""
    rng = np.random.default_rng(0)
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    head = FlameHead.build(n_shape=4, n_expr=2, assets=a, add_teeth=False)
    z = lambda n, s=0.2: jnp.asarray(rng.normal(0, s, (B, n)), jnp.float32)
    trans = jnp.asarray([[0.01, -0.02, -0.3]] * B, jnp.float32)
    verts = head(shape=z(4), expr=z(2), rotation=z(3, 0.3), neck=z(3),
                 jaw=z(3), eyes=z(6), translation=trans, return_landmarks=False)
    uv = np.asarray(head.verts_uvs)
    RT = np.eye(3, 4, dtype=np.float32)
    RT[2, 3] = -1.0                       # the tracker's default camera
    return dict(
        verts=np.asarray(verts), faces=np.asarray(head.faces),
        verts_uv=np.stack([uv[:, 0], 1.0 - uv[:, 1]], -1).astype(np.float32),
        faces_uv=np.asarray(head.textures_idx),
        K=np.asarray([[1.5 * W, 1.5 * W, W / 2, H / 2]] * B, np.float32),
        RT=np.broadcast_to(RT, (B, 3, 4)).copy(),
        tex=rng.uniform(size=(1, 3, T, T)).astype(np.float32),
        lights=(rng.normal(0.1, 0.3, (1, 9, 3))).astype(np.float32),
        bg=rng.uniform(size=(B, H, W, 3)).astype(np.float32))


def _t(x):
    return torch.as_tensor(np.array(x))


def test_shading_matches():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(B, 16, 8, 3)).astype(np.float32)
    lights = rng.normal(size=(1, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.shade(_t(n), "SH", _t(lights)).numpy(),
        np.asarray(jsh.shade(jnp.asarray(n), "SH", jnp.asarray(lights))),
        rtol=1e-5, atol=1e-5)
    verts = rng.normal(size=(B, 40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3))
    np.testing.assert_allclose(
        tsh.compute_v_normals(_t(verts), _t(faces)).numpy(),
        np.asarray(jsh.compute_v_normals(jnp.asarray(verts), jnp.asarray(faces))),
        rtol=1e-5, atol=1e-5)
    for kind in ("constant", "front", "front-range"):
        np.testing.assert_allclose(
            tsh.shade(_t(n), kind).numpy(),
            np.asarray(jsh.shade(jnp.asarray(n), kind)), atol=1e-6)


def _rasterize_both(sc):
    """JAX rast dict (xla backend) and the port's, sharing JAX's tri_id."""
    settings = jrender.RenderSettings(backend="xla", color_dtype="f32",
                                      interp_impl="planes", plane_impl="xla")
    jrd = jrender.rasterize_mesh(jnp.asarray(sc["verts"]), jnp.asarray(sc["faces"]),
                                 jnp.asarray(sc["RT"]), jnp.asarray(sc["K"]),
                                 (H, W), settings, with_attrs=False)
    trd = trender.rasterize_mesh(_t(sc["verts"]), _t(sc["faces"]).long(),
                                 _t(sc["RT"]), _t(sc["K"]), (H, W),
                                 trender.RenderSettings())
    trd["tri_id"] = _t(jrd["tri_id"])
    return settings, jrd, trd


def test_antialias_matches(scene):
    sc = scene
    _, jrd, trd = _rasterize_both(sc)
    tri = jrd["tri_id"]
    rng = np.random.default_rng(2)
    color = rng.uniform(size=(B, H, W, 4)).astype(np.float32)
    vc = jrd["verts_clip"]
    zw = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    rast = jnp.stack([jnp.zeros_like(tri, jnp.float32)] * 2
                     + [jnp.asarray(zw), tri.astype(jnp.float32)], -1)
    p = jr.face_attribute_planes(vc, jnp.asarray(sc["faces"]))
    fid = jnp.maximum(tri - 1, 0)
    a_planes = jr.gather_face_planes_packed(
        jnp.stack([p[k] for k in jaa.AA_PLANE_KEYS], 1), fid)
    vid_planes = jr.gather_face_planes_packed(
        jnp.broadcast_to(jnp.asarray(sc["faces"]).T[None], (B, 3, sc["faces"].shape[0])), fid)
    ref = np.asarray(jaa.antialias(jnp.asarray(color), rast, vc,
                                   jnp.asarray(sc["faces"]),
                                   vid_planes=vid_planes, a_planes=a_planes))
    got = taa.antialias(_t(color), _t(tri), _t(zw),
                        [_t(v) for v in vid_planes], [_t(a) for a in a_planes])
    assert np.abs(ref - color).max() > 1e-3          # some pairs blend
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("background", ["image", "white"])
def test_render_rgba_matches(scene, background):
    sc = scene
    settings, jrd, trd = _rasterize_both(sc)
    bg = sc["bg"] if background == "image" else (1.0, 1.0, 1.0)
    jout = jrender.render_rgba(
        jrd, jnp.asarray(sc["faces"]), jnp.asarray(sc["verts_uv"]),
        jnp.asarray(sc["faces_uv"]), jnp.asarray(sc["tex"]),
        jnp.asarray(sc["lights"]), settings,
        jnp.asarray(bg) if background == "image" else bg)
    tout = trender.render_rgba(
        trd, _t(sc["faces"]).long(), _t(sc["verts_uv"]),
        _t(sc["faces_uv"]).long(), _t(sc["tex"]), _t(sc["lights"]),
        trender.RenderSettings(), _t(bg) if background == "image" else bg)
    fg = np.asarray(jrd["tri_id"] > 0)[:, ::-1]
    assert fg.mean() > 0.05
    for k in ("rgba", "albedo", "normal", "diffuse", "diffuse_detach_normal", "aa"):
        a, b = np.asarray(jout[k]), tout[k].numpy()
        assert a.shape == b.shape, k
        if k == "normal":   # background normals are unused (0 here, 0 there)
            a, b = a * fg[..., None], b * fg[..., None]
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=k)


def test_training_features_raise(scene):
    """The training features render (slice 2), matching the JAX package
    with the disturbance off; only the TPU's 'pairswap' disturbance and a
    disturbance without fid2cid or generator raise."""
    sc = scene
    settings, jrd, trd = _rasterize_both(sc)
    F, V = sc["faces"].shape[0], sc["verts"].shape[1]
    rng = np.random.default_rng(4)
    tex_mask = rng.uniform(size=F + 1) < 0.5
    tex_mask[0] = False
    bnd_mask = rng.uniform(size=V) < 0.3
    fid2cid = np.concatenate([[0], rng.integers(1, 4, F)]).astype(np.int32)
    args = (trd, _t(sc["faces"]).long(), _t(sc["verts_uv"]),
            _t(sc["faces_uv"]).long(), _t(sc["tex"]), _t(sc["lights"]))
    off = dict(disturb_rate_fg=None, disturb_rate_bg=None)
    tout = trender.render_rgba(
        *args, trender.RenderSettings(**off), (1.0, 1.0, 1.0), tex_mask,
        bnd_mask, enable_disturbance=True, fid2cid=fid2cid, num_clusters=4,
        generator=torch.Generator().manual_seed(0))
    jout = jrender.render_rgba(
        jrd, jnp.asarray(sc["faces"]), jnp.asarray(sc["verts_uv"]),
        jnp.asarray(sc["faces_uv"]), jnp.asarray(sc["tex"]),
        jnp.asarray(sc["lights"]), jrender.RenderSettings(
            backend="xla", color_dtype="f32", interp_impl="planes",
            plane_impl="xla", **off), (1.0, 1.0, 1.0), tex_mask, bnd_mask,
        enable_disturbance=True, fid2cid=jnp.asarray(fid2cid), num_clusters=4,
        key=jax.random.PRNGKey(0))
    for k in ("rgba", "cid"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    with pytest.raises(NotImplementedError, match="pairswap"):
        trender.render_rgba(*args, trender.RenderSettings(disturb_impl="pairswap"),
                            enable_disturbance=True, fid2cid=fid2cid,
                            num_clusters=4, generator=torch.Generator())
    with pytest.raises(ValueError, match="fid2cid"):
        trender.render_rgba(*args, trender.RenderSettings(), enable_disturbance=True)
