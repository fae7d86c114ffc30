"""Port parity of the nvdiffrast-style API against the JAX package on the
CPU: `rasterize` (K5's path; its visibility is K1's plain version here),
`interpolate`, the nvdiffrast-form antialias and the UV-space renders.
tests/test_torch_vis_render.py holds `render_rgba_vis` and the gradient of
the whole chain.

The JAX side runs op by op, as eager JAX, but for its visibility: jitted
whole, XLA rounds the attribute math otherwise (u, v move by up to 3e-5 on
ill-conditioned pixels, geometry gradients by up to a few 1e-2 of max|g|),
while op-by-op JAX and the port agree. JAX's `rasterize` is jitted in the
package, so the tests take its tri_id from it (visibility has no gradient;
run eagerly its face scan takes tens of seconds) and compute its
attributes op by op (`_jax_rasterize_with`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.ops import antialias as jaa
from vhap_tpu.ops import rasterize as jr
from vhap_tpu.ops import render_uvmap as juv
from vhap_tpu_torch.ops import antialias as taa
from vhap_tpu_torch.ops import rasterize as tr
from vhap_tpu_torch.ops import render as trender
from vhap_tpu_torch.ops import render_uvmap as tuv
from vhap_tpu_torch.tools.vis_slice import build_vis_slice

H, W = 32, 128


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _slice():
    """The vis slice at a tiny size on the CPU (cached: callers only read)."""
    return build_vis_slice(device="cpu", batch_size=2, image_size=(H, W),
                           tex_res=64, n_shape=20, n_expr=10)


def _random_scene(seed, B=2, V=80, F=120):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-0.9, 0.9, (B, V, 3))
    w = rng.uniform(1.0, 3.0, (B, V, 1))
    return (np.concatenate([verts * w, w], -1).astype(np.float32),
            rng.integers(0, V, (F, 3)).astype(np.int64))


def _jax_tri_id(vc, faces, size, cull=True):
    """JAX's exact visibility, jitted (eager, its face scan takes tens of
    seconds; visibility carries no gradient)."""
    return jr.rasterize(jnp.asarray(vc), jnp.asarray(faces), size,
                        backend="xla", cull_backfaces=cull)[2]


def _jax_rasterize_with(tri_id):
    """jr.rasterize with its visibility fixed to tri_id and its attributes
    computed as it computes them, op by op, for the runs of its callers."""
    def rasterize(vc, faces, image_size, *args, grad_enabled=True,
                  with_overflow=False, **kwargs):
        if not grad_enabled:
            vc = jax.lax.stop_gradient(vc)
        rast, rast_db = jr.rasterize_attributes(vc, faces, tri_id)
        return (rast, rast_db, tri_id) + ((0,) if with_overflow else ())
    return rasterize


def _scene(name):
    """(verts_clip, faces, cull_backfaces) of a test scene."""
    if name.startswith("random"):
        vc, faces = _random_scene(int(name[-1]))
        return vc, faces, True
    s = _slice()
    if name == "uv":                  # the UV layout: z = -1, w = 1, no cull
        return (_np(tuv.transform_vt(s.eval.head.verts_uvs)),
                _np(s.eval.head.textures_idx), False)
    clip = trender.cam.world_to_clip(s.verts, s.RT, s.K, (H, W))
    return _np(clip), _np(s.eval.head.faces), name == "head"


# ---------------------------------------------------------------------------
# rasterize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["random0", "random2", "head", "head_nocull", "uv"])
def test_rasterize_matches_jax(scene):
    """Against op-by-op JAX attributes: jitted, XLA moves u, v by up to
    3e-5 on the head scene's ill-conditioned pixels (both sides are 1-2e-5
    from float64 there); op by op, JAX and the port agree to the bit."""
    vc, faces, cull = _scene(scene)
    t_ref = _jax_tri_id(vc, faces, (H, W), cull)
    ref = _jax_rasterize_with(t_ref)(jnp.asarray(vc), jnp.asarray(faces),
                                     (H, W))
    rast, rast_db, tri_id, ovf = tr.rasterize(_t(vc), _t(faces), (H, W), cull,
                                              with_overflow=True)
    assert ovf == 0 and tri_id.dtype == torch.int32
    t_ref, t_got = np.asarray(ref[2]), tri_id.numpy()
    assert (t_got > 0).sum() > 100
    assert (t_got != t_ref).mean() <= 1e-3
    same_fg = ((t_got == t_ref) & (t_got > 0))[..., None]
    for a, b in ((ref[0], rast), (ref[1], rast_db)):
        a, b = np.asarray(a), b.numpy()
        err = np.abs(b - a) / np.maximum(np.abs(a), 1.0) * same_fg
        assert err.max() <= 1e-5, err.max()
    # background: zeros, and the id channel carries tri_id
    np.testing.assert_array_equal(rast.numpy()[..., 3], t_got.astype(np.float32))
    assert np.all(rast_db.numpy()[t_got == 0] == 0)


def test_rasterize_uv_coverage_matches_jax_square():
    """UV-space depth is z = -1 exactly; coverage equals JAX's on the
    square of tests/test_uvmask.py."""
    vt = np.asarray([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9], [0.9, 0.9]], np.float32)
    faces = np.asarray([[0, 1, 2], [1, 3, 2]])
    clip = tuv.transform_vt(_t(vt))
    assert bool((clip[..., 2] == -1).all())
    ref = jr.rasterize(juv.transform_vt(jnp.asarray(vt)), jnp.asarray(faces),
                       (64, 64), backend="xla", cull_backfaces=False)[2]
    got = tr.rasterize(clip, _t(faces), (64, 64), cull_backfaces=False)[2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.5 < float((got > 0).float().mean()) < 0.75


# ---------------------------------------------------------------------------
# interpolate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diff", [False, True], ids=["plain", "diff_attrs"])
def test_interpolate_matches_jax(diff):
    vc, faces, _ = _scene("head")
    rast, rast_db, _ = jr.rasterize(jnp.asarray(vc), jnp.asarray(faces), (H, W),
                                    backend="xla")
    rng = np.random.default_rng(1)
    attr = rng.normal(size=(1, vc.shape[1], 3)).astype(np.float32)
    g = rng.normal(size=(2, H, W, 9 if diff else 3)).astype(np.float32)
    kw = dict(rast_db=rast_db, diff_attrs="all") if diff else {}

    def jf(a):
        out, da = jr.interpolate(a, rast, jnp.asarray(faces), **kw)
        return jnp.concatenate([out, da], -1) if diff else out

    ref = np.asarray(jf(jnp.asarray(attr)))
    d_ref = np.asarray(jax.grad(lambda a: jnp.sum(jf(a) * g))(jnp.asarray(attr)))
    a_t = _t(attr).requires_grad_(True)
    out, da = tr.interpolate(a_t, _t(rast), _t(faces),
                             **({"rast_db": _t(rast_db), "diff_attrs": "all"}
                                if diff else {}))
    assert (da is None) != diff
    got = torch.cat([out, da], -1) if diff else out
    (d_got,) = torch.autograd.grad(got, a_t, _t(g))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_got.numpy(), d_ref, rtol=0,
                               atol=1e-5 * np.abs(d_ref).max())


# ---------------------------------------------------------------------------
# nvdiffrast-form antialias (the scenes of tests/test_render_ops.py TestAntialias)
# ---------------------------------------------------------------------------

TRI = np.asarray([[[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0],
                   [0.0, 0.5, 0.0, 1.0]]], np.float32)


def _aa_port(vc, faces, size, color_fn):
    rast, _, _ = tr.rasterize(vc, faces, size)
    return taa.antialias_rast(color_fn(rast), rast, vc, faces)


def test_antialias_rast_matches_eager_jax():
    """Values and vertex gradients on the triangle of TestAntialias
    (tests/test_render_ops.py:93-144). Its bottom edge runs through
    pixel-pair midpoints, where the blend weight's clip sits exactly on its
    bound: the port passes half the gradient there, as jnp.clip does. The
    triangle's coordinates and the pixel centers are short binary
    fractions, so every product is exact and the jitted JAX reference
    rounds as eager JAX. (The head's antialias is held by the render and
    gradient-chain tests.)"""
    vc, faces = TRI, np.asarray([[0, 1, 2]])
    size = (32, 32)
    g = np.ones((1,) + size + (4,), np.float32)

    def jcolor(rast):
        return jnp.broadcast_to(jnp.where(rast[..., 3:] > 0, 1.0, 0.0),
                                rast.shape[:3] + (4,))

    def tcolor(rast):
        return torch.where(rast[..., 3:] > 0, 1.0, 0.0).expand(rast.shape[:3] + (4,))

    jrast = _jax_rasterize_with(_jax_tri_id(vc, faces, size))

    def jaa_out(v):
        rast, _, _ = jrast(v, jnp.asarray(faces), size)
        return jaa.antialias(jcolor(rast), rast, v, jnp.asarray(faces))

    ref = np.asarray(jax.jit(jaa_out)(jnp.asarray(vc)))
    d_ref = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jaa_out(v) * g)))(
        jnp.asarray(vc)))
    v_t = _t(vc).requires_grad_(True)
    got = _aa_port(v_t, _t(faces), size, tcolor)
    (d_got,) = torch.autograd.grad(torch.sum(got * _t(g)), v_t)
    assert np.abs(ref - jcolor(jrast(jnp.asarray(vc), jnp.asarray(faces),
                                     size)[0])).max() > 1e-3   # some pairs blend
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5)
    assert np.abs(d_ref).max() > 0
    np.testing.assert_allclose(d_got.numpy(), d_ref, rtol=0,
                               atol=1e-4 * np.abs(d_ref).max())


# ---------------------------------------------------------------------------
# UV-space renders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["vtex", "texmap_mip2", "texmap_linear"])
def test_render_uvmap_matches_jax(mode, monkeypatch):
    """Against op-by-op JAX (its visibility jitted): coverage equal, values
    within 1e-5. With JAX's rasterize jitted whole, a pixel or two flip
    their antialias. Not at 32 x 32: there the synthetic layout's quad
    diagonals pass through pixel centers, where XLA's jit and the port
    break the edge tie apart on 7.5 % of the pixels (coverage stays
    equal)."""
    head = _slice().eval.head
    vt, fuv = _np(head.verts_uvs), _np(head.textures_idx)
    res = (H, W)
    rng = np.random.default_rng(4)
    clip = tuv.transform_vt(_t(vt))
    tri_ref = _jax_tri_id(_np(clip), fuv, res, cull=False)
    monkeypatch.setattr(juv, "rasterize", _jax_rasterize_with(tri_ref))
    if mode == "vtex":
        col = rng.uniform(size=(vt.shape[0], 2)).astype(np.float32)
        ref = juv.render_uvmap_vtex(jnp.asarray(vt), jnp.asarray(fuv),
                                    jnp.asarray(col), jnp.asarray(fuv), res)
        got = tuv.render_uvmap_vtex(_t(vt), _t(fuv), _t(col), _t(fuv), res)
    else:
        tex = rng.uniform(size=(32, 32, 3)).astype(np.float32)
        kw = dict(enable_mip=mode != "texmap_linear",
                  max_mip_level=2 if mode == "texmap_mip2" else None)
        ref = juv.render_uvmap_texmap(jnp.asarray(vt), jnp.asarray(fuv),
                                      jnp.asarray(vt), jnp.asarray(fuv),
                                      jnp.asarray(tex), res, **kw)
        got = tuv.render_uvmap_texmap(_t(vt), _t(fuv), _t(vt), _t(fuv), _t(tex),
                                      res, **kw)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape
    tri_got = tr.rasterize(clip, _t(fuv), res, cull_backfaces=False)[2].numpy()
    np.testing.assert_array_equal(tri_got > 0, np.asarray(tri_ref) > 0)  # coverage
    assert (tri_got > 0).mean() > 0.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
