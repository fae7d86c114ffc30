"""Port parity for the JAX package's dense-list kernels.

K7 (`fused_interp_tiled`, the fused interpolation on dense per-tile face
lists, selected by `render.bin_mode='dense'`) is ported as a second caller
of K2f/K2b: the port's plain fused interpolation is held against
`fused_interp_tiled` in interpret mode on JAX's own dense lists, forward and
backward, and the dense-configuration eval energy against the JAX energy in
that configuration. K8 (`scatter_taps`, the value scatter) is held against
the JAX `scatter_taps` on tests/test_texture_grad.py's case and on heavy
collisions. The JAX side's Pallas kernels run in interpret mode on the CPU,
as the JAX package's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.ops import rasterize as jr
from vhap_tpu.ops import texture_grad_pallas as tgp
from vhap_tpu.ops.interp_pallas import fused_interp_tiled
from vhap_tpu_torch.config.base import RenderConfig
from vhap_tpu_torch.ops.interp import (N_FIXED_IN, N_FIXED_OUT,
                                       fused_interp_bwd_plain, fused_interp_plain)
from vhap_tpu_torch.ops.texture_fetch import scatter_taps, scatter_vals_plain
from test_torch_energy import NE, NS, R, T, setup  # noqa: F401 (fixture)
from test_torch_raster import _bf16_hi_lo_exact, _head_scene, _random_scene

H, W = 32, 128


def _t(x):
    return torch.as_tensor(np.array(x))


def _dense_inputs(scene, nf, seed):
    """A scene's dense (B, T, K) tile lists from the JAX visibility, a
    16-bit-exact face table and a foreground-masked cotangent."""
    if scene == "head":
        verts_clip, faces = _head_scene(H=H, W=W, seed=3)
    else:
        verts_clip, faces = _random_scene(seed=4)
    B, F = verts_clip.shape[0], faces.shape[0]
    rng = np.random.default_rng(seed)
    tri_id, ovf, lists = jr.visibility_dispatch(
        jnp.asarray(verts_clip), jnp.asarray(faces), H, W, "xla", True,
        return_lists=True)
    assert int(ovf) == 0 and lists.ndim == 3 and int((tri_id > 0).sum()) > 200
    p = jr.face_attribute_planes(jnp.asarray(verts_clip), jnp.asarray(faces))
    geo = np.stack([np.asarray(p[k]) for k in jr.PLANE_KEYS], 1)
    packed = _bf16_hi_lo_exact(np.concatenate([
        geo, rng.normal(size=(B, 9, F)), rng.uniform(size=(B, 6, F)),
        np.broadcast_to(np.asarray(faces).T[None], (B, 3, F)),
        rng.integers(0, 4, (B, nf, F)),
        geo[:, :6] * rng.uniform(0.9, 1.1, (B, 6, F))], 1).astype(np.float32))
    assert packed.shape[1] == N_FIXED_IN + nf
    fg = np.asarray(tri_id > 0)[:, None]
    g = (rng.normal(size=(B, N_FIXED_OUT + nf, H, W)) * fg).astype(np.float32)
    return packed, tri_id, lists, g


@pytest.mark.parametrize("scene,nf", [("random4", 2), ("head", 0)])
def test_plain_interp_matches_fused_interp_tiled(scene, nf):
    """Forward: within 1e-5 * max(1, |ref|) on foreground pixels (the table
    rounded to the kernel's 16-bit hi + lo rows first); background 0 in
    every channel; overflow 0 on both sides. Backward: the plain K2b
    against jax.grad of fused_interp_tiled (whose d_ctab is scattered back
    through the lists), cotangent masked to the foreground, 2e-5 * max."""
    packed, tri_id, lists, g = _dense_inputs(scene, nf, seed=11)
    ref, ovf = fused_interp_tiled(jnp.asarray(packed), tri_id, lists, nf, 16,
                                  128, interpret=True)
    got, ovf_t = fused_interp_plain(_t(packed), _t(tri_id), nf)
    assert int(ovf) == 0 and ovf_t == 0
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (packed.shape[0], N_FIXED_OUT + nf, H, W)
    fg = np.asarray(tri_id > 0)[:, None]
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert (err * fg).max() <= 1e-5, (err * fg).max(axis=(0, 2, 3))
    assert np.all(got[np.broadcast_to(~fg, got.shape)] == 0)

    def loss(p):
        return jnp.sum(fused_interp_tiled(p, tri_id, lists, nf, 16, 128,
                                          interpret=True)[0] * jnp.asarray(g))

    d_ref = np.asarray(jax.grad(loss)(jnp.asarray(packed)))
    d_got = fused_interp_bwd_plain(_t(packed), _t(tri_id), _t(g), nf).numpy()
    scale = np.abs(d_ref).max()
    assert scale > 0 and d_got.shape == d_ref.shape
    assert np.abs(d_got - d_ref).max() <= 2e-5 * scale, np.abs(d_got - d_ref).max() / scale


def test_dense_eval_energy_matches_jax(setup):
    """The eval energy with render.bin_mode='dense' against the JAX energy
    in that configuration, through fused_interp_tiled in interpret mode:
    1e-4 relative on every term, overflow 0 on both sides. The JAX kernel
    resolves each face row through its 16-bit bf16 hi + lo split, which
    moves uvs and normals by ~1e-5 and, at texel and silhouette edges, a
    few pixels' colours by up to 2e-2 (62 of 24,576 values here): the
    image is held per value on 99.5 % of them."""
    from vhap_tpu.config.base import BaseTrackingConfig as JConfig
    from vhap_tpu.model.flame import FlameTexPainted as JTex
    from vhap_tpu.tracker.energy import make_albedo_fn as j_albedo
    from vhap_tpu.tracker.energy import make_energy_fn as j_energy
    from vhap_tpu_torch.config.base import BaseTrackingConfig as TConfig
    from vhap_tpu_torch.convert import params_from_numpy
    from vhap_tpu_torch.model.flame import FlameTexPainted as TTex
    from vhap_tpu_torch.tracker.energy import make_albedo_fn as t_albedo
    from vhap_tpu_torch.tracker.energy import make_energy_fn as t_energy
    a, jh, th, p, batch = setup
    jc, tc = JConfig(), TConfig()
    for c in (jc, tc):
        c.model.n_shape, c.model.n_expr, c.model.tex_resolution = NS, NE, R
        c.render.bin_mode = "dense"
    jc.render.interp_impl = "fused_interpret"
    tc.render.check_portable()
    jen = j_energy(jh, jc, j_albedo(jc, JTex(a.tex_painted, R), None), (H, W),
                   T, None, with_aux=True)
    jE, (jlog, jaux) = jen({k: jnp.asarray(v) for k, v in p.items()},
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
    ten = t_energy(th, tc, t_albedo(tc, TTex(a.tex_painted, R, device="cpu"), None),
                   (H, W), T, None, with_aux=True, device="cpu")
    tE, (tlog, taux) = ten(params_from_numpy(p, device="cpu"),
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(np.asarray(jaux["pred_alpha"]).mean()) > 0.05
    assert float(jaux["plane_overflow"]) == 0 and float(jlog["rast_overflow"]) == 0
    assert float(tlog["rast_overflow"]) == 0 and taux["plane_overflow"] == 0
    for k in ("lmk", "photo", "total"):
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(tE), float(jE), rtol=1e-4)
    diff = np.abs(taux["pred_rgb"].numpy() - np.asarray(jaux["pred_rgb"]))
    assert (diff <= 1e-4).mean() >= 0.995 and diff.max() <= 5e-2, diff.max()


@pytest.mark.parametrize("bin_mode", ["auto", "flat", "dense"])
def test_bin_modes_accepted(bin_mode):
    RenderConfig(bin_mode=bin_mode).check_portable()


@pytest.mark.parametrize("field", ["plane_max_list", "max_faces_per_tile"])
def test_list_caps_still_rejected(field):
    """A cap on the per-tile lists drops faces; the port has no lists to
    cap, so any cap but 0 raises, with every bin_mode."""
    for bin_mode in ("flat", "dense"):
        with pytest.raises(ValueError, match=field):
            RenderConfig(bin_mode=bin_mode, **{field: 64})


def _collision_case():
    """Heavy collisions: 48 texels take 8192 taps each on average."""
    rng = np.random.default_rng(7)
    B, K, C, P = 2, 8, 3, 512 * 24
    idx = rng.integers(0, 48, (B, K, P)).astype(np.int32)
    vals = rng.normal(size=(B, K, C, P)).astype(np.float32) * 1e-2
    vals[:, :, :, ::4] = 0.0
    return idx, vals, (0,), 16384


def _texture_grad_case():
    """tests/test_texture_grad.py:24-45: 3 tiles, the last partial, fake
    pyramid offsets, every third pixel all-zero."""
    rng = np.random.default_rng(0)
    B, K, C, P = 2, 8, 3, 512
    idx = np.concatenate([
        rng.integers(0, 30000, (B, 4, P)),
        rng.integers(30000, 40000, (B, 4, P))], axis=1).astype(np.int32)
    vals = rng.normal(size=(B, K, C, P)).astype(np.float32)
    vals[:, :, :, ::3] = 0.0
    return idx, vals, (0, 30000, 38000), 40000


@pytest.mark.parametrize("case", [_texture_grad_case, _collision_case],
                         ids=["texture_grad_case", "collisions"])
def test_plain_scatter_taps_matches_jax(case):
    """K8's plain version (float32 index_add_, what the CPU wrapper runs)
    against the JAX scatter_taps (Pallas, interpret mode), 5e-5, and both
    against a float64 numpy sum."""
    idx, vals, levels, n_texels = case()
    ref, ovf = tgp.scatter_taps(jnp.asarray(idx), jnp.asarray(vals), levels,
                                n_texels, npix=256)
    got, ovf_t = scatter_taps(_t(idx), _t(vals), n_texels)
    assert int(ovf) == 0 and ovf_t == 0
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape == (n_texels, vals.shape[2])
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=5e-5)
    exact = np.zeros((n_texels, vals.shape[2]))
    np.add.at(exact, idx.reshape(-1),
              vals.transpose(0, 1, 3, 2).reshape(-1, vals.shape[2]).astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=0, atol=5e-5 * np.abs(exact).max())
    np.testing.assert_array_equal(
        got, scatter_vals_plain(_t(idx), _t(vals), n_texels).numpy())
