"""Port parity of the two backward kernels' plain versions against the JAX
package: K2b (fused interp backward) against jax.grad of
fused_interp_flat, and K4 (texel scatter + weight gradient) against the
gradients of weighted_fetch_exact. The JAX side's Pallas kernels run in
interpret mode on the CPU, as the JAX package's own tests run them
(tests/test_flat_bins.py, tests/test_texture_grad.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.ops import rasterize as jr
from vhap_tpu.ops.interp_pallas import fused_interp_flat
from vhap_tpu.ops.texture_grad_pallas import weighted_fetch_exact
from vhap_tpu_torch.ops import texture as ttex
from vhap_tpu_torch.ops.interp import (GROUPS, N_FIXED_IN, N_FIXED_OUT,
                                       fused_interp, fused_interp_bwd,
                                       fused_interp_bwd_plain,
                                       fused_interp_plain, group_slices,
                                       join_channels)
from vhap_tpu_torch.ops.texture_fetch import (scatter_taps_plain,
                                              tap_weight_grad_plain,
                                              trilinear_taps,
                                              weighted_fetch_plain)
from test_torch_raster import _bf16_hi_lo_exact


def _t(x):
    return torch.as_tensor(np.array(x))


def _interp_inputs(seed, nf, B=2, V=80, F=120, H=32, W=128):
    """Random clip-space scene, its flat bins, a 16-bit-exact face table
    and a foreground-masked cotangent."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-0.9, 0.9, (B, V, 3))
    w = rng.uniform(1.0, 3.0, (B, V, 1))
    verts_clip = jnp.asarray(np.concatenate([verts * w, w], -1), jnp.float32)
    faces = jnp.asarray(rng.integers(0, V, (F, 3)), jnp.int32)
    tri_id, _, bins = jr.visibility_dispatch(verts_clip, faces, H, W, "xla",
                                             True, return_lists="flat")
    p = jr.face_attribute_planes(verts_clip, faces)
    geo = np.stack([np.asarray(p[k]) for k in jr.PLANE_KEYS], 1)
    packed = _bf16_hi_lo_exact(np.concatenate([
        geo, rng.normal(size=(B, 9, F)), rng.uniform(size=(B, 6, F)),
        np.broadcast_to(np.asarray(faces).T[None], (B, 3, F)),
        rng.integers(0, 4, (B, nf, F)),
        geo[:, :6] * rng.uniform(0.9, 1.1, (B, 6, F))], 1).astype(np.float32))
    fg = np.asarray(tri_id > 0)[:, None]
    g = (rng.normal(size=(B, N_FIXED_OUT + nf, H, W)) * fg).astype(np.float32)
    return packed, tri_id, bins, g


@pytest.mark.parametrize("seed,nf", [(4, 2), (5, 0)])
def test_plain_interp_bwd_matches_pallas(seed, nf):
    """(a) fused_interp_bwd_plain == jax.grad of fused_interp_flat (Pallas
    K2b in interpret mode), cotangent masked to the foreground, within
    2e-5 * max|grad| (the JAX kernel's 16-bit hi/lo split of the row
    gradients; tests/test_flat_bins.py:172-173)."""
    packed, tri_id, bins, g = _interp_inputs(seed, nf)
    assert packed.shape[1] == N_FIXED_IN + nf
    assert int((tri_id > 0).sum()) > 200

    def loss(p):
        return jnp.sum(fused_interp_flat(p, tri_id, bins, nf, 16, 128,
                                         interpret=True)[0] * jnp.asarray(g))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(packed)))
    got = fused_interp_bwd_plain(_t(packed), _t(tri_id), _t(g), nf).numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= 2e-5 * scale, np.abs(got - ref).max() / scale
    # every row of the table receives gradient, the pass-through rows too
    assert np.all(np.abs(got).max(axis=(0, 2)) > 0)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        fused_interp_bwd(_t(packed), _t(tri_id), _t(g), nf).numpy(), got)


def test_plain_interp_bwd_is_autograd_of_forward():
    """K2b's plain version is the autograd gradient of K2f's plain version;
    background pixels contribute nothing, whatever their cotangent."""
    packed, tri_id, _, g = _interp_inputs(6, 2)
    bg = ~np.asarray(tri_id > 0)[:, None]
    noisy = g + np.random.default_rng(0).normal(size=g.shape).astype(np.float32) * bg
    a = fused_interp_bwd_plain(_t(packed), _t(tri_id), _t(g), 2)
    b = fused_interp_bwd_plain(_t(packed), _t(tri_id), _t(noisy), 2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    p = _t(packed).requires_grad_(True)
    out, _ = fused_interp_plain(p, _t(tri_id), 2)
    (c,) = torch.autograd.grad((out * _t(g)).sum(), p)
    np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=0,
                               atol=1e-6 * float(a.abs().max()))


def _per_output_grad(packed, tri_id, g, nf, none):
    """fused_interp's per-output form on the CPU: its outputs, and the
    table gradient when only the groups not in `none` enter the loss (the
    others get no cotangent: autograd hands the backward None for them)."""
    p = _t(packed).requires_grad_(True)
    out, ovf = fused_interp(p, _t(tri_id), nf)
    assert ovf == 0 and isinstance(out.texc, torch.Tensor)
    sl = group_slices(nf)
    loss = sum((getattr(out, k) * _t(g[:, sl[k]])).sum()
               for k in GROUPS if k not in none)
    (d,) = torch.autograd.grad(loss, p)
    g_used = g.copy()
    for k in none:
        g_used[:, sl[k]] = 0.0
    return out, d.numpy(), g_used


def test_per_output_interp_matches_plain_and_pallas():
    """fused_interp's outputs as separate autograd outputs: the values of
    fused_interp_plain, bit for bit, and with zw, vids and flags feeding
    nothing (no cotangent) the gradient of fused_interp_bwd_plain for a
    cotangent that is 0 there, and of jax.grad of fused_interp_flat (Pallas
    K2b in interpret mode) within 2e-5 * max|grad|."""
    nf = 2
    packed, tri_id, bins, g = _interp_inputs(4, nf)
    out, got, g_used = _per_output_grad(packed, tri_id, g, nf,
                                        ("zw", "vids", "flags"))
    ref_out, _ = fused_interp_plain(_t(packed), _t(tri_id), nf)
    assert torch.equal(join_channels(out), ref_out)
    plain = fused_interp_bwd_plain(_t(packed), _t(tri_id), _t(g_used), nf).numpy()
    np.testing.assert_array_equal(got, plain)

    def loss(p):
        return jnp.sum(fused_interp_flat(p, tri_id, bins, nf, 16, 128,
                                         interpret=True)[0] * jnp.asarray(g_used))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(packed)))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2e-5 * scale, np.abs(got - ref).max() / scale
    # the rows only the unused groups feed get no gradient
    rows = np.abs(got).max(axis=(0, 2))
    zero = np.r_[9:12, 27:32]           # z rows (only zw), vids, flags
    assert np.all(rows[zero] == 0) and np.all(np.delete(rows, zero) > 0)


@pytest.mark.parametrize("nf,none", [(0, ("texc", "texd", "normal", "aa")),
                                     (2, ("zw", "texc")), (0, ())])
def test_per_output_interp_none_groups_match_plain(nf, none):
    """The per-output form with other sets of groups left without a
    cotangent (nf = 0: an empty flags group) equals the plain backward."""
    packed, tri_id, _, g = _interp_inputs(5, nf)
    _, got, g_used = _per_output_grad(packed, tri_id, g, nf, none)
    plain = fused_interp_bwd_plain(_t(packed), _t(tri_id), _t(g_used), nf).numpy()
    np.testing.assert_array_equal(got, plain)
    assert np.abs(got).max() > 0


def _fetch_inputs(seed, B=2, Hi=32, Wi=128, T=64):
    """tests/test_torch_texture.py's taps: a texture quantized to 1/4096
    (exact in the JAX kernel's bf16 hi + lo split), uvs over and beyond
    [0, 1], footprints spanning every mip level, a coverage mask; plus a
    cotangent, zero on some pixels."""
    rng = np.random.default_rng(seed)
    tex = (np.round(rng.uniform(size=(1, T, T, 3)) * 4096) / 4096).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (B, Hi, Wi, 2)).astype(np.float32)
    scale = 10.0 ** rng.uniform(-4, 0.5, (B, Hi, Wi, 1))
    da = (rng.normal(size=(B, Hi, Wi, 4)) * scale).astype(np.float32)
    mask = rng.uniform(size=(B, Hi, Wi)) < 0.7
    flat, offsets, sizes = ttex.build_mip_pyramid(torch.as_tensor(tex))
    idx, wgt = trilinear_taps(tex.shape[1:3], offsets, sizes,
                              torch.as_tensor(uv), torch.as_tensor(da),
                              torch.as_tensor(mask))
    g = rng.normal(size=(B, Hi * Wi, 3)).astype(np.float32)
    g[:, ::7] = 0.0
    return flat[0], offsets, idx, wgt, torch.as_tensor(g)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_plain_scatter_and_weight_grad_match_jax(impl):
    """(b) scatter_taps_plain (K4's dflat) and tap_weight_grad_plain (its
    d_wgt) == the gradients of weighted_fetch_exact, the Pallas texel
    scatter in interpret mode and the XLA branch, within 5e-5
    (tests/test_texture_grad.py:44: the Pallas kernel's hi/lo split)."""
    flat1, offsets, idx, wgt, g = _fetch_inputs(7)
    assert bool((wgt == 0).any() & (wgt != 0).any())

    def f(fl, w):
        return weighted_fetch_exact(fl, jnp.asarray(idx.numpy()), w, offsets,
                                    impl, True)

    _, pull = jax.vjp(f, jnp.asarray(flat1.numpy()), jnp.asarray(wgt.numpy()))
    ref_flat, ref_w = (np.asarray(x) for x in pull(jnp.asarray(g.numpy())))
    got_flat = scatter_taps_plain(idx, wgt, g, flat1.shape[0]).numpy()
    got_w = tap_weight_grad_plain(flat1, idx, g).numpy()
    np.testing.assert_allclose(got_flat, ref_flat, rtol=5e-5, atol=5e-5)
    # a zero-weight tap of a pixel with a cotangent still has a weight
    # gradient (its bilinear or lod fraction is exactly 0, not constant)
    zero_tap = (wgt == 0).numpy() & (np.abs(g.numpy()).sum(-1) > 0)[:, None]
    assert np.abs(got_w[zero_tap]).max() > 0
    if impl == "xla":
        np.testing.assert_allclose(got_w, ref_w, rtol=5e-5, atol=5e-5)
    else:
        # the Pallas branch forms d_wgt from the texels its gather fetched,
        # and it fetches none for a zero-weight tap: there it reports 0
        # (a reference-side divergence, ROADMAP.md Queue 3); the port
        # follows the XLA branch on every tap
        live = (wgt != 0).numpy()
        np.testing.assert_allclose(got_w[live], ref_w[live], rtol=5e-5, atol=5e-5)
        assert np.all(ref_w[zero_tap] == 0)


def test_fetch_backward_through_autograd_matches_k4_plain():
    """The fetch's autograd backward on the CPU equals the plain pair that
    K4's plain version (trilinear_sample_bwd_plain) builds on: the texel
    scatter and each tap's texel . g."""
    flat1, _, idx, wgt, g = _fetch_inputs(8)
    fl = flat1.clone().requires_grad_(True)
    w = wgt.clone().requires_grad_(True)
    d_fl, d_w = torch.autograd.grad(weighted_fetch_plain(fl, idx, w), (fl, w), g)
    k_fl = scatter_taps_plain(idx, wgt, g, flat1.shape[0])
    k_w = tap_weight_grad_plain(flat1, idx, g)
    np.testing.assert_allclose(k_fl.numpy(), d_fl.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(k_w.numpy(), d_w.numpy(), rtol=1e-6, atol=1e-6)
