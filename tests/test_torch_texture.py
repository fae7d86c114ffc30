"""Port parity: mip pyramid, trilinear texture sampling and the weighted
texel fetch against the JAX package; the fused sampler's explicit backward
(K4's plain version) against autograd, and the port's texture gradients
against jax.grad.

The JAX fetch kernel runs in interpret mode on the CPU, as in
tests/test_texture_grad.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.ops import texture as jtex
from vhap_tpu.ops.texture_grad_pallas import weighted_fetch_exact
from vhap_tpu_torch.ops import texture as ttex
from vhap_tpu_torch.ops import texture_fetch as tfetch
from vhap_tpu_torch.ops.texture_fetch import weighted_fetch, weighted_fetch_plain
from vhap_tpu_torch.tools import texture_cases


def _inputs(seed, B=2, Hi=32, Wi=128, T=64):
    """A texture quantized to 1/4096 (exact in the JAX kernel's bf16 hi+lo
    split), uvs over and beyond [0, 1] (wrap addressing) and footprints
    spanning every mip level, plus a coverage mask."""
    rng = np.random.default_rng(seed)
    tex = (np.round(rng.uniform(size=(1, T, T, 3)) * 4096) / 4096).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (B, Hi, Wi, 2)).astype(np.float32)
    scale = 10.0 ** rng.uniform(-4, 0.5, (B, Hi, Wi, 1))
    da = (rng.normal(size=(B, Hi, Wi, 4)) * scale).astype(np.float32)
    mask = rng.uniform(size=(B, Hi, Wi)) < 0.7
    return tex, uv, da, mask


@pytest.mark.parametrize("T", [64, 48])
def test_mip_pyramid_matches(T):
    tex = _inputs(0, T=T)[0]
    jf, jo, js = jtex.build_mip_pyramid(jnp.asarray(tex))
    tf, to, ts = ttex.build_mip_pyramid(torch.as_tensor(tex))
    assert (jo, js) == (to, ts)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_texture_sample_matches(seed):
    tex, uv, da, mask = _inputs(seed)
    ref = np.asarray(jtex.texture_sample(
        jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(da),
        mask=jnp.asarray(mask)))                      # xla_fetch on the CPU
    got = ttex.texture_sample(torch.as_tensor(tex), torch.as_tensor(uv),
                              torch.as_tensor(da),
                              mask=torch.as_tensor(mask)).numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max(axis=-1)
    # lod exactly on an integer can floor to neighbouring levels on the
    # two sides (log2 differs in the last ulp)
    assert (err > 1e-5).mean() <= 1e-3, (err > 1e-5).sum()
    assert np.all(got[~mask] == 0)


def test_trilinear_taps_cover_wrap_and_levels():
    tex, uv, da, mask = _inputs(3)
    flat, offsets, sizes = ttex.build_mip_pyramid(torch.as_tensor(tex))
    idx, wgt = tfetch.trilinear_taps(tex.shape[1:3], offsets, sizes,
                                     torch.as_tensor(uv), torch.as_tensor(da),
                                     torch.as_tensor(mask))
    assert idx.dtype == torch.int32 and idx.shape == wgt.shape == (2, 8, 32 * 128)
    assert int(idx.min()) >= 0 and int(idx.max()) < flat.shape[1]
    wsum = wgt.sum(1).numpy().reshape(mask.shape)
    np.testing.assert_allclose(wsum[mask], 1.0, atol=1e-5)
    assert np.all(wsum[~mask] == 0)
    # both mips of the lod range are reached
    assert int(idx.max()) >= offsets[-2]


@pytest.mark.parametrize("seed", [4, 5])
def test_plain_fetch_matches_pallas(seed):
    tex, uv, da, mask = _inputs(seed)
    flat, offsets, sizes = ttex.build_mip_pyramid(torch.as_tensor(tex))
    idx, wgt = tfetch.trilinear_taps(tex.shape[1:3], offsets, sizes,
                                     torch.as_tensor(uv), torch.as_tensor(da),
                                     torch.as_tensor(mask))
    ref = np.asarray(weighted_fetch_exact(
        jnp.asarray(flat[0].numpy()), jnp.asarray(idx.numpy()),
        jnp.asarray(wgt.numpy()), offsets, "pallas", True))
    got = weighted_fetch_plain(flat[0], idx, wgt).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(weighted_fetch(flat[0], idx, wgt).numpy(), got)


def _case_tensors(T, seed):
    c = texture_cases.build(2, 32, 128, T, seed)
    flat, offsets, sizes = ttex.build_mip_pyramid(torch.as_tensor(c["tex"]))
    return c, flat[0], offsets, sizes


@pytest.mark.parametrize("T,seed", [(64, 0), (48, 1)])
def test_sample_bwd_plain_matches_autograd(T, seed):
    """trilinear_sample_bwd_plain (the chain rule K4 carries, written out)
    == torch.autograd of the plain forward (trilinear_taps +
    weighted_fetch_plain) within 1e-5 * max|ref| per channel, on
    tools/texture_cases.py's inputs: integer lods, lod at L - 1, fx2 == fy2
    ties, texel-centre uvs, uvs on and beyond [0, 1], masked pixels and
    zero-cotangent pixels. Both sides run the same forward ops, so they
    choose the same levels and texels; they differ only in summation
    order. dflat is held to the float64 scatter of the forward's own taps:
    autograd's float32 accumulation into the top levels' few texels (tens
    of thousands of taps on the 1 x 1 texel) runs in an order that changes
    with the thread count, up to 1.8e-5 of max|ref| apart."""
    c, flat1, offsets, sizes = _case_tensors(T, seed)
    uv, da, mask, g = (torch.as_tensor(c[k]) for k in ("uv", "uv_da", "mask", "g"))
    leaves = [x.clone().requires_grad_(True) for x in (uv, da)]
    out = tfetch.trilinear_sample_plain(flat1, (T, T), offsets, sizes,
                                        leaves[0], leaves[1], mask)
    ref_uv, ref_da = torch.autograd.grad(out, leaves, g)
    idx, wgt = tfetch.trilinear_taps((T, T), offsets, sizes, uv, da, mask)
    ref_flat = tfetch.scatter_taps_plain(idx, wgt.double(), g.double(),
                                         flat1.shape[0])
    d_uv, d_da, dflat = tfetch.trilinear_sample_bwd_plain(
        flat1, (T, T), offsets, sizes, uv, da, mask, g)
    for got, ref in ((d_uv, ref_uv), (d_da, ref_da), (dflat, ref_flat)):
        assert got.shape == ref.shape
        scale = ref.reshape(-1, ref.shape[-1]).abs().amax(0)
        err = (got.double() - ref.double()).reshape(-1, ref.shape[-1]).abs().amax(0)
        assert bool((scale > 0).all()) and bool((err <= 1e-5 * scale).all()), (err, scale)
    # the cases are hit: dead pixels take nothing; a zero-weight corner or
    # level still carries gradient
    t = tfetch.tap_terms((T, T), offsets, sizes, uv, da)
    live = (mask.reshape(2, -1) & (g.abs().sum(-1) > 0))
    assert bool((d_uv.reshape(2, -1, 2)[~live] == 0).all())
    assert bool((d_da.reshape(2, -1, 4)[~live] == 0).all())
    case = torch.as_tensor(c["case"]).reshape(2, -1)
    L = len(offsets)
    exact = live & (case == texture_cases.CASES.index("texel_exact")) & (t.f == 0)
    exact &= (t.levels[0].fx == 0) & (t.levels[0].fy == 0)
    assert int(exact.sum()) > 10
    assert bool((d_uv.reshape(2, -1, 2)[exact] != 0).any(-1).all())
    on_int = live & (t.f == 0) & (t.lod_raw > 0) & (t.lod_raw < L - 1)
    assert int(on_int.sum()) > 10
    assert bool((d_da.reshape(2, -1, 4)[on_int] != 0).any(-1).all())
    assert int((live & (t.lod_raw == L - 1)).sum()) > 0
    assert int((live & (t.fx2 == t.fy2) & (t.fx2 > 1e-20)).sum()) > 10


@pytest.mark.parametrize("T,seed", [(64, 6), (48, 7)])
def test_texture_sample_grads_match_jax(T, seed):
    """The port's texture_sample gradients (texture, uv, uv_da; the plain
    version on the CPU) == jax.grad of vhap_tpu's texture_sample on the XLA
    path, within 1e-5 * max|ref| per channel on every pixel: the two sides
    sum in other orders (jitted XLA may also contract to FMA; measured
    <= 1.2e-6 of max|ref| here). A lod or texel coordinate within an ulp of
    an integer could floor to neighbouring levels or texels on the two sides
    (the forward test above tolerates that on 1e-3 of its pixels); on these
    inputs no pixel does, so none is left out."""
    import jax

    tex, uv, da, mask = _inputs(seed, T=T)
    g = np.random.default_rng(seed + 100).normal(size=uv.shape[:3] + (3,)).astype(np.float32)

    def loss(tx, u, d):
        out = jtex.texture_sample(tx, u, d, mask=jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(g))

    refs = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(tex), jnp.asarray(uv),
                                            jnp.asarray(da))
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (tex, uv, da)]
    out = ttex.texture_sample(*leaves, mask=torch.as_tensor(mask))
    got = torch.autograd.grad(out, leaves, torch.as_tensor(g))
    for name, x, r in zip(("tex", "uv", "uv_da"), got, refs):
        r = np.asarray(r)
        scale = np.abs(r).reshape(-1, r.shape[-1]).max(0)
        err = np.abs(x.numpy() - r).reshape(-1, r.shape[-1]).max(0)
        assert np.all(scale > 0) and np.all(err <= 1e-5 * scale), (name, err, scale)
