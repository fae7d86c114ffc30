"""Port parity: the plane gather (K6's plain version) against the JAX
package's XLA gather (`gather_face_planes_packed`) and its Pallas kernel
(`plane_gather_tiled`, in interpret mode on the CPU), values and table
gradients, including the background / face-0 clamp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.ops import rasterize as jr
from vhap_tpu.ops.plane_pallas import plane_gather_tiled
from vhap_tpu_torch.ops import rasterize as tr
from vhap_tpu_torch.ops.plane_gather import (plane_gather, plane_gather_bwd,
                                             plane_gather_bwd_plain,
                                             plane_gather_plain)


def _hi_lo_exact(x):
    """Round f32 values to what the Pallas kernel's bf16 hi + lo split
    represents exactly, so both sides start from identical numbers."""
    x = np.asarray(x, np.float32)
    hi = (x.view(np.int32) & np.int32(-65536)).view(np.float32)
    lo = torch.as_tensor(x - hi).to(torch.bfloat16).to(torch.float32).numpy()
    return (hi + lo).astype(np.float32)


def _setup(B=2, C=13, F=150, H=16, W=256, seed=0, table_batch=None):
    rng = np.random.default_rng(seed)
    packed = _hi_lo_exact(rng.normal(size=(table_batch or B, C, F)))
    tri_id = rng.integers(0, F + 1, (B, H, W)).astype(np.int32)
    tri_id[0, :8, :128] = 0                       # a background region
    g = _hi_lo_exact(rng.normal(size=(B, C, H, W)))
    return packed, tri_id, g


def _port(packed, tri_id, g):
    """Port planes and table gradient (autograd of the plain version)."""
    p = torch.as_tensor(packed).requires_grad_(True)
    planes = plane_gather(p, torch.as_tensor(tri_id))
    (d,) = torch.autograd.grad(planes, p, torch.as_tensor(g))
    return planes.detach().numpy(), d.numpy()


def _assert_grad_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("table_batch", [None, 1], ids=["batched", "shared"])
def test_plain_matches_xla_gather(table_batch):
    packed, tri_id, g = _setup(seed=1, table_batch=table_batch)
    B = tri_id.shape[0]

    def ref_planes(p):
        p = jnp.broadcast_to(p, (B,) + p.shape[1:])      # as interpolate does
        fid = jnp.maximum(jnp.asarray(tri_id) - 1, 0)
        return jnp.stack(jr.gather_face_planes_packed(p, fid), axis=1)

    ref = np.asarray(ref_planes(jnp.asarray(packed)))
    d_ref = np.asarray(jax.grad(lambda p: jnp.sum(ref_planes(p) * g))(
        jnp.asarray(packed)))
    got, d_got = _port(packed, tri_id, g)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    _assert_grad_close(d_got, d_ref)
    # the backward alone: the same table gradient
    d_alone = plane_gather_bwd(torch.as_tensor(tri_id), torch.as_tensor(g),
                               packed.shape[0], packed.shape[2]).numpy()
    _assert_grad_close(d_alone, d_ref)


@pytest.mark.parametrize("case", ["full_lists", "face0_unlisted"])
def test_plain_matches_pallas_interpret(case):
    """The clamp cases of tests/test_plane_gather.py:35-74: background
    pixels read face 0 and send their cotangent there, also where the
    tiles' lists omit face 0."""
    packed, tri_id, g = _setup(seed=3)
    F = packed.shape[2]
    T = (tri_id.shape[1] // 16) * (tri_id.shape[2] // 128)
    lists = np.broadcast_to(np.arange(F, dtype=np.int32), (2, T, F))
    if case == "face0_unlisted":
        lists = lists[..., 1:]                    # drop face id 0
        tri_id = np.where(tri_id == 1, 2, tri_id)  # keep every fg face listed

    def ref_planes(p):
        return plane_gather_tiled(p, jnp.asarray(tri_id), jnp.asarray(lists),
                                  16, 128, 512, True)

    planes, ovf = ref_planes(jnp.asarray(packed))
    assert int(ovf) == 0
    d_ref = np.asarray(jax.grad(lambda p: jnp.sum(ref_planes(p)[0] * g))(
        jnp.asarray(packed)))
    got, d_got = _port(packed, tri_id, g)
    np.testing.assert_allclose(got, np.asarray(planes), rtol=0, atol=1e-6)
    _assert_grad_close(d_got, d_ref)
    # every background pixel carries face 0's row
    b, i, j = np.argwhere(tri_id == 0)[0]
    np.testing.assert_array_equal(got[b, :, i, j], packed[b, :, 0])


def test_gather_face_planes_match_jax():
    """The JAX package's fid-based helpers, ported through the gather."""
    packed, tri_id, _ = _setup(C=5, seed=4)
    fid = np.maximum(tri_id - 1, 0)
    ref = jr.gather_face_planes_packed(jnp.asarray(packed), jnp.asarray(fid))
    got = tr.gather_face_planes_packed(torch.as_tensor(packed), torch.as_tensor(fid))
    assert len(got) == len(ref) == 5
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    one = tr.gather_face_plane(torch.as_tensor(packed[:, 2]), torch.as_tensor(fid))
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jr.gather_face_plane(jnp.asarray(packed[:, 2]),
                                                     jnp.asarray(fid))))


def test_plain_backward_is_the_adjoint():
    """<gather(p), g> = <p, scatter(g)> for the plain pair (float64)."""
    rng = np.random.default_rng(5)
    tri_id = torch.as_tensor(rng.integers(0, 41, (3, 8, 16)).astype(np.int32))
    p = torch.as_tensor(rng.normal(size=(1, 4, 40)))
    g = torch.as_tensor(rng.normal(size=(3, 4, 8, 16)))
    lhs = torch.sum(plane_gather_plain(p, tri_id) * g)
    rhs = torch.sum(p * plane_gather_bwd_plain(tri_id, g, 1, 40))
    assert abs(float(lhs - rhs)) <= 1e-10 * abs(float(lhs))
