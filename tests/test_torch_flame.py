"""Port parity: synthetic FLAME assets, the FLAME forward and the painted
texture against the JAX package, on the tiny synthetic head (CPU, f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.model import assets as jassets
from vhap_tpu.model import lbs as jlbs
from vhap_tpu.model.flame import FlameHead as JHead
from vhap_tpu.model.flame import FlameTexPainted as JTex
from vhap_tpu_torch.convert import head_from_assets
from vhap_tpu_torch.model import assets as tassets
from vhap_tpu_torch.model import lbs as tlbs
from vhap_tpu_torch.model.flame import FlameHead as THead
from vhap_tpu_torch.model.flame import FlameTexPainted as TTex

NS, NE = 20, 10


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_assets_bitwise_equal(seed):
    a = jassets.load_flame_assets(asset_dir="/nonexistent_force_synth", seed=seed)
    b = tassets.load_flame_assets(asset_dir="/nonexistent_force_synth", seed=seed)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "parents", "lbs_weights", "faces", "verts_uvs",
                 "textures_idx", "lmk_faces_idx", "lmk_bary_coords",
                 "tex_painted"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
    assert a.part_masks.keys() == b.part_masks.keys()
    for k in a.part_masks:
        assert np.array_equal(a.part_masks[k], b.part_masks[k]), k
    assert a.synthetic_parts == b.synthetic_parts


@pytest.fixture(scope="module")
def heads():
    a = jassets.load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    jh = JHead.build(n_shape=NS, n_expr=NE, assets=a, add_teeth=False,
                     face_clusters=("skin", "hair"))
    th = head_from_assets(a, NS, NE, face_clusters=("skin", "hair"),
                          device="cpu")
    return jh, th


def test_head_tables_match(heads):
    jh, th = heads
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "lbs_weights", "faces", "verts_uvs", "textures_idx",
                 "lmk_faces_idx", "lmk_bary_coords", "lap_nbr_idx",
                 "lap_nbr_w"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, name)),
                                      getattr(th, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(jh.masks.fid2cid, th.masks.fid2cid)


@pytest.mark.parametrize("offsets", [False, True])
def test_flame_forward_matches(heads, offsets):
    jh, th = heads
    rng = np.random.default_rng(1)
    B = 3
    args = dict(shape=rng.normal(0, 1, (B, NS)), expr=rng.normal(0, 1, (B, NE)),
                rotation=rng.normal(0, 0.3, (B, 3)),
                neck=rng.normal(0, 0.2, (B, 3)), jaw=rng.normal(0, 0.2, (B, 3)),
                eyes=rng.normal(0, 0.1, (B, 6)),
                translation=rng.normal(0, 0.1, (B, 3)))
    args = {k: v.astype(np.float32) for k, v in args.items()}
    kw = {}
    if offsets:
        V = th.num_verts
        kw = dict(static_offset=rng.normal(0, 0.01, (1, V, 3)).astype(np.float32),
                  dynamic_offset=rng.normal(0, 0.01, (B, V, 3)).astype(np.float32))
    jv, jc, jl = jh(**{k: jnp.asarray(v) for k, v in {**args, **kw}.items()},
                    return_verts_cano=True)
    tv, tc, tl = th(**{k: torch.as_tensor(v) for k, v in {**args, **kw}.items()},
                    return_verts_cano=True)
    for a, b in ((jv, tv), (jc, tc), (jl, tl)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


def test_rodrigues_and_rigid_transform(heads):
    jh, th = heads
    rng = np.random.default_rng(2)
    rv = rng.normal(0, 1.0, (4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlbs.batch_rodrigues(torch.as_tensor(rv)).numpy(),
        np.asarray(jlbs.batch_rodrigues(jnp.asarray(rv))), atol=1e-6)
    rot = np.asarray(jlbs.batch_rodrigues(jnp.asarray(rv)))
    joints = rng.normal(0, 0.1, (4, 5, 3)).astype(np.float32)
    jj, ja = jlbs.batch_rigid_transform(jnp.asarray(rot), jnp.asarray(joints),
                                        jh.parents)
    tj, ta = tlbs.batch_rigid_transform(torch.as_tensor(rot),
                                        torch.as_tensor(joints), th.parents)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)


@pytest.mark.parametrize("src,dst", [(16, 64), (64, 16), (48, 64)])
def test_painted_texture_resize_matches(src, dst):
    """jax.image.resize bilinear vs F.interpolate, over the whole map and on
    its borders, where the two handle out-of-range taps."""
    rng = np.random.default_rng(src)
    u8 = rng.integers(0, 256, (src, src, 3)).astype(np.uint8)
    a = np.asarray(JTex(u8, dst)())
    b = TTex(u8, dst, device="cpu")().numpy()
    assert a.shape == b.shape == (1, 3, dst, dst)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    for edge in (b[..., 0, :] - a[..., 0, :], b[..., -1, :] - a[..., -1, :],
                 b[..., :, 0] - a[..., :, 0], b[..., :, -1] - a[..., :, -1]):
        assert np.abs(edge).max() <= 1e-6


@pytest.mark.parametrize("option", ["add_teeth", "remove_lip_inside",
                                    "remove_torso"])
def test_surgery_raises_until_ported(option):
    """Surgery is ported (tests/test_torch_surgery.py): on the bare stand-in
    head, which lacks the lip regions, each option fails where and as the
    JAX package's build fails, or builds the same faces."""
    kw = {"add_teeth": False, option: True}
    try:
        jh = JHead.build(n_shape=NS, n_expr=NE, assets=jassets.load_flame_assets(
            asset_dir="/nonexistent_force_synth", seed=0), **kw)
    except Exception as e:
        with pytest.raises(type(e), match=str(e)[:20]):
            THead.build(n_shape=NS, n_expr=NE, assets=tassets.load_flame_assets(
                asset_dir="/nonexistent_force_synth", seed=0), device="cpu", **kw)
        return
    th = THead.build(n_shape=NS, n_expr=NE, assets=tassets.load_flame_assets(
        asset_dir="/nonexistent_force_synth", seed=0), device="cpu", **kw)
    for name in ("faces", "textures_idx", "v_template", "lbs_weights"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, name)),
                                      getattr(th, name).numpy(), err_msg=name)


@pytest.mark.parametrize("tex_size", [512, 64])
def test_pca_texture_matches(tex_size):
    """FlameTexPCA (the tracker's albedo when tex_painted=False): mean +
    basis @ code, BGR -> RGB, / 255, clamped, resized as JAX resizes."""
    from vhap_tpu.model.flame import FlameTexPCA as JPCA
    from vhap_tpu_torch.model.flame import FlameTexPCA as TPCA
    rng = np.random.default_rng(tex_size)
    # a ramp past [0, 255] across the map: clamped at both ends after any resize
    ramp = np.linspace(-60.0, 315.0, 512, dtype=np.float32)
    mean = np.broadcast_to(ramp[None, :, None], (512, 512, 3)).reshape(-1).copy()
    basis = rng.normal(0, 10, (512 * 512 * 3, 6)).astype(np.float32)
    code = rng.normal(size=(2, 4)).astype(np.float32)
    a = np.asarray(JPCA(mean, basis, 4, tex_size)(jnp.asarray(code)))
    b = TPCA(mean, basis, 4, tex_size, device="cpu")(torch.as_tensor(code)).numpy()
    assert a.shape == b.shape == (2, 3, tex_size, tex_size)
    assert (a == 1.0).any() and (a == 0.0).any()   # the clamp is exercised
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)
