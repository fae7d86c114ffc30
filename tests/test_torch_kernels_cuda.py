"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA GPU with nvcc and skip elsewhere (a CUDA
kernel has no interpret mode). On such a machine:

    python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from vhap_tpu_torch.ops import kernels
    kernels.library()               # builds the kernels on first use
    return torch.device("cuda")


def _scene(dev, B=2, V=200, F=400, seed=0):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-0.9, 0.9, (B, V, 3))
    w = rng.uniform(1.0, 3.0, (B, V, 1))
    clip = np.concatenate([verts * w, w], -1).astype(np.float32)
    faces = rng.integers(0, V, (F, 3))
    return (torch.as_tensor(clip, device=dev),
            torch.as_tensor(faces, dtype=torch.long, device=dev))


@pytest.mark.parametrize("seed,H,W", [(0, 64, 256), (1, 37, 91), (2, 128, 128)])
def test_visibility_kernel_equals_plain(dev, seed, H, W):
    from vhap_tpu_torch.ops.rasterize import VISIBILITY, visibility, visibility_plain
    clip, faces = _scene(dev, seed=seed)
    if seed == 2:
        clip[:, :10, 3] = -0.5          # near-plane straddlers
    n0 = VISIBILITY.launches
    got, ovf = visibility(clip, faces, H, W)
    ref, _ = visibility_plain(clip, faces, H, W)
    torch.cuda.synchronize()
    assert VISIBILITY.launches == n0 + 1 and ovf == 0
    assert got.dtype == torch.int32 and int((got > 0).sum()) > 100
    assert torch.equal(got, ref)


def test_fused_interp_kernel_matches_plain(dev):
    from vhap_tpu_torch.ops.interp import (FUSED_INTERP, fused_interp,
                                           fused_interp_plain, join_channels)
    from vhap_tpu_torch.ops.rasterize import PLANE_KEYS, face_attribute_planes, visibility
    clip, faces = _scene(dev, seed=3)
    H, W, nf = 64, 256, 2
    tri, _ = visibility(clip, faces, H, W)
    B, F = clip.shape[0], faces.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    p = face_attribute_planes(clip, faces)
    packed = torch.cat([torch.stack([p[k] for k in PLANE_KEYS], 1),
                        torch.randn(B, 15, F, device=dev, generator=g),
                        faces.T[None].float().expand(B, 3, F),
                        torch.randint(0, 4, (B, nf, F), device=dev, generator=g).float(),
                        torch.stack([p[k] for k in PLANE_KEYS[:6]], 1)], 1).contiguous()
    n0 = FUSED_INTERP.launches
    out, _ = fused_interp(packed, tri, nf)
    got = join_channels(out)
    ref, _ = fused_interp_plain(packed, tri, nf)
    torch.cuda.synchronize()
    assert FUSED_INTERP.launches == n0 + 1
    fg = (tri > 0)[:, None]
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0) * fg).max()
    assert float(err) <= 1e-5
    assert torch.all(got[~fg.expand_as(got)] == 0)


def _sampler_inputs(dev, T, seed, planes, with_mask):
    """tools/texture_cases.py's adversarial inputs on the card; with
    planes, uv and uv_da are channel slices of one (B, 22, H, W) buffer, as
    the fused interpolation returns them."""
    from vhap_tpu_torch.ops.texture import build_mip_pyramid
    from vhap_tpu_torch.tools import texture_cases
    c = texture_cases.build(2, 64, 96, T, seed)
    flat, offsets, sizes = build_mip_pyramid(torch.as_tensor(c["tex"], device=dev))
    uv, da = (torch.as_tensor(c[k], device=dev) for k in ("uv", "uv_da"))
    if planes:
        buf = torch.zeros((uv.shape[0], 22) + uv.shape[1:3], device=dev)
        buf[:, 1:3], buf[:, 3:7] = uv.permute(0, 3, 1, 2), da.permute(0, 3, 1, 2)
        uv, da = buf[:, 1:3].permute(0, 2, 3, 1), buf[:, 3:7].permute(0, 2, 3, 1)
    mask = torch.as_tensor(c["mask"], device=dev) if with_mask else None
    g = torch.as_tensor(c["g"], device=dev)
    return flat[0].contiguous(), (T, T), offsets, sizes, uv, da, mask, g


SAMPLER_CASES = [(64, 0, True, True), (48, 1, False, True), (256, 2, True, False)]


@pytest.mark.parametrize("T,seed,planes,with_mask", SAMPLER_CASES)
def test_trilinear_sample_kernel_matches_plain(dev, T, seed, planes, with_mask):
    """K3 (the fused sample) within 1e-5 of trilinear_sample_plain on every
    pixel, and the taps its code forms identical to trilinear_taps'
    (level and texel choice, on integer lods, lod L - 1, ties, texel
    centres, uvs on and beyond [0, 1]); masked pixels 0."""
    from vhap_tpu_torch.ops.texture_fetch import (TRILINEAR_SAMPLE, trilinear_sample,
                                                  trilinear_sample_plain,
                                                  trilinear_taps, trilinear_taps_card)
    flat1, size, offsets, sizes, uv, da, mask, _ = _sampler_inputs(
        dev, T, seed, planes, with_mask)
    n0 = TRILINEAR_SAMPLE.launches
    got = trilinear_sample(flat1, size, offsets, sizes, uv, da, mask)
    ref = trilinear_sample_plain(flat1, size, offsets, sizes, uv, da, mask)
    idx, wgt = trilinear_taps_card(size, offsets, sizes, uv, da, mask)
    ref_idx, ref_wgt = trilinear_taps(size, offsets, sizes, uv, da, mask)
    torch.cuda.synchronize()
    assert TRILINEAR_SAMPLE.launches == n0 + 1
    assert float((got - ref).abs().max()) <= 1e-5
    assert torch.equal(idx, ref_idx)
    assert float((wgt - ref_wgt).abs().max()) <= 1e-6
    if mask is not None:
        assert bool((got.reshape(mask.shape + (3,))[~mask] == 0).all())


@pytest.mark.parametrize("T,seed,planes,with_mask", SAMPLER_CASES)
def test_trilinear_sample_bwd_kernel_matches_plain(dev, T, seed, planes, with_mask):
    """K4 alone and through autograd: d_uv and d_uv_da within 1e-4, dflat
    within 1e-5 of max|ref| per channel, the reference
    trilinear_sample_bwd_plain for a float64 texture and cotangent (K4 sums
    in float64 where float32 cancels, and float32 atomics add in any
    order); plane-layout gradients for plane inputs; zero-cotangent and
    masked pixels take 0."""
    from vhap_tpu_torch.ops.texture_fetch import (TRILINEAR_SAMPLE_BWD,
                                                  trilinear_sample,
                                                  trilinear_sample_bwd,
                                                  trilinear_sample_bwd_plain)
    flat1, size, offsets, sizes, uv, da, mask, g = _sampler_inputs(
        dev, T, seed, planes, with_mask)
    n0 = TRILINEAR_SAMPLE_BWD.launches
    alone = trilinear_sample_bwd(flat1, size, offsets, sizes, uv, da, mask, g)
    leaves = [x.clone().requires_grad_(True) for x in (uv, da, flat1)]
    out = trilinear_sample(leaves[2], size, offsets, sizes, leaves[0], leaves[1], mask)
    via_autograd = torch.autograd.grad(out, leaves, g)
    refs = trilinear_sample_bwd_plain(flat1.double(), size, offsets, sizes, uv,
                                      da, mask, g.double())
    torch.cuda.synchronize()
    assert TRILINEAR_SAMPLE_BWD.launches == n0 + 2
    for grad in alone[:2]:
        assert (grad.stride(3) > grad.stride(2)) == planes
    for got in (alone, via_autograd):
        for x, ref, tol in zip(got, refs, (1e-4, 1e-4, 1e-5)):
            scale = ref.reshape(-1, ref.shape[-1]).abs().amax(0)
            err = (x.double() - ref).reshape(-1, ref.shape[-1]).abs().amax(0)
            assert bool((scale > 0).all()) and bool((err <= tol * scale).all())
    live = (g.abs().sum(-1) > 0).reshape(uv.shape[:3])
    if mask is not None:
        live &= mask
    assert bool((alone[0][~live] == 0).all()) and bool((alone[1][~live] == 0).all())


def _interp_scene(dev, nf=2, seed=3):
    from vhap_tpu_torch.ops.rasterize import PLANE_KEYS, face_attribute_planes, visibility
    clip, faces = _scene(dev, seed=seed)
    H, W = 64, 256
    tri, _ = visibility(clip, faces, H, W)
    B, F = clip.shape[0], faces.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    p = face_attribute_planes(clip, faces)
    packed = torch.cat([torch.stack([p[k] for k in PLANE_KEYS], 1),
                        torch.randn(B, 15, F, device=dev, generator=g),
                        faces.T[None].float().expand(B, 3, F),
                        torch.randint(0, 4, (B, nf, F), device=dev, generator=g).float(),
                        torch.stack([p[k] for k in PLANE_KEYS[:6]], 1)], 1).contiguous()
    cot = torch.randn(B, 20 + nf, H, W, device=dev, generator=g) * (tri > 0)[:, None]
    return packed, tri, cot


@pytest.mark.parametrize("nf,seed", [(2, 3), (0, 4)])
def test_fused_interp_bwd_kernel_matches_plain(dev, nf, seed):
    from vhap_tpu_torch.ops.interp import (FUSED_INTERP_BWD, GROUPS,
                                           fused_interp, fused_interp_bwd,
                                           fused_interp_bwd_plain, split_channels)
    packed, tri, cot = _interp_scene(dev, nf, seed)
    n0 = FUSED_INTERP_BWD.launches
    got = fused_interp_bwd(packed, tri, cot, nf)
    ref = fused_interp_bwd_plain(packed, tri, cot, nf)
    # the same kernel through autograd, one cotangent per output group
    p = packed.clone().requires_grad_(True)
    out, _ = fused_interp(p, tri, nf)
    cots = split_channels(cot, nf)
    (via_autograd,) = torch.autograd.grad(
        [getattr(out, k) for k in GROUPS if k != "flags" or nf],
        p, [getattr(cots, k) for k in GROUPS if k != "flags" or nf])
    torch.cuda.synchronize()
    assert FUSED_INTERP_BWD.launches == n0 + 2
    assert int((tri > 0).sum()) > 1000
    row_ref = ref.abs().amax(dim=(0, 2))
    assert bool((row_ref > 0).all())
    for x in (got, via_autograd):
        assert bool(((x - ref).abs().amax(dim=(0, 2)) <= 1e-4 * row_ref).all())


def test_wrappers_reject_bad_inputs(dev):
    """The idx/wgt fetch is CPU-only (the card forms taps inside the fused
    sampler); the sampler raises on a float64 uv."""
    from vhap_tpu_torch.ops.texture_fetch import trilinear_sample, weighted_fetch
    flat = torch.rand(21, 3, device=dev)
    idx = torch.zeros(1, 8, 32, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="trilinear_sample"):
        weighted_fetch(flat, idx, torch.rand(1, 8, 32, device=dev))
    with pytest.raises(ValueError, match="float32"):
        trilinear_sample(flat, (4, 4), (0, 16, 20), ((4, 4), (2, 2), (1, 1)),
                         torch.rand(1, 2, 2, 2, device=dev, dtype=torch.float64),
                         torch.rand(1, 2, 2, 4, device=dev))


def test_eval_energy_kernels_match_plain(dev):
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    from vhap_tpu_torch.model.assets import load_flame_assets
    from vhap_tpu_torch.model.flame import FlameHead, FlameTexPainted
    from vhap_tpu_torch.tracker import params as P
    from vhap_tpu_torch.tracker.energy import make_albedo_fn, make_energy_fn
    H, W, B, T = 64, 128, 2, 4
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    head = FlameHead.build(n_shape=20, n_expr=10, assets=a, add_teeth=False,
                           device=dev)
    cfg = BaseTrackingConfig()
    cfg.model.n_shape, cfg.model.n_expr, cfg.model.tex_resolution = 20, 10, 64
    get_albedo = make_albedo_fn(cfg, FlameTexPainted(a.tex_painted, 64, device=dev), None)
    params = P.init_params(T, 20, 10, 100, head.num_verts, 64, True, True, True,
                           True, False, False, device=dev)
    rng = np.random.default_rng(0)
    params["tex_extra"] += torch.as_tensor(
        rng.normal(0, 0.1, (3, 64, 64)).astype(np.float32), device=dev)
    params["translation"][:, 2] = -0.3
    batch = {"rgb": torch.rand(B, H, W, 3, device=dev),
             "lmk2d": torch.rand(B, 70, 3, device=dev) * 64,
             "timestep_index": torch.tensor([0, 2], device=dev),
             "weight": torch.ones(B, device=dev)}
    outs = [make_energy_fn(head, cfg, get_albedo, (H, W), T, None, True,
                           device=dev, use_kernels=k)(params, batch)
            for k in (True, False)]
    (Ek, (lk, ak)), (Ep, (lp, ap)) = outs
    assert float(ak["pred_alpha"].gt(0).float().mean()) > 0.05
    assert abs(float(Ek) - float(Ep)) <= 1e-4 * abs(float(Ep))
    assert float(lk["lmk"]) == float(lp["lmk"])
    assert float((ak["pred_rgb"] - ap["pred_rgb"]).abs().max()) <= 1e-4


def test_train_step_kernels_match_plain(dev):
    """The rgb_sequential_tracking train step at a small size, disturbance
    off: energy terms and gradients through the kernels equal the plain
    path's; with the disturbance on, every kernel launches once a step."""
    from vhap_tpu_torch.ops.interp import FUSED_INTERP_BWD
    from vhap_tpu_torch.ops.texture_fetch import TRILINEAR_SAMPLE_BWD
    from vhap_tpu_torch.tools.train_slice import build_train_slice
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    ts = build_train_slice(device=dev, batch_size=2, image_size=(64, 128),
                           tex_res=64, n_shape=20, n_expr=10)
    s = ts.eval
    (Ek, lk, gk), (Ep, lp, gp) = (
        loss_and_grads(ts.make_energy(k, False), s.params, ts.opt_leaves,
                       s.batch, ts.generator(0)) for k in (True, False))
    assert set(lk) == set(lp)
    for k in lp:
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-4 * abs(float(lp[k])), k
    for k in gp:
        assert float((gk[k] - gp[k]).abs().max()) <= 1e-3 * float(gp[k].abs().max()), k
    init, step = ts.make_step(True, True)
    n0 = (FUSED_INTERP_BWD.launches, TRILINEAR_SAMPLE_BWD.launches)
    _, _, E, _ = step(s.params, init(s.params), s.batch, ts.generator(1))
    torch.cuda.synchronize()
    assert torch.isfinite(E)
    assert (FUSED_INTERP_BWD.launches, TRILINEAR_SAMPLE_BWD.launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("table_batch,C,seed", [(2, 12, 0), (1, 3, 1), (2, 13, 2)])
def test_plane_gather_kernel_matches_plain(dev, table_batch, C, seed):
    """K6: the forward is a copy, bit-identical to torch.gather; the
    backward equals scatter_add_ (in float64: face 0 sums thousands of
    background cotangents, where float32 atomics in any order are a few
    1e-6 of the row apart) within 1e-5 * max|ref| per channel, with a
    cotangent on every pixel (background included: face 0's row)."""
    from vhap_tpu_torch.ops.plane_gather import (PLANE_GATHER, PLANE_GATHER_BWD,
                                                 plane_gather, plane_gather_bwd,
                                                 plane_gather_bwd_plain,
                                                 plane_gather_plain)
    g = torch.Generator(device=dev).manual_seed(seed)
    B, F, H, W = 2, 500, 61, 203
    packed = torch.randn(table_batch, C, F, device=dev, generator=g)
    tri = torch.randint(0, F + 1, (B, H, W), device=dev, generator=g,
                        dtype=torch.int32)
    tri[:, :30] = 0                                  # mostly background rows
    cot = torch.randn(B, C, H, W, device=dev, generator=g)
    n0 = (PLANE_GATHER.launches, PLANE_GATHER_BWD.launches)
    got = plane_gather(packed, tri)
    assert torch.equal(got, plane_gather_plain(packed, tri))
    ref = plane_gather_bwd_plain(tri, cot.double(), table_batch, F)
    p = packed.clone().requires_grad_(True)
    (via_autograd,) = torch.autograd.grad(plane_gather(p, tri), p, cot)
    alone = plane_gather_bwd(tri, cot, table_batch, F)
    torch.cuda.synchronize()
    assert (PLANE_GATHER.launches, PLANE_GATHER_BWD.launches) == (n0[0] + 2, n0[1] + 2)
    scale = ref.abs().amax(dim=(0, 2), keepdim=True)
    for x in (via_autograd, alone):
        assert x.shape == ref.shape
        assert bool(((x.double() - ref).abs() <= 1e-5 * scale).all())


def test_rasterize_uses_visibility_kernel_with_cull_off(dev):
    """K5's path: rasterize() goes through the visibility kernel, with
    culling on and off (the UV layout needs it off)."""
    from vhap_tpu_torch.ops.rasterize import VISIBILITY, rasterize, visibility_plain
    from vhap_tpu_torch.ops.render_uvmap import transform_vt
    clip, faces = _scene(dev, seed=5)
    rng = np.random.default_rng(6)
    vt = torch.as_tensor(rng.uniform(0.05, 0.95, (200, 2)).astype(np.float32),
                         device=dev)
    for vc, cull, size in ((clip, True, (64, 256)), (clip, False, (64, 256)),
                           (transform_vt(vt), False, (128, 128))):
        n0 = VISIBILITY.launches
        _, _, tri = rasterize(vc, faces, size, cull_backfaces=cull)
        ref, _ = visibility_plain(vc, faces, *size, cull)
        torch.cuda.synchronize()
        assert VISIBILITY.launches == n0 + 1
        assert int((tri > 0).sum()) > 100 and torch.equal(tri, ref)


def test_render_rgba_vis_kernels_match_plain(dev):
    """The vis render through K1, K6 and K3 (the fused sample) equals the
    plain path."""
    from vhap_tpu_torch.tools.vis_slice import build_vis_slice
    s = build_vis_slice(device=dev, batch_size=2, image_size=(64, 128),
                        tex_res=64, n_shape=20, n_expr=10)
    for kw in ({}, {"shade_smooth": False}):
        a, b = s.render(True, **kw), s.render(False, **kw)
        assert float((a["rgba"][..., 3] > 0).float().mean()) > 0.05
        for k in a:
            assert float((a[k] - b[k]).abs().max()) <= 1e-5, k


@pytest.mark.parametrize("n_texels,C,seed", [(97, 3, 0), (40000, 3, 1), (5000, 5, 2)])
def test_scatter_taps_kernel_matches_float64(dev, n_texels, C, seed):
    """K8: the value scatter within 1e-5 * max|ref| of a float64 index_add_
    (97 texels: every texel takes hundreds of colliding taps), with dead
    taps (all C values 0) and zero channels of live taps."""
    from vhap_tpu_torch.ops.texture_fetch import (SCATTER_VALS, scatter_taps,
                                                  scatter_vals_plain)
    g = torch.Generator(device=dev).manual_seed(seed)
    B, K, P = 2, 8, 4096
    idx = torch.randint(0, n_texels, (B, K, P), device=dev, generator=g,
                        dtype=torch.int32)
    vals = torch.randn(B, K, C, P, device=dev, generator=g)
    vals[:, :, :, ::3] = 0.0
    vals[:, :, 1, ::5] = 0.0
    n0 = SCATTER_VALS.launches
    got, ovf = scatter_taps(idx, vals, n_texels)
    ref = scatter_vals_plain(idx, vals.double(), n_texels)
    torch.cuda.synchronize()
    assert SCATTER_VALS.launches == n0 + 1 and ovf == 0
    assert got.shape == (n_texels, C) and got.dtype == torch.float32
    assert float((got.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    with pytest.raises(ValueError, match="int32"):
        scatter_taps(idx.long(), vals, n_texels)


def test_dense_bin_mode_runs_the_flat_kernels(dev):
    """render.bin_mode='dense' (the JAX package's K7 path) runs K1, K2f and
    K2b once a train step and equals the flat configuration."""
    import copy

    from vhap_tpu_torch.ops.interp import FUSED_INTERP, FUSED_INTERP_BWD
    from vhap_tpu_torch.tools.train_slice import build_train_slice
    from vhap_tpu_torch.tracker.energy import make_energy_fn
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    ts = build_train_slice(device=dev, batch_size=2, image_size=(64, 128),
                           tex_res=64, n_shape=20, n_expr=10)
    s = ts.eval
    cfg = copy.deepcopy(s.cfg)
    cfg.render.bin_mode = "dense"
    cfg.render.disturb_rate_fg = cfg.render.disturb_rate_bg = None
    dense = make_energy_fn(s.head, cfg, s.get_albedo, s.image_size, 64, ts.stage,
                           with_aux=False, device=dev)
    n0 = (FUSED_INTERP.launches, FUSED_INTERP_BWD.launches)
    Ed, ld, gd = loss_and_grads(dense, s.params, ts.opt_leaves, s.batch,
                                ts.generator(0))
    torch.cuda.synchronize()
    assert (FUSED_INTERP.launches, FUSED_INTERP_BWD.launches) == (n0[0] + 1, n0[1] + 1)
    Ef, lf, gf = loss_and_grads(ts.make_energy(True, False), s.params,
                                ts.opt_leaves, s.batch, ts.generator(0))
    assert float(ld["rast_overflow"]) == 0.0
    assert abs(float(Ed) - float(Ef)) <= 1e-6 * abs(float(Ef))
    for k in gf:
        assert float((gd[k] - gf[k]).abs().max()) <= 1e-5 * float(gf[k].abs().max()), k


def test_tracker_runs_on_the_card(dev, tmp_path):
    """A short photometric tracker run on the card: every rgb train step
    launches K2b once, and the fit descends."""
    from vhap_tpu_torch.ops.interp import FUSED_INTERP_BWD
    from vhap_tpu_torch.tools.validate import run
    n0 = FUSED_INTERP_BWD.launches
    report, _, info = run(tmp_path, frames=4, size=64, batch_size=2,
                          schedule_scale=0.05, num_devices=1)
    torch.cuda.synchronize()
    rgb_steps = sum(n for st, n in info["steps_by_stage"].items() if st.startswith("rgb"))
    assert rgb_steps > 0 and FUSED_INTERP_BWD.launches == n0 + rgb_steps
    assert all(np.isfinite(v) for v in report.values() if isinstance(v, float))
    assert info["device"].startswith("cuda") and info["world"] == 1


@pytest.mark.parametrize("name", ["coplanar_ties", "covering_face", "near_plane",
                                  "crowded_tile", "ragged"])
@pytest.mark.parametrize("size", [None, (250, 333)])
def test_visibility_kernel_on_adversarial_scenes(dev, name, size):
    """K1's tile-binned design bit-identical to the plain version on the
    scenes that stress it: equal-z ties and -0.0 (lowest face id wins), a
    face over most of the image and near-plane straddlers (the shared
    list), a tile with 1256 candidates (its list full, the rest spilled to
    the shared list; 20 shared-memory chunks), ragged sizes."""
    from vhap_tpu_torch.ops.rasterize import VISIBILITY, visibility, visibility_plain
    from vhap_tpu_torch.tools import raster_scenes as rs
    sc = rs.build(name, size=size, device=dev)
    args = (sc["clip"], sc["faces"], sc["H"], sc["W"], sc["cull"])
    n0 = VISIBILITY.launches
    got, ovf = visibility(*args)
    ref, _ = visibility_plain(*args)
    torch.cuda.synchronize()
    assert VISIBILITY.launches == n0 + 1 and ovf == 0
    assert int((ref > 0).sum()) > 100 and torch.equal(got, ref)


def test_visibility_kernel_uv_layout_cull_off(dev):
    """K5's UV-layout call: the synthetic head's texture layout at 1024^2,
    batch 1, culling off, as generate_flame_uvmask renders it."""
    from vhap_tpu_torch.model.assets import load_flame_assets
    from vhap_tpu_torch.ops.rasterize import rasterize, visibility_plain
    from vhap_tpu_torch.ops.render_uvmap import transform_vt
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    vt = torch.as_tensor(np.asarray(a.verts_uvs, np.float32), device=dev)
    faces = torch.as_tensor(np.asarray(a.textures_idx), dtype=torch.long, device=dev)
    vc = transform_vt(vt)
    _, _, tri = rasterize(vc, faces, (1024, 1024), cull_backfaces=False)
    ref, _ = visibility_plain(vc, faces, 1024, 1024, False)
    assert int((ref > 0).sum()) > 1000 and torch.equal(tri, ref)


@pytest.mark.parametrize("name", ["coplanar_ties", "near_plane", "crowded_tile",
                                  "ragged"])
@pytest.mark.parametrize("nf,none", [(0, ("zw", "vids")), (2, ("normal", "flags")),
                                     (2, ())])
def test_fused_interp_bwd_kernel_on_adversarial_scenes(dev, name, nf, none):
    """K2b's tile design within 1e-4 * max|ref| per table row of the plain
    version, with some output groups' cotangent None: the crowded tile fills
    a tile's 256 face slots."""
    from vhap_tpu_torch.ops.interp import (FUSED_INTERP_BWD, GROUPS, _launch_bwd,
                                           _plain_bwd)
    from vhap_tpu_torch.ops.rasterize import visibility
    from vhap_tpu_torch.tools import raster_scenes as rs
    sc = rs.build(name, device=dev)
    tri, _ = visibility(sc["clip"], sc["faces"], sc["H"], sc["W"], sc["cull"])
    packed, grads = rs.interp_inputs(sc, nf, tri, seed=nf, none=none)
    g = [grads[k] for k in GROUPS]
    n0 = FUSED_INTERP_BWD.launches
    got = _launch_bwd(packed.transpose(1, 2).contiguous(), tri, g, nf)
    ref = _plain_bwd(packed, tri, g, nf)
    torch.cuda.synchronize()
    assert FUSED_INTERP_BWD.launches == n0 + 1
    row_ref = ref.abs().amax(dim=(0, 2))
    assert bool(((got - ref).abs().amax(dim=(0, 2)) <= 1e-4 * row_ref).all())
    assert float(row_ref.max()) > 0


# ---------------------------------------------------------------------------
# the calibrated multiview step with the teeth head (4 views at 128^2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mv_slice(dev, tmp_path_factory):
    from vhap_tpu_torch.tools.multiview_slice import build_multiview_slice, write_rig
    root = tmp_path_factory.mktemp("mv")
    write_rig(root, n_cams=4, n_frames=2, size=128, n_shape=20, n_expr=10, device=dev)
    return build_multiview_slice(root, device=dev, n_shape=20, n_expr=10, tex_res=64)


def _teeth_pixels(head, tri_id):
    """(B, H, W) bool: the pixels won by teeth faces."""
    teeth = torch.zeros(head.num_faces + 1, dtype=torch.bool, device=tri_id.device)
    teeth[1 + torch.as_tensor(head.masks.f["teeth"], device=tri_id.device)] = True
    return teeth[tri_id.long()]


def test_multiview_visibility_and_interp_kernels_match_plain(dev, mv_slice):
    """K1 and K2f at the 4 calibrated views' own inputs: tri_id identical
    (the lips around the open mouth over the teeth shells behind them, and
    teeth pixels in every view), K2f within 1e-5 on the foreground."""
    from vhap_tpu_torch.ops import camera as cam
    from vhap_tpu_torch.ops.interp import fused_interp, fused_interp_plain, join_channels
    from vhap_tpu_torch.ops.rasterize import visibility, visibility_plain
    from vhap_tpu_torch.ops.render import pack_face_tables
    from vhap_tpu_torch.tracker.energy import fill_cam_params, render_verts_uv
    s = mv_slice.eval
    H, W = s.image_size
    with torch.no_grad():
        _, (_, aux) = s.make_energy(True)(s.params, s.batch)
        K, RT = fill_cam_params(s.batch, s.params, True, (H, W))
        verts = aux["verts"]
        clip = cam.camera_to_clip(cam.world_to_camera(verts, RT), K, (H, W))
        tri, _ = visibility(clip, s.head.faces, H, W)
        ref, _ = visibility_plain(clip, s.head.faces, H, W)
        assert torch.equal(tri, ref) and int((tri > 0).sum()) > 500
        assert bool((_teeth_pixels(s.head, tri).sum(dim=(1, 2)) > 0).all())
        packed = pack_face_tables(clip, verts, s.head.faces,
                                  render_verts_uv(s.head, dev), s.head.textures_idx)
        got = join_channels(fused_interp(packed, tri, 0)[0])
        want, _ = fused_interp_plain(packed, tri, 0)
    fg = (tri > 0)[:, None]
    assert float(((got - want).abs() / want.abs().clamp(min=1.0) * fg).max()) <= 1e-5


def test_multiview_step_kernels_match_plain(dev, mv_slice):
    """The eval step (K1, K2f, K3 once each) and the train step (K2b, K4
    once) through the kernels against the plain path: eval E 1e-4
    relative; train terms 1e-4 relative, gradients 1e-3 * max|g|."""
    from vhap_tpu_torch.ops.interp import FUSED_INTERP, FUSED_INTERP_BWD
    from vhap_tpu_torch.ops.rasterize import VISIBILITY
    from vhap_tpu_torch.ops.texture_fetch import TRILINEAR_SAMPLE, TRILINEAR_SAMPLE_BWD
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    ts, s = mv_slice, mv_slice.eval
    counters = (VISIBILITY, FUSED_INTERP, TRILINEAR_SAMPLE, FUSED_INTERP_BWD,
                TRILINEAR_SAMPLE_BWD)
    n0 = [c.launches for c in counters]
    with torch.no_grad():
        Ek, _ = s.make_energy(True)(s.params, s.batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, n0)] == [1, 1, 1, 0, 0]
    with torch.no_grad():
        Ep, _ = s.make_energy(False)(s.params, s.batch)
    assert abs(float(Ek) - float(Ep)) <= 1e-4 * abs(float(Ep))
    n0 = [c.launches for c in counters]
    (Ek, lk, gk) = loss_and_grads(ts.make_energy(True, False), s.params, ts.opt_leaves,
                                  s.batch, ts.generator(0))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, n0)] == [1, 1, 1, 1, 1]
    (Ep, lp, gp) = loss_and_grads(ts.make_energy(False, False), s.params,
                                  ts.opt_leaves, s.batch, ts.generator(0))
    assert set(lk) == set(lp)
    for k in lp:
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-4 * abs(float(lp[k])), k
    for k in gp:
        assert float((gk[k] - gp[k]).abs().max()) <= 1e-3 * float(gp[k].abs().max()), k


def test_multiview_step_launches_match_plain_kernels(dev, mv_slice, monkeypatch):
    """K2b, K3 and K4 at the arguments of their own launches in the 4-view
    train step (disturbance on), each against its plain version to its
    gate: K3 within 1e-5 and the same taps on every pixel; K4 d_uv and
    d_uv_da within 1e-4, dflat within 1e-5 of max|ref| per channel against
    the float64 plain version; K2b within 1e-4 of each table row's
    max|ref|. K3 and K4 are held on the pixels won by teeth faces (the
    teeth UV strip at the texture's top edge) as well as on all."""
    from vhap_tpu_torch.ops import interp
    from vhap_tpu_torch.ops import texture_fetch as tf
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    ts, s = mv_slice, mv_slice.eval
    sampler_args, k2b_args = [], []
    launch_sampler_bwd, launch_k2b = tf._launch_bwd, interp._launch_bwd

    def record_sampler(*args):
        sampler_args.append(args)
        return launch_sampler_bwd(*args)

    def record_k2b(table, tri_id, grads, nf):
        k2b_args.append((table, tri_id, list(grads), nf))
        return launch_k2b(table, tri_id, grads, nf)

    monkeypatch.setattr(tf, "_launch_bwd", record_sampler)
    monkeypatch.setattr(interp, "_launch_bwd", record_k2b)
    loss_and_grads(ts.make_energy(True, True), s.params, ts.opt_leaves, s.batch,
                   ts.generator(0))
    monkeypatch.undo()
    assert len(sampler_args) == 1 and len(k2b_args) == 1
    flat1, uv, da, mask, offsets, sizes, g = sampler_args[0]
    table, tri_id, grads, nf = k2b_args[0]
    size = tuple(sizes[0])
    B, P = uv.shape[0], uv.shape[1] * uv.shape[2]
    teeth = _teeth_pixels(s.head, tri_id).reshape(B, P)
    if mask is not None:
        teeth &= mask.reshape(B, P)
    assert int(teeth.sum()) > 0

    # K3
    with torch.no_grad():
        got = tf.trilinear_sample(flat1, size, offsets, sizes, uv, da, mask)
        ref = tf.trilinear_sample_plain(flat1, size, offsets, sizes, uv, da, mask)
        idx, _ = tf.trilinear_taps_card(size, offsets, sizes, uv, da, mask)
        ref_idx, ref_wgt = tf.trilinear_taps(size, offsets, sizes, uv, da, mask)
    err = (got - ref).reshape(B, P, -1).abs().amax(-1)
    assert float(err.max()) <= 1e-5 and float(err[teeth].max()) <= 1e-5
    assert torch.equal(idx, ref_idx)

    # K4, against the float64 chain rule of the same taps
    alone = tf.trilinear_sample_bwd(flat1, size, offsets, sizes, uv, da, mask, g)
    refs = tf.trilinear_sample_bwd_plain(flat1.double(), size, offsets, sizes, uv,
                                         da, mask, g.double())
    texels = torch.zeros(flat1.shape[0], dtype=torch.bool, device=dev)
    texels[ref_idx[teeth[:, None].expand_as(ref_idx) & (ref_wgt != 0)].long()] = True
    for x, r, tol, rows in zip(alone, refs, (1e-4, 1e-4, 1e-5),
                               (teeth.reshape(-1),) * 2 + (texels,)):
        r2 = r.reshape(-1, r.shape[-1])
        scale = r2.abs().amax(0)
        e = (x.double().reshape(-1, r.shape[-1]) - r2).abs()
        assert bool((scale > 0).all())
        assert bool((e.amax(0) <= tol * scale).all())
        assert bool((e[rows].amax(0) <= tol * scale).all())

    # K2b, at its own launch's table, tri_id and per-group cotangents
    d_k = launch_k2b(table, tri_id, grads, nf)
    d_p = interp._plain_bwd(table.transpose(1, 2), tri_id, grads, nf)
    row_ref = d_p.abs().amax(dim=(0, 2))
    assert float(row_ref.max()) > 0
    assert bool(((d_k - d_p).abs().amax(dim=(0, 2)) <= 1e-4 * row_ref).all())


# ---------------------------------------------------------------------------
# the train step captured as one CUDA graph (tracker/step_graph.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr_scale", [1.0, 0.1])
def test_graphed_adam_equals_eager_adam_on_card(dev, lr_scale):
    """make_train_step's Adam on device scalars equals the step on host
    scalars bit for bit on the card too, where PyTorch divides by a host
    scalar through its float32 reciprocal (tests/torch_adam_cases.py)."""
    from torch_adam_cases import check_adam_on_device
    check_adam_on_device(dev, lr_scale)


def _launch_counts():
    from vhap_tpu_torch.ops.kernels import Kernel
    return {k.symbol: k.launches for k in Kernel.made}


def _record_draws(monkeypatch):
    """Every torch.rand / torch.randint result, cloned where it is drawn: a
    graph's clone is rewritten on each replay."""
    draws = []
    for name in ("rand", "randint"):
        real = getattr(torch, name)

        def recorded(*args, _real=real, **kwargs):
            out = _real(*args, **kwargs)
            draws.append(out.clone())
            return out
        monkeypatch.setattr(torch, name, recorded)
    return draws


def _rel_change_gaps(p0, a, b, keys):
    """Per leaf, |‖a - p0‖ - ‖b - p0‖| / ‖b - p0‖ (the benchmark's change)."""
    out = {}
    for k in keys:
        na = float(torch.linalg.vector_norm((a[k] - p0[k]).double()))
        nb = float(torch.linalg.vector_norm((b[k] - p0[k]).double()))
        out[k] = abs(na - nb) / max(nb, 1e-30)
    return out


# The median leaf's change gap (the benchmark's change) after 1-5 chained
# steps from one state and generator seed read up to 7.7e-6 between two eager
# runs over 8 seeds, and 1.06e-5 between the graphed and an eager run (H100,
# PERF.md): a last-bit difference from the kernels' float atomics flips a u8
# colour key of the disturbance's sorted pool, which swaps other pixels in.
# The chained limit leaves about 5x room above the largest reading.
CHAINED_MEDIAN_GAP = 5e-5


def test_graphed_step_matches_eager(dev, monkeypatch):
    """mono512.global's step at full width (rgb_global_tracking at lr scale
    0.1, batch 16, 512^2, texture 2048, disturbance on), 5 steps chained
    from one state and generator seed: the graphed step (1 eager, 1
    capture, 3 replays, the replays alternating the two graphs, each
    reading the graph's own outputs of the step before), and before each
    of its calls the eager step from the same inputs and generator state;
    then a second chain, all eager. At each step of the graphed chain,
    against the eager step from its inputs: the disturbance's draws and the
    generator's state after the step bitwise equal, the kernels' launches
    equal, the energy within 5e-6 (loss), each leaf's change within the
    cell's limits (median leaf 4e-7, worst leaf 5e-4). Against the eager
    chain: draws and generator state bitwise equal, the median leaf's change
    from the start within CHAINED_MEDIAN_GAP, the worst leaf's within
    5e-4."""
    from vhap_tpu_torch.tools.train_slice import build_train_slice
    from vhap_tpu_torch.tracker.optim import make_train_step
    from vhap_tpu_torch.tracker.step_graph import StepGraphs, graphed_train_step
    ts = build_train_slice(device=dev, stage="rgb_global_tracking")
    s = ts.eval
    energy = ts.make_energy(True, True)
    draws = _record_draws(monkeypatch)
    graphs = StepGraphs()
    init, eager_step = make_train_step(energy, ts.opt_leaves, ts.lr_map, 0.1)
    _, graphed_step = graphed_train_step(energy, ts.opt_leaves, ts.lr_map, 0.1, graphs)
    keys = sorted(ts.opt_leaves)

    def call(step, params, state, gen):
        n, n0 = len(draws), _launch_counts()
        p, st, E, _ = step(params, state, s.batch, gen, 1.0)
        torch.cuda.synchronize()
        return p, st, {"E": float(E), "count": int(st["count"]), "draws": draws[n:],
                       "gen": gen.get_state(), "params": {k: v.clone() for k, v in p.items()},
                       "launches": {k: v - n0[k] for k, v in _launch_counts().items()}}

    gen = ts.generator(1234567)
    params, state = s.params, init(s.params)
    graphed, alone, recorded = [], [], {}     # graph -> the draws its capture recorded
    for i in range(5):
        start = gen.get_state()
        alone.append(call(eager_step, params, state, gen)[2])
        gen.set_state(start)
        params, state, g = call(graphed_step, params, state, gen)
        if i == 1:
            recorded = {0: g["draws"][:3], 1: g["draws"][3:]}
        if i >= 1:       # a replay rewrites its capture's clones: keep this one's
            g["draws"] = [d.clone() for d in recorded[(i - 1) % 2]]
        graphed.append(g)
    assert graphs.counts() == {"captures": 1, "replays": 3, "eager": 1}
    gen = ts.generator(1234567)
    params, state, chain = s.params, init(s.params), []
    for i in range(5):
        params, state, e = call(eager_step, params, state, gen)
        chain.append(e)
    prev = s.params
    for i, (g, e, c) in enumerate(zip(graphed, alone, chain)):
        for ref in (e, c):
            assert len(ref["draws"]) == len(g["draws"]) == 3, i
            assert all(torch.equal(a, b) for a, b in zip(ref["draws"], g["draws"])), i
            assert torch.equal(g["gen"], ref["gen"]) and g["count"] == ref["count"] == i + 1, i
        assert g["launches"] == e["launches"] and e["launches"]["vhap_fused_interp_bwd"] == 1, i
        assert abs(g["E"] - e["E"]) <= 5e-6 * abs(e["E"]), (i, g["E"], e["E"])
        one = _rel_change_gaps(prev, g["params"], e["params"], keys)
        chained = _rel_change_gaps(s.params, g["params"], c["params"], keys)
        print(f"step {i + 1}: median leaf change gap, graphed vs eager from its "
              f"inputs {float(np.median(list(one.values()))):.3g}, vs the eager "
              f"chain {float(np.median(list(chained.values()))):.3g}; by leaf {one}")
        assert float(np.median(list(one.values()))) <= 4e-7, (i, one)
        assert max(one.values()) <= 5e-4, (i, one)
        assert float(np.median(list(chained.values()))) <= CHAINED_MEDIAN_GAP, (i, chained)
        assert max(chained.values()) <= 5e-4, (i, chained)
        for k in s.params:
            if k not in ts.opt_leaves:
                assert torch.equal(g["params"][k], s.params[k]), (i, k)
        prev = g["params"]


def test_step_timer_reads_device_intervals(dev):
    """On the card StepTimer's medians time the device between ticks, not
    the host: a tick, 100 ms of device work queued in well under that on
    the host, a tick."""
    from vhap_tpu_torch.util.profiling import StepTimer
    timer = StepTimer(device=dev)
    torch.cuda.synchronize()
    cycles = torch.cuda.get_device_properties(dev).clock_rate * 1000 // 10   # ~0.1 s
    timer.tick("a")
    torch.cuda._sleep(int(cycles))
    timer.tick("a")
    host_ms = timer.stage_deltas["a"][0] * 1e3
    assert host_ms < 50 and 50 < timer.median_ms("a") < 1000, (host_ms, timer.median_ms("a"))
    assert timer.steps_per_sec < 20


@pytest.fixture(scope="module")
def small_train(dev):
    from vhap_tpu_torch.tools.train_slice import build_train_slice
    return build_train_slice(device=dev, batch_size=2, image_size=(64, 128),
                             tex_res=64, n_shape=20, n_expr=10)


def _two_steps(ts, step, init, gen):
    """An eager call and the capture: the graph is live after this."""
    s = ts.eval
    params, state = s.params, init(s.params)
    for _ in range(2):
        params, state, E, log = step(params, state, s.batch, gen, 1.0)
    return params, state


def test_graphed_step_copies_new_inputs_in(dev, small_train):
    """With the graph live, a new parameter object, a new batch object and a
    fresh Adam state are copied into the graph's buffers: the replay's
    energy and parameters equal the eager step's from the same inputs and
    generator state."""
    from vhap_tpu_torch.tracker.optim import make_train_step
    from vhap_tpu_torch.tracker.step_graph import graphed_train_step
    ts, s = small_train, small_train.eval
    energy = ts.make_energy(True, True)
    init, step = graphed_train_step(energy, ts.opt_leaves, ts.lr_map)
    _, eager_step = make_train_step(energy, ts.opt_leaves, ts.lr_map)
    gen = ts.generator(5)
    params, state = _two_steps(ts, step, init, gen)
    assert step.graph is not None
    new_params = {k: v.clone() for k, v in params.items()}
    new_params["shape"] = params["shape"] + 0.05             # a frozen leaf
    new_params["expr"] = params["expr"] * 0.5                # an optimized one
    new_batch = dict(s.batch, rgb=s.batch["rgb"].flip(2).contiguous())
    expr_before = new_params["expr"].clone()
    fresh = init(new_params)
    ref_gen = ts.generator(0)
    ref_gen.set_state(gen.get_state())
    ref = eager_step({k: v.clone() for k, v in new_params.items()}, init(new_params),
                     new_batch, ref_gen, 1.0)
    out = step(new_params, fresh, new_batch, gen, 1.0)
    torch.cuda.synchronize()
    assert step.graphs.counts()["replays"] == 1
    assert out[0]["shape"] is step.frozen["shape"]
    assert torch.equal(out[0]["shape"], new_params["shape"])
    assert abs(float(out[2]) - float(ref[2])) <= 5e-6 * abs(float(ref[2]))
    assert int(out[1]["count"]) == int(ref[1]["count"]) == 1
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    gaps = _rel_change_gaps(new_params, out[0], ref[0], sorted(ts.opt_leaves))
    assert float(np.median(list(gaps.values()))) <= 4e-7, gaps
    assert max(gaps.values()) <= 5e-4, gaps
    assert torch.equal(new_params["expr"], expr_before)    # the caller's, untouched


def test_graphed_step_leaves_its_inputs(dev, small_train):
    """As the eager step, a graphed call writes none of the tensors it is
    given, also when they are the previous call's outputs: the calls
    alternate between the graphs' two buffer sets."""
    from vhap_tpu_torch.tracker.step_graph import graphed_train_step
    ts, s = small_train, small_train.eval
    init, step = graphed_train_step(ts.make_energy(True, True), ts.opt_leaves,
                                    ts.lr_map)
    gen = ts.generator(8)
    params, state = s.params, init(s.params)
    for i in range(5):
        before = ({k: v.clone() for k, v in params.items()},
                  {m: {k: v.clone() for k, v in state[m].items()} for m in ("mu", "nu")})
        new, new_state, E, _ = step(params, state, s.batch, gen, 1.0)
        torch.cuda.synchronize()
        for k in ts.opt_leaves:
            assert new[k] is not params[k] and new_state["mu"][k] is not state["mu"][k]
            assert not torch.equal(new[k], params[k]), (i, k)
        for k, v in params.items():
            assert torch.equal(v, before[0][k]), (i, k)
        for m in ("mu", "nu"):
            for k, v in state[m].items():
                assert torch.equal(v, before[1][m][k]), (i, m, k)
        params, state = new, new_state
    assert step.graphs.counts() == {"captures": 1, "replays": 3, "eager": 1}
    assert int(state["count"]) == 5


def test_graphed_step_other_shape_runs_eager(dev, small_train):
    """A batch of another shape runs the eager step (its outputs are new
    tensors, the graph's buffers untouched); the captured shape replays
    again after it."""
    from vhap_tpu_torch.tracker.step_graph import graphed_train_step
    ts, s = small_train, small_train.eval
    init, step = graphed_train_step(ts.make_energy(True, True), ts.opt_leaves,
                                    ts.lr_map)
    gen = ts.generator(6)
    params, state = _two_steps(ts, step, init, gen)
    one = {k: v[:1].contiguous() for k, v in s.batch.items()}
    p1, st1, E1, _ = step(params, state, one, gen, 1.0)
    assert step.graphs.counts() == {"captures": 1, "replays": 0, "eager": 2}
    assert torch.isfinite(E1) and int(st1["count"]) == 3
    assert all(st1["count"] is not b["count"] for b in step.sets)
    assert all(p1["expr"] is not b["params"]["expr"] for b in step.sets)
    p2, st2, E2, _ = step(p1, st1, s.batch, gen, 1.0)
    torch.cuda.synchronize()
    assert step.graphs.counts() == {"captures": 1, "replays": 1, "eager": 2}
    assert int(st2["count"]) == 4 and torch.isfinite(E2)


def test_capturing_another_step_releases_the_graph(dev, small_train):
    """One live graph per tracker: capturing a second (stage, lr_scale)
    step releases the first one's graph and buffers; called again, the first
    captures anew."""
    from vhap_tpu_torch.tracker.step_graph import StepGraphs, graphed_train_step
    ts = small_train
    graphs = StepGraphs()
    energy = ts.make_energy(True, True)
    a = graphed_train_step(energy, ts.opt_leaves, ts.lr_map, 1.0, graphs)
    b = graphed_train_step(energy, ts.opt_leaves, ts.lr_map, 0.1, graphs)
    gen = ts.generator(7)
    _two_steps(ts, a[1], a[0], gen)
    assert graphs.live is a[1] and a[1].graph is not None
    _two_steps(ts, b[1], b[0], gen)
    assert graphs.live is b[1] and b[1].graph is not None
    assert a[1].graph is None and a[1].sets is None
    _two_steps(ts, a[1], a[0], gen)       # warm already: both calls graphed
    assert graphs.live is a[1] and b[1].graph is None
    assert graphs.counts() == {"captures": 3, "replays": 1, "eager": 2}


def test_graphed_step_two_nccl_ranks(dev, tmp_path):
    """The sharded step on the graphed path: two NCCL ranks (cuda:0 and
    cuda:1, sharding.launch) each run the 4-view multiview step at 128^2
    (2 views a rank, disturbance on) 5 steps chained, as
    test_graphed_step_matches_eager on one card, with its tolerances and
    their reasons: against the eager step from each call's inputs, the
    draws, the generator's state and the kernels' launches equal, the
    energy within 5e-6, the median leaf's change within 4e-7 and the worst
    within 5e-4; against an eager chain, the draws and generator states
    equal, the median leaf's change within CHAINED_MEDIAN_GAP and the
    worst within 5e-4. Both ranks capture on their second call and replay
    after it, with the gradient bucket all-reduced inside the graph, and
    the replicas' parameters and Adam state are bit-identical after every
    step."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: one NCCL rank per card")
    import torch_sharding_cases as C
    from vhap_tpu_torch.parallel import sharding
    from vhap_tpu_torch.tools.multiview_slice import write_rig
    write_rig(tmp_path, n_cams=4, n_frames=2, size=128, n_shape=20, n_expr=10, device=dev)
    ranks = sharding.launch(C.graphed_nccl_steps, ["cuda:0", "cuda:1"], "nccl",
                            args=(str(tmp_path),), timeout=300, join_timeout=900)
    for r in ranks:
        assert r["capturable"] and r["graph"] == {"captures": 1, "replays": 3, "eager": 1}
        assert r["tally"]["grads"]["calls"] == 1 and r["tally"]["grads"]["bytes"] > 0
    for i, steps in enumerate(zip(*(r["steps"] for r in ranks))):
        E = [sum(st["E"][j] for st in steps) for j in (0, 1)]
        assert abs(E[0] - E[1]) <= 5e-6 * abs(E[1]), (i, E)
        assert len({st["digest"][0] for st in steps}) == 1, i     # the replicas
        assert len({st["digest"][1] for st in steps}) == 1, i
        for st in steps:
            assert st["count"] == [i + 1] * 3 and min(st["n_draws"]) > 0, (i, st["count"])
            assert all(st["draws_equal"]) and all(st["gen_equal"]), i
            g, e = st["launches"]
            assert g == e and e["vhap_fused_interp_bwd"] == 1, (i, g, e)
            one, chained = st["one"], st["chained"]
            print(f"step {i + 1}: median leaf change gap, graphed vs eager from its "
                  f"inputs {float(np.median(list(one.values()))):.3g}, vs the eager "
                  f"chain {float(np.median(list(chained.values()))):.3g}")
            assert float(np.median(list(one.values()))) <= 4e-7, (i, one)
            assert max(one.values()) <= 5e-4, (i, one)
            assert float(np.median(list(chained.values()))) <= CHAINED_MEDIAN_GAP, (i, chained)
            assert max(chained.values()) <= 5e-4, (i, chained)
