"""Port parity of the visualization render against the JAX package on the
CPU: `render_rgba_vis` over its branches (the slice as a whole, forward)
and the gradient of the differentiable chain of tools/vis_slice.py
(rasterize -> interpolate -> texture_sample -> shade -> antialias_rast),
both against JAX run op by op with its visibility jitted (see
tests/test_torch_vis.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vis import H, W, _jax_rasterize_with, _jax_tri_id, _np, _slice, _t
from vhap_tpu.ops import antialias as jaa
from vhap_tpu.ops import rasterize as jr
from vhap_tpu.ops import render as jrender
from vhap_tpu.ops import shading as jsh
from vhap_tpu.ops import texture as jtex
from vhap_tpu_torch.ops import render as trender


# ---------------------------------------------------------------------------
# render_rgba_vis (the slice as a whole, forward)
# ---------------------------------------------------------------------------

VIS_CASES = {      # every branch: normals, albedo source, lighting, bg, AA
    "default": {},                                   # smooth, texture, SH, AA
    "flat_camera_bg": dict(shade_smooth=False, lighting_space="camera",
                           background=(0.2, 0.3, 0.4)),
    "v_color_no_aa": dict(tex=None, v_color="rand", antialias=False,
                          lights=None, lighting_type="front-range"),
    "white_front": dict(tex=None, lights=None, lighting_type="front"),
}


@pytest.mark.parametrize("case", list(VIS_CASES))
def test_render_rgba_vis_matches_jax(case, monkeypatch):
    """Against op-by-op JAX (its visibility jitted, see
    tests/test_torch_vis.py)."""
    s = _slice()
    head = s.eval.head
    opt = dict(VIS_CASES[case])
    settings_kw = {k: opt.pop(k) for k in ("lighting_type", "lighting_space",
                                           "antialias") if k in opt}
    bg = opt.pop("background", (1.0, 1.0, 1.0))
    inputs = dict(verts_uv=s.verts_uv, faces_uv=head.textures_idx, tex=s.tex,
                  lights=s.lights)
    if opt.pop("v_color", None):
        rng = np.random.default_rng(3)
        inputs["v_color"] = _t(rng.uniform(size=(head.num_verts, 3)).astype(np.float32))
    inputs.update(opt)
    got = s.render(settings=trender.RenderSettings(**settings_kw),
                   background_color=bg, **inputs)
    jset = jrender.RenderSettings(backend="xla", color_dtype="f32", **settings_kw)
    clip = trender.cam.world_to_clip(s.verts, s.RT, s.K, (H, W))
    monkeypatch.setattr(jrender, "rasterize", _jax_rasterize_with(
        _jax_tri_id(_np(clip), _np(head.faces), (H, W))))
    ref = jrender.render_rgba_vis(
        jnp.asarray(_np(s.verts)), jnp.asarray(_np(head.faces)),
        jnp.asarray(_np(s.RT)), jnp.asarray(_np(s.K)), (H, W), jset, bg,
        **{k: v if v is None or isinstance(v, bool) else jnp.asarray(_np(v))
           for k, v in inputs.items()})
    assert float((got["rgba"][..., 3] > 0).float().mean()) > 0.05
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_render_rgba_vis_plain_setting_matches_kernels_route():
    """use_kernels=False selects the plain versions: on the CPU both routes
    are the plain versions and agree exactly."""
    s = _slice()
    a, b = s.render(True), s.render(False)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the differentiable chain (vis_slice.grad_loss) against eager JAX
# ---------------------------------------------------------------------------

def test_vis_grad_chain_matches_eager_jax():
    s = _slice()
    head = s.eval.head
    faces, fuv = jnp.asarray(_np(head.faces)), jnp.asarray(_np(head.textures_idx))
    RT, K, uv = (jnp.asarray(_np(x)) for x in (s.RT, s.K, s.verts_uv))
    lights = jnp.asarray(_np(s.lights))
    cot = np.random.default_rng(5).normal(size=(2, H, W, 4)).astype(np.float32)
    from vhap_tpu.ops import camera as jcam
    jrast = _jax_rasterize_with(_jax_tri_id(
        jcam.world_to_clip(jnp.asarray(_np(s.verts)), RT, K, (H, W)), faces, (H, W)))

    def jloss(verts, tex):
        clip = jcam.world_to_clip(verts, RT, K, (H, W))
        rast, rast_db, tri_id = jrast(clip, faces, (H, W))
        texc, texd = jr.interpolate(uv[None], rast, fuv, rast_db=rast_db,
                                    diff_attrs="all")
        albedo = jtex.texture_sample(jnp.transpose(tex, (0, 2, 3, 1)), texc, texd)
        normal, _ = jr.interpolate(jsh.compute_v_normals(verts, faces), rast, faces)
        rgb = albedo * jsh.shade(jsh.safe_normalize(normal), "SH", lights)
        fg = (tri_id > 0)[..., None]
        rgba = jnp.concatenate([jnp.where(fg, rgb, 1.0), fg.astype(rgb.dtype)], -1)
        return jnp.sum(jaa.antialias(rgba, rast, clip, faces) * cot)

    v_np, t_np = _np(s.verts), _np(s.tex)
    L_ref, (gv_ref, gt_ref) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(v_np), jnp.asarray(t_np))
    v, t = _t(v_np).requires_grad_(True), _t(t_np).requires_grad_(True)
    L = s.grad_loss(v, t, _t(cot))
    gv, gt = torch.autograd.grad(L, (v, t))
    assert abs(float(L.detach()) - float(L_ref)) <= 1e-5 * abs(float(L_ref))
    for got, ref in ((gv, gv_ref), (gt, gt_ref)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
