"""Port parity for the whole slice: the evaluation energy of vhap_tpu_torch
against the JAX package's make_energy_fn(..., stage_name=None,
with_aux=True), with the parameters carried across by
vhap_tpu_torch.convert (tiny synthetic head, 32x128, tex 64, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.config.base import BaseTrackingConfig as JConfig
from vhap_tpu.model.assets import load_flame_assets
from vhap_tpu.model.flame import FlameHead as JHead
from vhap_tpu.model.flame import FlameTexPainted as JTex
from vhap_tpu.tracker import params as JP
from vhap_tpu.tracker.energy import make_albedo_fn as j_albedo
from vhap_tpu.tracker.energy import make_energy_fn as j_energy
from vhap_tpu_torch.config.base import BaseTrackingConfig as TConfig
from vhap_tpu_torch.config.base import RenderConfig
from vhap_tpu_torch.convert import head_from_assets, params_from_numpy
from vhap_tpu_torch.model.flame import FlameTexPainted as TTex
from vhap_tpu_torch.tracker.energy import make_albedo_fn as t_albedo
from vhap_tpu_torch.tracker.energy import make_energy_fn as t_energy

NS, NE, R, H, W, B, T = 20, 10, 64, 32, 128, 2, 4


def _config(cls, background):
    cfg = cls()
    cfg.model.n_shape, cfg.model.n_expr, cfg.model.tex_resolution = NS, NE, R
    cfg.render.background_eval = background
    return cfg


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    a.tex_painted = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    jh = JHead.build(n_shape=NS, n_expr=NE, assets=a, add_teeth=False)
    th = head_from_assets(a, NS, NE, device="cpu")
    p = {k: np.array(v) for k, v in JP.init_params(
        T, NS, NE, 100, jh.num_verts, R, True, True, True, True, False,
        False).items()}
    p["translation"][:, 2] = -0.3
    p["expr"] = rng.normal(0, 0.5, p["expr"].shape).astype(np.float32)
    p["rotation"] = rng.normal(0, 0.2, p["rotation"].shape).astype(np.float32)
    p["tex_extra"] = rng.normal(0, 0.1, p["tex_extra"].shape).astype(np.float32)
    p["lights"] = p["lights"] + rng.normal(0, 0.3, (9, 3)).astype(np.float32)
    p["static_offset"] = rng.normal(0, 2e-3, p["static_offset"].shape).astype(np.float32)
    batch = {
        "rgb": rng.uniform(size=(B, H, W, 3)).astype(np.float32),
        "lmk2d": np.concatenate([rng.uniform(0, 128, (B, 70, 2)),
                                 rng.uniform(size=(B, 70, 1))], -1).astype(np.float32),
        "timestep_index": np.array([1, 3], np.int32),
        "weight": np.array([1.0, 1.0], np.float32),
    }
    return a, jh, th, p, batch


@pytest.mark.parametrize("background", ["target", "white"])
def test_eval_energy_matches_jax(setup, background):
    a, jh, th, p, batch = setup
    jc, tc = _config(JConfig, background), _config(TConfig, background)
    jen = j_energy(jh, jc, j_albedo(jc, JTex(a.tex_painted, R), None), (H, W),
                   T, None, with_aux=True)
    jE, (jlog, jaux) = jax.jit(jen)(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    ten = t_energy(th, tc, t_albedo(tc, TTex(a.tex_painted, R, device="cpu"), None),
                   (H, W), T, None, with_aux=True, device="cpu")
    tE, (tlog, taux) = ten(params_from_numpy(p, device="cpu"),
                           {k: torch.as_tensor(v) for k, v in batch.items()})

    assert set(tlog) == set(jlog)
    assert set(jaux) <= set(taux)
    for k in ("lmk", "photo", "total"):
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(tE), float(jE), rtol=1e-4)
    assert float(tlog["rast_overflow"]) == 0.0
    assert float(np.asarray(jaux["pred_alpha"]).mean()) > 0.05
    for k in ("pred_rgb", "pred_alpha", "pred_lmk2d", "verts", "lmks",
              "albedo_map", "photo_per_sample"):
        ref = np.asarray(jaux[k])
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(taux[k].numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_eval_slice_builds_rendered_targets():
    """The bench-shaped evaluation step of chip_smoke.py, at a tiny size on
    the CPU: targets are the head rendered on white, landmarks in pixels,
    and the energy runs the same through the wrappers and the plain
    versions."""
    from vhap_tpu_torch.tools.eval_slice import build_eval_slice
    s = build_eval_slice(device="cpu", batch_size=2, image_size=(H, W),
                         tex_res=R, n_shape=NS, n_expr=NE)
    rgb, lmk = s.batch["rgb"], s.batch["lmk2d"]
    assert rgb.shape == (2, H, W, 3) and lmk.shape == (2, 70, 3)
    assert 0.0 <= float(rgb.min()) and float(rgb.max()) <= 1.0 + 1e-6
    assert float((rgb < 1.0).any(-1).float().mean()) > 0.05    # head on white
    E, (log, _) = s.make_energy(True)(s.params, s.batch)
    Ep, (log_p, _) = s.make_energy(False)(s.params, s.batch)
    assert torch.isfinite(E) and float(log["lmk"]) > 0
    assert float(E) == float(Ep)


def test_training_stage_raises(setup):
    """A training stage builds (slice 2); its energy takes a generator for
    the cluster disturbance and raises without one."""
    a, _, th, p, batch = setup
    cfg = _config(TConfig, "target")
    en = t_energy(th, cfg, t_albedo(cfg, TTex(a.tex_painted, R, device="cpu"), None),
                  (H, W), T, "rgb_sequential_tracking", device="cpu")
    params = params_from_numpy(p, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    E, (log, _) = en(params, tb, torch.Generator().manual_seed(0))
    assert torch.isfinite(E) and {"photo", "smooth_pose", "reg_tex_tv"} <= set(log)
    with pytest.raises(ValueError, match="Generator"):
        en(params, tb)


def test_energy_device_must_match_head(setup):
    a, _, th, _, _ = setup
    cfg = _config(TConfig, "target")
    with pytest.raises(ValueError, match="head lives on"):
        t_energy(th, cfg, None, (H, W), T, None, device="meta")


PORTED_KNOBS = {("bin_mode", "dense")}


@pytest.mark.parametrize("field,value", [
    ("backend", "pallas"), ("plane_impl", "pallas"), ("interp_impl", "fused"),
    ("bin_mode", "dense"), ("layout", "tiled"), ("pad_to_tiles", False),
    ("color_dtype", "bf16"), ("texture_grad_impl", "pallas_bf16"),
    ("max_faces_per_tile", 512), ("plane_max_list", 64),
    ("texture_grad_mode", "bilinear"), ("disturb_impl", "pairswap"),
    ("backend", "xla"), ("layout", "image"), ("color_dtype", "f32"),
    ("texture_grad_impl", "xla"), ("texture_grad_impl", "xla_fetch"),
    ("texture_grad_impl", "pallas")])
def test_tpu_only_render_knobs_rejected(field, value):
    if (field, value) in PORTED_KNOBS:
        # dense tile lists (the JAX package's K7 path) run the port's one
        # fused path since slice 4: accepted, before and after construction
        cfg = RenderConfig(**{field: value})
        setattr(cfg, field, value)
        cfg.check_portable()
        return
    with pytest.raises(ValueError, match="TPU-only"):
        RenderConfig(**{field: value})
    cfg = RenderConfig()
    setattr(cfg, field, value)          # set after construction: still caught
    with pytest.raises(ValueError, match=field):
        cfg.check_portable()


def test_render_defaults_and_portable_values_accepted():
    # each TPU-only knob is accepted at its default, and only there
    RenderConfig()
    RenderConfig(backend="auto", plane_impl="auto", interp_impl="auto",
                 bin_mode="auto", layout="auto", pad_to_tiles=True,
                 color_dtype="auto", texture_grad_mode="trilinear",
                 texture_grad_impl="auto", max_faces_per_tile=0,
                 plane_max_list=0, disturb_impl="auto")
    # the sampling disturbance is ported: "auto" resolves to it
    RenderConfig(disturb_impl="sample").check_portable()
    # every bin_mode selects the port's one fused path (slice 4)
    for bin_mode in ("flat", "dense"):
        RenderConfig(bin_mode=bin_mode).check_portable()
