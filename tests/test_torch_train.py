"""Port parity of the training step against the JAX package (tiny synthetic
head, 32x128, tex 64, n_shape 20, n_expr 10, CPU): the cluster
disturbance by distribution, every regularizer term, the whole training
energy and its gradient (also on 2 gloo ranks, vhap_tpu_torch/parallel/
sharding.py, against the same eager JAX reference), leaf-lr Adam,
copy_forward and the npz round trip."""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vhap_tpu.config.base import BaseTrackingConfig as JConfig
from vhap_tpu.model.assets import load_flame_assets
from vhap_tpu.model.flame import FlameHead as JHead
from vhap_tpu.model.flame import FlameTexPainted as JTex
from vhap_tpu.model.flame import laplacian_apply as j_lap
from vhap_tpu.model.flame import laplacian_blur_apply as j_blur
from vhap_tpu.tracker import energy as JE
from vhap_tpu.tracker import optim as JO
from vhap_tpu.tracker import params as JP
from vhap_tpu_torch.config.base import BaseTrackingConfig as TConfig
from vhap_tpu_torch.convert import head_from_assets, params_from_numpy
from vhap_tpu_torch.model.flame import FlameTexPainted as TTex
from vhap_tpu_torch.model.flame import laplacian_apply as t_lap
from vhap_tpu_torch.model.flame import laplacian_blur_apply as t_blur
from vhap_tpu_torch.ops.render import _cluster_disturbance
from vhap_tpu_torch.tracker import energy as TE
from vhap_tpu_torch.tracker import optim as TO
from vhap_tpu_torch.tracker import params as TP

import torch_sharding_cases as C
from vhap_tpu_torch.parallel import sharding

NS, NE, R, H, W, B, T = 20, 10, 64, 32, 128, 2, 4
TRAIN_STAGES = ("rgb_sequential_tracking", "rgb_init_offset")


def _np_dict(d):
    return {k: np.asarray(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# (c) the cluster disturbance, by distribution (tests/test_render_ops.py
#     TestClusterDisturbance, on the port's function)
# ---------------------------------------------------------------------------

def _disturb(rate_fg=1.0, rate_bg=1.0, seed=0, Bd=2, Hd=16, Wd=16, stride=1):
    rng = np.random.default_rng(seed)
    cid = torch.as_tensor(rng.integers(0, 4, (Bd, Hd, Wd)), dtype=torch.int32)
    fg = (cid > 0)[..., None]
    rgb = torch.as_tensor(rng.uniform(0.0, 2.0, (Bd, Hd, Wd, 3)), dtype=torch.float32)
    rgba_bg = torch.tensor([1.0, 1.0, 1.0, 0.0]).expand(Bd, Hd, Wd, 4)
    rgba = torch.where(fg, torch.cat([rgb, fg.float()], -1), rgba_bg)
    gen = torch.Generator().manual_seed(seed)
    out = _cluster_disturbance(rgba, rgba_bg, cid, gen, rate_fg, rate_bg,
                               num_clusters=4, pool_stride=stride)
    return rgba.numpy(), out.numpy(), cid.numpy()


def test_disturbance_alpha_untouched_and_cluster1_fixed():
    rgba, out, cid = _disturb()
    np.testing.assert_array_equal(out[..., 3], rgba[..., 3])
    m1 = cid == 1
    np.testing.assert_allclose(out[m1], rgba[m1], atol=1e-6)


@pytest.mark.parametrize("stride,size", [(1, (16, 16)), (4, (32, 128))])
def test_disturbance_values_come_from_own_cluster(stride, size):
    rgba, out, cid = _disturb(stride=stride, Hd=size[0], Wd=size[1])
    # every output pixel's rgb matches SOME pixel of its own cluster
    # (8-bit-over-[0,2) tolerance of the packed sort key)
    for c in (0, 2, 3):
        pool = rgba[cid == c][:, :3]
        got = out[cid == c][:, :3]
        d = np.abs(got[:, None, :] - pool[None, :, :]).max(-1).min(1)
        assert d.max() < 1e-2, (c, d.max())
    changed = np.abs(out[cid >= 2][:, :3] - rgba[cid >= 2][:, :3]).max(-1) > 1e-3
    assert changed.mean() > 0.5, changed.mean()     # rate 1 really swaps


def test_disturbance_rate_none_is_identity():
    rgba, out, _ = _disturb(rate_fg=None, rate_bg=None)
    np.testing.assert_allclose(out, rgba, atol=1e-6)


def test_disturbance_rate_matches_bernoulli():
    rgba, out, cid = _disturb(rate_fg=0.5, rate_bg=0.5, seed=5, Hd=32, Wd=32)
    for m in (cid >= 2, cid == 0):
        changed = np.abs(out[m][:, :3] - rgba[m][:, :3]).max(-1) > 1e-3
        # P(change) = rate * P(sample differs from own pixel) ~ rate
        assert 0.3 < changed.mean() < 0.6, changed.mean()


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_disturbance_rgb_gradient_is_keep_weight(rate):
    """Swapped-in values are detached: a pixel's rgb gradient is 1 - w
    (0 where swapped, 1 where kept); alpha keeps gradient 1."""
    rng = np.random.default_rng(3)
    cid = torch.as_tensor(rng.integers(2, 4, (1, 8, 8)), dtype=torch.int32)
    rgba_bg = torch.tensor([1.0, 1.0, 1.0, 0.0]).expand(1, 8, 8, 4)
    x = torch.as_tensor(rng.uniform(size=(1, 8, 8, 4)), dtype=torch.float32)
    x.requires_grad_(True)
    out = _cluster_disturbance(x, rgba_bg, cid, torch.Generator().manual_seed(0),
                               rate, rate, num_clusters=4)
    (g,) = torch.autograd.grad(out.sum(), x)
    g = g.numpy()
    np.testing.assert_allclose(g[..., 3], 1.0)
    kept = g[..., :3] == 1.0
    assert np.all(kept | (g[..., :3] == 0.0))
    assert np.all(kept == kept[..., :1])            # one w per pixel
    if rate == 1.0:
        assert not kept.any()
    else:
        assert 0.2 < kept[..., 0].mean() < 0.8
        o = out.detach().numpy()[..., :3]
        np.testing.assert_array_equal(o[kept], x.detach().numpy()[..., :3][kept])


def test_disturbance_excludes_padded_frames_from_pool():
    """Weight-0 padded frames never donate pixels: with rate 1 and only
    frame 0 in the pool, every swapped value comes from frame 0."""
    rng = np.random.default_rng(7)
    cid = torch.as_tensor(rng.integers(2, 4, (1, 16, 16)), dtype=torch.int32).expand(2, 16, 16)
    rgb0 = rng.uniform(0.0, 1.0, (1, 16, 16, 3))
    rgb = torch.as_tensor(np.concatenate([rgb0, rgb0 + 10.0]), dtype=torch.float32)
    rgba = torch.cat([rgb, torch.ones(2, 16, 16, 1)], -1)
    rgba_bg = torch.tensor([1.0, 1.0, 1.0, 0.0]).expand(rgba.shape)

    def run(weight):
        return _cluster_disturbance(rgba, rgba_bg, cid, torch.Generator().manual_seed(0),
                                    1.0, 1.0, num_clusters=4,
                                    sample_weight=weight).numpy()

    # frame 1's values clip to 2.0 in the packed key: leaks would read 2.0
    assert run(torch.tensor([1.0, 0.0]))[0, ..., :3].max() < 1.5
    assert run(None)[0, ..., :3].max() > 1.5       # without it they leak


def test_disturbance_same_generator_seed_same_output():
    _, a, _ = _disturb(rate_fg=0.5, rate_bg=0.5, seed=11)
    _, b, _ = _disturb(rate_fg=0.5, rate_bg=0.5, seed=11)
    _, c, _ = _disturb(rate_fg=0.5, rate_bg=0.5, seed=12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_disturbance_pairswap_not_ported():
    rgba = torch.zeros(1, 4, 4, 4)
    with pytest.raises(NotImplementedError, match="pairswap"):
        _cluster_disturbance(rgba, rgba, torch.zeros(1, 4, 4, dtype=torch.int32),
                             torch.Generator(), 0.5, 0.5, 4, impl="pairswap")


# ---------------------------------------------------------------------------
# shared setup: both heads from one set of synthetic assets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def heads():
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    a.tex_painted = np.random.default_rng(3).integers(0, 256, (16, 16, 3)).astype(np.uint8)
    clusters = JConfig().model.tex_clusters
    jh = JHead.build(n_shape=NS, n_expr=NE, assets=a, add_teeth=False,
                     face_clusters=clusters)
    th = head_from_assets(a, NS, NE, face_clusters=clusters, device="cpu")
    return a, jh, th


def test_laplacian_matches(heads):
    _, jh, th = heads
    x = np.random.default_rng(0).normal(size=(2, th.num_verts, 3)).astype(np.float32)
    for jf, tf in ((j_lap, t_lap), (j_blur, t_blur)):
        ref = np.asarray(jf(jh.lap_nbr_idx, jh.lap_nbr_w, jnp.asarray(x)))
        got = tf(th.lap_nbr_idx, th.lap_nbr_w, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) every regularizer term against regularization_energy
# ---------------------------------------------------------------------------

REG_TERMS = {"smooth_pose", "reg_joint", "smooth_joint", "reg_expr",
             "smooth_expr", "reg_shape", "reg_tex_pca", "reg_tex_tv",
             "reg_tex_res_clusters", "reg_light", "reg_diffuse",
             "reg_offset_lap", "reg_offset", "reg_offset_rigid",
             "reg_offset_dynamic"}


def _reg_config(cls, stage):
    cfg = cls()
    cfg.model.n_shape, cfg.model.n_expr, cfg.model.tex_resolution = NS, NE, R
    if stage == "rgb_global_tracking":
        cfg.model.use_dynamic_offset = True
        cfg.model.tex_painted = False           # reg_tex_pca
        cfg.w.reg_light = 1e-1
        cfg.w.blur_iter = 2
    return cfg


@pytest.mark.parametrize("stage", ["rgb_sequential_tracking", "rgb_global_tracking"])
def test_regularizers_match(heads, stage):
    _, jh, th = heads
    jc, tc = _reg_config(JConfig, stage), _reg_config(TConfig, stage)
    rng = np.random.default_rng(5)
    V = th.num_verts
    p = {k: np.asarray(v) for k, v in JP.init_params(
        T, NS, NE, 16, V, R, jc.model.tex_painted, True, True, True,
        jc.model.use_dynamic_offset, False).items()}
    p = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32) for k, v in p.items()}
    batch = {"timestep_index": np.array([0, 2], np.int32),
             "weight": np.array([1.0, 0.5], np.float32)}
    verts_cano = rng.normal(0, 0.1, (B, V, 3)).astype(np.float32)
    albedo = rng.uniform(size=(1, 3, R, R)).astype(np.float32)
    diffuse = rng.uniform(0.5, 1.3, (B, H, W, 3)).astype(np.float32)
    uvmask = rng.uniform(size=(1, 32, 32)) < 0.3     # hand-made UV mask
    opt = {k: False for k in ("cam", "pose", "shape", "joints", "expr",
                              "texture", "lights", "static_offset",
                              "dynamic_offset")}
    for k in jc.pipeline[stage].optimizable_params:
        opt[k] = True

    jpre = JE.build_reg_precomputed(jh, jc)
    tpre = TE.build_reg_precomputed(th, tc)
    for f in ("offset_relax_w", "offset_lap_relax_w"):
        np.testing.assert_allclose(getattr(tpre, f).numpy(), getattr(jpre, f), atol=1e-6)
    assert len(tpre.rigid_vids) == len(jpre.rigid_vids) > 0
    jpre = JE.RegPrecomputed(jpre.offset_relax_w, jpre.offset_lap_relax_w,
                             jpre.rigid_vids, uvmask.astype(np.float32))
    tpre = TE.RegPrecomputed(tpre.offset_relax_w, tpre.offset_lap_relax_w,
                             tpre.rigid_vids, torch.as_tensor(uvmask.astype(np.float32)))

    jlog = JE.regularization_energy(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, None,
        jnp.asarray(verts_cano), jnp.asarray(albedo),
        {"diffuse_detach_normal": jnp.asarray(diffuse)}, jh, jc, stage, opt,
        jpre, T)
    tlog = TE.regularization_energy(
        params_from_numpy(p, device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()}, None,
        torch.as_tensor(verts_cano), torch.as_tensor(albedo),
        {"diffuse_detach_normal": torch.as_tensor(diffuse)}, th, tc, stage, opt,
        tpre, T)
    assert set(tlog) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    if stage == "rgb_global_tracking":
        # together the two stages run every term
        seq = {"smooth_pose", "reg_joint", "smooth_joint", "reg_expr",
               "smooth_expr", "reg_tex_tv", "reg_tex_res_clusters",
               "reg_offset_lap", "reg_offset", "reg_offset_rigid"}
        assert REG_TERMS - seq <= set(tlog) and REG_TERMS <= set(tlog) | seq


# ---------------------------------------------------------------------------
# (e) the whole training energy and its gradient
# ---------------------------------------------------------------------------

_train_config = C.train_config


def _train_inputs(th):
    rng = np.random.default_rng(3)
    p = {k: np.array(v) for k, v in JP.init_params(
        T, NS, NE, 100, th.num_verts, R, True, True, True, True, False,
        False).items()}
    p["translation"][:, 2] = -0.3
    p["translation"] += rng.normal(0, 0.01, p["translation"].shape).astype(np.float32)
    p["expr"] = rng.normal(0, 0.5, p["expr"].shape).astype(np.float32)
    p["rotation"] = rng.normal(0, 0.2, p["rotation"].shape).astype(np.float32)
    p["jaw_pose"] = rng.normal(0, 0.05, p["jaw_pose"].shape).astype(np.float32)
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
    return p, batch


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's eager (E, log, gradients) of each training stage, computed once
    (_jax_train_ref) for the one-process and the 2-rank tests."""
    return {}


def _jax_train_ref(jax_refs, heads, stage):
    if stage not in jax_refs:
        a, jh, th = heads
        jc = _train_config(JConfig, stage)
        p, batch = _train_inputs(th)
        jen = JE.make_energy_fn(jh, jc, JE.make_albedo_fn(jc, JTex(a.tex_painted, R), None),
                                (H, W), T, stage)
        leaves = JO.stage_optimizable_leaves(jc, stage, p)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        frozen = {k: jnp.asarray(v) for k, v in p.items() if k not in leaves}

        def loss(op):
            E, (log, _) = jen({**frozen, **op}, jb, jax.random.PRNGKey(0))
            return E, log

        # eager, not jitted: on this 32x128 scene the jitted JAX gradient
        # moves by up to 2.4e-2 of max|g| away from the eager one (ROADMAP.md
        # Queue 3), while the port's float32 gradient equals its float64 one
        # to 1e-5
        (jE, jlog), jg = jax.value_and_grad(loss, has_aux=True)(
            {k: jnp.asarray(p[k]) for k in leaves})
        jax_refs[stage] = (float(jE), {k: float(v) for k, v in jlog.items()},
                           {k: np.asarray(v) for k, v in jg.items()}, leaves)
    return jax_refs[stage]


@pytest.fixture(scope="module")
def two_ranks(heads, tmp_path_factory):
    """Both stages' (E, log, gradients) on 2 gloo ranks of the port, one
    row each (a future: the ranks run while JAX compiles)."""
    _, _, th = heads
    p, batch = _train_inputs(th)
    rdv = (tmp_path_factory.mktemp("two_ranks") / "rdv").as_uri()
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(sharding.launch, C.train_energy_checks, ["cpu", "cpu"],
                          "gloo", args=(p, batch, TRAIN_STAGES), init_method=rdv,
                          timeout=60, join_timeout=240, num_threads=1)


def _assert_matches_jax(tE, tlog, tg, ref):
    jE, jlog, jg, leaves = ref
    assert set(tlog) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(tlog[k], jlog[k], rtol=1e-4, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(tE, jE, rtol=1e-4)
    for k in leaves:
        ref_k = jg[k]
        scale = np.abs(ref_k).max()
        assert scale > 0, k
        err = np.abs(tg[k] - ref_k).max()
        assert err <= 1e-4 * scale, (k, err / scale)


@pytest.mark.parametrize("stage", TRAIN_STAGES)
def test_training_energy_and_gradient_match(heads, jax_refs, two_ranks, stage):
    """The port's make_energy_fn(..., stage) on the CPU against
    jax.value_and_grad of the JAX one, disturbance rates None on both
    sides: E_total and every log term to 1e-4 relative, each optimizable
    leaf's gradient to 1e-4 * max|g| of that leaf."""
    a, jh, th = heads
    jc, tc = _train_config(JConfig, stage), _train_config(TConfig, stage)
    p, batch = _train_inputs(th)
    ref = _jax_train_ref(jax_refs, heads, stage)
    assert ref[3] == TO.stage_optimizable_leaves(tc, stage, p)
    ten = TE.make_energy_fn(th, tc, TE.make_albedo_fn(
        tc, TTex(a.tex_painted, R, device="cpu"), None), (H, W), T, stage,
        device="cpu")
    tE, tlog, tg = TO.loss_and_grads(ten, params_from_numpy(p, device="cpu"),
                                     ref[3], {k: torch.as_tensor(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0))
    assert {"photo", "lmk", "reg_tex_tv"} <= set(tlog)
    _assert_matches_jax(float(tE), {k: float(v) for k, v in tlog.items()},
                        {k: v.numpy() for k, v in tg.items()}, ref)


@pytest.mark.parametrize("stage", TRAIN_STAGES)
def test_training_energy_two_ranks_match_jax(heads, jax_refs, two_ranks, stage):
    """The same energy on 2 gloo ranks, one frame each: the ranks' shares of
    E and of every log term summed, and the all-reduced gradients (the same
    bits on both ranks), against the same eager JAX reference at the same
    tolerances. The sequential stage has the smooth terms and the
    photometric area; rgb_init_offset adds reg_diffuse (lights), the
    offset regularizers and the batch-free reg_shape."""
    ranks = [r[stage] for r in two_ranks.result()]
    for k, g in ranks[0][2].items():
        np.testing.assert_array_equal(ranks[1][2][k], g, err_msg=k)
    E = sum(r[0] for r in ranks)
    log = {k: sum(r[1][k] for r in ranks) for k in ranks[0][1]}
    if stage == "rgb_init_offset":
        assert {"reg_diffuse", "reg_offset_rigid", "reg_shape"} <= set(log)
    _assert_matches_jax(E, log, ranks[0][2], _jax_train_ref(jax_refs, heads, stage))


# ---------------------------------------------------------------------------
# (f) Adam: the same gradients through both train steps
# ---------------------------------------------------------------------------

def test_adam_step_matches_optax():
    """Both packages' make_train_step on a linear energy whose gradient is
    the batch's G: the same gradients go into Adam on both sides. Three
    steps with lr_factor 1, 0.5, 0.25: params equal to 1e-6; frozen
    leaves bit-identical."""
    rng = np.random.default_rng(0)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in
         (("expr", (T, NE)), ("rotation", (T, 3)), ("tex_extra", (3, 8, 8)),
          ("shape", (NS,)), ("lights", (9, 3)))}
    leaves = frozenset(("expr", "rotation", "tex_extra"))
    cfg = JConfig()
    lr_map = JO.leaf_learning_rates(cfg)
    assert lr_map == TO.leaf_learning_rates(TConfig())
    # gradients of mixed scales, some exactly 0
    Gs = [{k: (rng.normal(size=p[k].shape) * 10.0 ** rng.uniform(-3, 1, p[k].shape)
               * (rng.uniform(size=p[k].shape) > 0.1)).astype(np.float32)
           for k in leaves} for _ in range(3)]

    def j_energy(params, batch, key):
        E = sum(jnp.sum(params[k] * batch[k]) for k in leaves)
        return E, ({"total": E}, {})

    def t_energy(params, batch, gen):
        E = sum(torch.sum(params[k] * batch[k]) for k in leaves)
        return E, ({"total": E}, {})

    j_init, j_step = JO.make_train_step(j_energy, leaves, lr_map, 2.0)
    t_init, t_step = TO.make_train_step(t_energy, leaves, lr_map, 2.0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    frozen_before = {k: tp[k] for k in p if k not in leaves}
    js, tstate = j_init(jp), t_init(tp)
    for G, f in zip(Gs, (1.0, 0.5, 0.25)):
        jp, js, _, _ = j_step(jp, js, {k: jnp.asarray(v) for k, v in G.items()},
                              jax.random.PRNGKey(0), jnp.asarray(f))
        tp, tstate, _, _ = t_step(tp, tstate, {k: torch.as_tensor(v) for k, v in G.items()},
                                  torch.Generator(), f)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    for k, v in frozen_before.items():
        assert tp[k] is v and np.array_equal(v.numpy(), p[k])
    assert tstate["count"] == 3
    # the moments equal optax's
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    st = adam.init({k: jnp.asarray(p[k]) for k in leaves})
    for G in Gs:
        _, st = adam.update({k: jnp.asarray(v) for k, v in G.items()}, st)
    for k in leaves:
        np.testing.assert_allclose(tstate["mu"][k].numpy(), np.asarray(st.mu[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tstate["nu"][k].numpy(), np.asarray(st.nu[k]),
                                   rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# (g) copy_forward and the npz round trip
# ---------------------------------------------------------------------------

def _store():
    rng = np.random.default_rng(9)
    p = {k: np.asarray(v) for k, v in JP.init_params(
        6, NS, NE, 16, 40, 8, False, True, True, True, True, False).items()}
    return {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}


def test_copy_forward_matches():
    p = _store()
    ref = _np_dict(JP.copy_forward({k: jnp.asarray(v) for k, v in p.items()},
                                   2, jnp.asarray([3, 4, 5])))
    tp = params_from_numpy(p, device="cpu")
    got = TP.copy_forward(tp, 2, torch.tensor([3, 4, 5]))
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
        np.testing.assert_array_equal(tp[k].numpy(), p[k])   # input untouched


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_round_trip_matches(tmp_path, writer):
    """An archive written by either package loads identically into both,
    in the reference npz schema."""
    p = _store()
    path = tmp_path / "tracked_flame_params.npz"
    args = (path, np.arange(6), 6, (H, W), False, False)
    if writer == "port":
        TP.save_result(params_from_numpy(p, device="cpu"), *args)
    else:
        JP.save_result({k: jnp.asarray(v) for k, v in p.items()}, *args)
    with np.load(path) as z:
        assert {"rotation", "expr", "shape", "timestep_id", "n_processed_frames",
                "image_size", "focal_length", "tex", "tex_extra", "lights",
                "static_offset", "dynamic_offset"} <= set(z.files)
    blank = {k: np.zeros_like(v) for k, v in p.items()}
    blank["expr"] = np.zeros((8, NE), np.float32)       # longer store
    ref = _np_dict(JP.load_from_tracked_flame_params(
        {k: jnp.asarray(v) for k, v in blank.items()}, path))
    got = TP.load_from_tracked_flame_params(params_from_numpy(blank, device="cpu"), path)
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_array_equal(got["rotation"].numpy(), p["rotation"])
    np.testing.assert_array_equal(got["expr"].numpy()[:6], p["expr"])


@pytest.mark.parametrize("lr_scale", [1.0, 0.1])
def test_graphed_adam_equals_eager_adam(lr_scale):
    """make_train_step's Adam reads nothing from the host (the count on the
    device, the bias corrections read by it from optim.bias_corrections,
    each leaf's lr a float32 device scalar), so a CUDA graph can capture
    it, and equals the same step on host scalars bit for bit over counts
    1-3,000 and across the table's end, lr factors float32(0.9 ** e), e =
    0-39, at the sequential (1) and global (0.1) lr scales
    (tests/torch_adam_cases.py; on the card in
    tests/test_torch_kernels_cuda.py)."""
    from torch_adam_cases import check_adam_on_device
    check_adam_on_device("cpu", lr_scale)
