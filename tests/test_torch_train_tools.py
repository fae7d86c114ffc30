"""Port parity of the synthetic trainers (tools/train_{fan,matting}_synthetic
.py) against vhap_tpu's on the CPU: the host samplers bit for bit, the crop
resampler against jax.image.scale_and_translate and the whole crop against
the JAX tool's crop_augment for the same draws, the heatmap targets and the
augmentation's box blur, three optimizer steps of a narrow FAN and of the
U-Net against the JAX tool's jitted step (optax), the weights' round trip
through JAX's load_fan_params, and each tool's CLI at a reduced size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vhap_tpu.preprocess import fan as jfan
from vhap_tpu.preprocess import matting as jmat
from vhap_tpu.tools import train_fan_synthetic as jtf
from vhap_tpu.tools import train_matting_synthetic as jtm
from vhap_tpu_torch.convert import fan_params_from_torch, unet_params_from_torch
from vhap_tpu_torch.preprocess import fan as tfan
from vhap_tpu_torch.preprocess import matting as tmat
from vhap_tpu_torch.tools import train_fan_synthetic as tf
from vhap_tpu_torch.tools import train_matting_synthetic as tm

S = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _heads():
    from vhap_tpu.model.flame import FlameHead as JHead
    from vhap_tpu_torch.model.flame import FlameHead as THead
    return (JHead.build(n_shape=50, n_expr=30, add_teeth=False),
            THead.build(n_shape=50, n_expr=30, add_teeth=False, device="cpu"))


def _image(B=2, seed=0):
    """Smooth seeded images with fine detail (B, S, S, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:S, :S] / S
    base = np.stack([np.sin(9 * xx + c) * np.cos(7 * yy - c) for c in range(3)], -1)
    return np.clip(0.5 + 0.4 * base[None] + rng.normal(0, 0.05, (B, S, S, 3)),
                   0, 1).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_host_samplers_are_bit_identical():
    jhead, thead = _heads()
    for seed in (1, 5):
        a = jtf._sample_params(np.random.default_rng(seed), jhead, 8)
        b = tf._sample_params(np.random.default_rng(seed), thead, 8)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(jtm._sample_backgrounds(np.random.default_rng(seed), 6),
                                      tm._sample_backgrounds(np.random.default_rng(seed), 6))


# scales on both sides of 1 (the crop's sf ranges ~0.6-1.9), with shifts
CROPS = [(0.55, 40.0, -10.0), (0.93, 3.5, 7.25), (1.0, 0.0, 0.0), (1.37, -60.0, -45.5),
         (1.9, -120.0, -97.0)]


def test_resampler_matches_scale_and_translate():
    """resample against jax.image.scale_and_translate(..., "linear") at
    256^2, batch 2, per sample, to 1e-5."""
    img = _image()
    for s_, ty, tx in CROPS:
        sf = torch.tensor([s_, s_ * 0.9])
        # translation t = S/2 - c * sf per dim: pick c from the wanted t
        cy = (S / 2 - torch.tensor([ty, ty + 3])) / sf
        cx = (S / 2 - torch.tensor([tx, tx - 5])) / sf
        got = tf.resample(torch.from_numpy(img), sf, cx, cy).numpy()
        # the translations as resample forms them, in float32 (an output
        # whose sample lands on -0.5 or S - 0.5 is kept or dropped whole)
        t = torch.stack([S / 2 - cy * sf, S / 2 - cx * sf], -1).numpy()
        for b in range(2):
            ref = jax.image.scale_and_translate(
                jnp.asarray(img[b]), img[b].shape, (0, 1),
                jnp.asarray(sf[b].numpy()).repeat(2), jnp.asarray(t[b]), "linear")
            np.testing.assert_allclose(got[b], np.asarray(ref), rtol=0, atol=1e-5,
                                       err_msg=f"sf {float(sf[b])}")


def test_crop_matches_jax_crop_augment_for_its_draws():
    """The JAX tool's crop_augment and the port's crop on the draws
    jax.random makes from the same key: image within 1e-5, landmarks within
    1e-4 px."""
    img = _image(B=4, seed=1)
    rng = np.random.default_rng(2)
    px = (rng.uniform(60, 190, (4, 70, 2))).astype(np.float32)
    for seed in (3,):
        key = jax.random.PRNGKey(seed)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        draws = {"scale": jax.random.uniform(k1, (4,), minval=0.8, maxval=1.3),
                 "shift": jax.random.normal(k2, (4, 2)),
                 "whole": jax.random.uniform(k3, (4,)),
                 "whole_jitter": jax.random.normal(k4, (4, 3))}
        ref_img, ref_px = jax.jit(jtf.crop_augment)(key, jnp.asarray(img), jnp.asarray(px))
        got_img, got_px = tf.crop_with(torch.from_numpy(img), torch.from_numpy(px),
                                       {k: torch.from_numpy(np.array(v))
                                        for k, v in draws.items()})
        np.testing.assert_allclose(got_img.numpy(), np.asarray(ref_img), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_px.numpy(), np.asarray(ref_px), rtol=0, atol=1e-4)


def test_heatmaps_and_box_blur_match_jax():
    rng = np.random.default_rng(4)
    px = rng.uniform(-10, 266, (2, 70, 2)).astype(np.float32)
    np.testing.assert_allclose(tf.heatmap_targets(torch.from_numpy(px)).numpy(),
                               np.asarray(jtf.heatmap_targets(jnp.asarray(px))),
                               rtol=0, atol=1e-6)
    img = _image(seed=5)
    ref = jax.lax.reduce_window(jnp.asarray(img), 0.0, jax.lax.add, (1, 3, 3, 1),
                                (1, 1, 1, 1), "SAME") / 9.0
    np.testing.assert_allclose(tf.box_blur3(torch.from_numpy(img)).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-6)
    # the photometric chain for explicit draws, against the JAX tool's
    # augment_image formula (its draws come from jax.random inside train())
    gamma = rng.uniform(0.7, 1.4, (2, 1, 1, 1)).astype(np.float32)
    std = rng.uniform(0, 0.04, (2, 1, 1, 1)).astype(np.float32)
    noise = rng.normal(size=img.shape).astype(np.float32)
    mix = np.array([True, False]).reshape(2, 1, 1, 1)
    x = jnp.clip(jnp.asarray(img), 1e-4, 1.0) ** gamma + std * noise
    blurred = jax.lax.reduce_window(x, 0.0, jax.lax.add, (1, 3, 3, 1),
                                    (1, 1, 1, 1), "SAME") / 9.0
    ref = jnp.clip(jnp.where(mix, blurred, x), 0.0, 1.0)
    got = tf.photometric(*(torch.from_numpy(a) for a in (img, gamma, std, noise, mix)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(2.5e-4, 1500, alpha=0.1)
    ours = tf.cosine_decay(2.5e-4, 1500, alpha=0.1)
    for count in (0, 1, 2, 700, 1499, 1500, 1700):
        np.testing.assert_allclose(ours(count), float(sched(count)), rtol=1e-6)


# three steps from the same parameters and images. The FAN runs in float64:
# its first BatchNorm's scale feeds a batch-statistics BatchNorm, so its
# gradient nearly cancels (~1e-6 against ~0.1 elsewhere) and float32
# rounding in another order (XLA vs oneDNN) changes it by 7-30 %, which
# Adam's normalized step turns into ~0.1 lr. In float64 the one difference
# left are Adam's bias correction and the schedule, formed in float32 as
# optax forms them in float32 (6e-6 of an update): parameters to 1e-4 of
# the three steps' largest move (3 lr), losses to 1e-6 relative. The U-Net
# (no BatchNorm) runs in float32: parameters to 2 % of 3 lr, losses to 1e-5
# relative.
STEP_TOLS = {"float64": (1e-4, 1e-6), "float32": (0.02, 1e-5)}


def _jax_steps(loss_fn, params, lr_schedule, batches):
    meta = params.pop("meta")
    opt = optax.adam(lr_schedule)
    state = opt.init(params)

    @jax.jit
    def step(params, state, x, t):
        l, g = jax.value_and_grad(loss_fn)(params, meta, x, t)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, l

    losses = []
    for x, t in batches:
        params, state, l = step(params, state, jnp.asarray(x), jnp.asarray(t))
        losses.append(float(l))
    return dict(params, meta=meta), losses


def _compare_steps(got_tree, ref_tree, got_losses, ref_losses, lr, dtype):
    lr_share, loss_rtol = STEP_TOLS[dtype]
    np.testing.assert_allclose(got_losses, ref_losses, rtol=loss_rtol)
    a, b = _flat(got_tree), _flat(ref_tree)
    assert a.keys() == b.keys()
    worst = max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a
                if not k.startswith("meta"))
    assert worst <= lr_share * 3 * lr, worst


def test_fan_steps_match_jax():
    """A narrow FAN (16 features, depth 1, 70 landmarks) at 64^2, batch 2,
    in float64: three steps of the tool's loss, batch statistics and
    optax.adam with the cosine schedule, against the JAX tool's step
    jitted."""
    lr, steps = 2.5e-4, 1500
    tree = tfan.init_fan_params(torch.Generator().manual_seed(3), num_modules=1,
                                depth=1, feats=16, num_landmarks=70)
    rng = np.random.default_rng(6)
    batches = [(rng.uniform(0, 1, (2, 64, 64, 3)),
                np.asarray(tf.heatmap_targets(torch.from_numpy(
                    rng.uniform(0, 256, (2, 70, 2)).astype(np.float32)), 16), np.float64))
               for _ in range(3)]

    def jloss(params, meta, img, hm_t):       # the JAX tool's loss_fn
        outs = jfan.fan_forward(dict(params, meta=meta), img, train=True)
        w = 1.0 + 30.0 * hm_t
        return sum(jnp.mean((o - hm_t) ** 2 * w) for o in outs) / len(outs)

    with jax.enable_x64(True):
        jtree = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64),
                                       {k: v for k, v in tree.items() if k != "meta"})
        ref, ref_losses = _jax_steps(jloss, dict(jtree, meta=tree["meta"]),
                                     optax.cosine_decay_schedule(lr, steps, alpha=0.1),
                                     batches)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    net = tfan.FAN.from_params(tree, "cpu").double()
    opt = tf.Adam(dict(net.named_parameters()), tf.cosine_decay(lr, steps, alpha=0.1))
    losses = [float(tf.fan_step(net, opt, torch.from_numpy(x), torch.from_numpy(t)))
              for x, t in batches]
    got = {k: v.double() for k, v in net.state_dict().items()}
    _compare_steps(fan_params_from_torch(got, tree["meta"]), ref, losses, ref_losses,
                   lr, "float64")


def test_unet_steps_match_jax():
    """The bundled-width U-Net at 64^2, batch 2: three steps of the sigmoid
    cross-entropy with optax.adam(4e-4), against the JAX tool's step."""
    lr = 4e-4
    tree = tmat.init_unet_params(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(7)
    batches = [(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
                (rng.uniform(0, 1, (2, 64, 64)) > 0.6).astype(np.float32))
               for _ in range(3)]

    def jloss(params, meta, img, alpha_t):     # the JAX tool's loss_fn
        logit = jmat.unet_forward(dict(params, meta=meta), img)[..., 0]
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logit, alpha_t))

    jtree = {k: jnp.asarray(v) for k, v in tree.items() if k != "meta"}
    ref, ref_losses = _jax_steps(jloss, dict(jtree, meta=tree["meta"]), lr, batches)
    net = tmat.UNet.from_params(tree, "cpu")
    opt = tf.Adam(dict(net.named_parameters()), lambda count: lr)
    losses = [float(tm.matting_step(net, opt, torch.from_numpy(x), torch.from_numpy(t)))
              for x, t in batches]
    _compare_steps(unet_params_from_torch(net.state_dict(), tree["meta"]), ref,
                   losses, ref_losses, lr, "float32")


def test_saved_weights_load_in_jax(tmp_path):
    """A port-written FAN (statistics baked) and U-Net load through JAX's
    load_fan_params and give JAX's forward of the port's."""
    tree = tfan.init_fan_params(torch.Generator().manual_seed(8), num_modules=1,
                                depth=1, feats=16, num_landmarks=70)
    rng = np.random.default_rng(9)
    net = tfan.FAN.from_params(tree, "cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    trained = fan_params_from_torch(net.state_dict(), tree["meta"])
    baked = tfan.finalize_bn_stats(
        trained, [rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)], "cpu")
    x = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    for name, params, jfwd, tfwd in (
            ("fan", baked, lambda p, x: jfan.fan_forward(p, x)[-1],
             lambda p, x: tfan.FAN.from_params(p, "cpu")(x.permute(0, 3, 1, 2))[-1]
             .permute(0, 2, 3, 1)),
            ("unet", tmat.init_unet_params(torch.Generator().manual_seed(10)),
             jmat.unet_forward,
             lambda p, x: tmat.UNet.from_params(p, "cpu")(x.permute(0, 3, 1, 2))
             .permute(0, 2, 3, 1))):
        path = tmp_path / f"{name}.npz"
        tfan.save_fan_params(str(path), params)
        ref = np.asarray(jfwd(jfan.load_fan_params(str(path)), jnp.asarray(x)))
        with torch.no_grad():
            got = tfwd(tfan.load_fan_params(str(path)), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
    assert jfan.load_fan_params(str(tmp_path / "fan.npz"))["meta"]["bn_mode"] == 0


@pytest.mark.parametrize("tool", ["fan", "matting"])
def test_cli_runs_at_a_reduced_size(tool, tmp_path, monkeypatch, capsys):
    """`main` with --device cpu at 32^2 (the tools' size patched down; the
    card runs them at 256^2): the RESULT line, and weights the port's
    loaders read."""
    monkeypatch.setattr(tf, "IMG_SIZE", 32)
    monkeypatch.setattr(tm, "IMG_SIZE", 32)
    monkeypatch.setattr(tf, "heatmap_targets",
                        functools.partial(tf.heatmap_targets, size=8))
    out = tmp_path / f"{tool}.npz"
    if tool == "fan":
        tr = tf.main(["--steps", "2", "--batch", "1", "--feats", "16", "--depth", "1",
                      "--out", str(out), "--device", "cpu"])
        assert tfan.FAN.from_params(tfan.load_fan_params(str(out)), "cpu").bn_mode == 0
    else:
        tr = tm.main(["--steps", "2", "--batch", "2", "--out", str(out),
                      "--device", "cpu"])
        tmat.MattingUNet(str(out), device="cpu")
    assert np.isfinite(tr.err) and tr.render_s > 0 and tr.net_s > 0
    assert capsys.readouterr().out.strip().startswith("RESULT: err=")
