"""Port parity for preprocess/star.py: the STAR (StackedHGNetV1) graph in
both BatchNorm modes, its detector, the host crop/decode helpers, checkpoint
conversion (official container names, loud on unmatched keys) and the npz
layout, against vhap_tpu.preprocess.star on the CPU with the same
parameters.

Network outputs are held within 1e-5 of max|ref| per output; the host
helpers bit for bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.preprocess import star as jstar
from vhap_tpu_torch.preprocess import star as tstar

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tree(tree):
    return {k: (dict(v) if k == "meta" else jax_tree(v) if isinstance(v, dict)
                else jnp.asarray(v)) for k, v in tree.items()}


def randomize(tree, rng):
    """Non-trivial norms (stored statistics, affine parameters) and biases."""
    for k, v in tree.items():
        if k == "meta":
            continue
        if isinstance(v, dict) and "scale" in v:
            c = v["scale"].shape[0]
            v.update(scale=rng.normal(1, 0.2, c).astype(np.float32),
                     bias=rng.normal(0, 0.2, c).astype(np.float32))
            if "var" in v:
                v.update(mean=rng.normal(0, 0.2, c).astype(np.float32),
                         var=rng.uniform(0.5, 1.5, c).astype(np.float32))
        elif isinstance(v, dict):
            randomize(v, rng)
        elif k.endswith("_bias"):
            tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return tree


def small_tree(bn_mode, merge_bias=False):
    """STAR (2 stacks, depth 2, 32 features) from the port's initializer
    (its layout is the JAX package's: test_init_tree_has_the_jax_layout)."""
    tree = tstar.init_star_params(torch.Generator().manual_seed(0), nstack=2,
                                  depth=2, feats=32)
    rng = np.random.default_rng(1)
    if merge_bias:
        tree["merge_f0_bias"] = np.zeros(32, np.float32)
        tree["merge_h0_bias"] = np.zeros(32, np.float32)
    randomize(tree, rng)
    tree["meta"]["bn_mode"] = bn_mode
    return tree


def run_both(tree, x, dtype=np.float32):
    """(every stack's heatmaps NHWC, landmarks) from both packages, in
    `dtype`."""
    def cast(t):
        return {k: (v if k == "meta" else cast(v) if isinstance(v, dict)
                    else np.asarray(v, dtype)) for k, v in t.items()}
    tree, x = cast(tree), np.asarray(x, dtype)
    with jax.enable_x64(dtype == np.float64):
        jtree = jax_tree(tree)
        ref = jax.jit(lambda x: jstar.star_forward(jtree, x))(jnp.asarray(x))
        ref = ([np.asarray(h) for h in ref[0]], np.asarray(ref[1]))
    net = tstar.STAR.from_params(tree, "cpu").to(torch.from_numpy(x).dtype)
    with torch.no_grad():
        hms, lmks = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ([h.permute(0, 2, 3, 1).numpy() for h in hms], lmks.numpy()), ref


def assert_close(got, ref, tol=TOL):
    (g_hms, g_lmks), (r_hms, r_lmks) = got, ref
    assert len(g_hms) == len(r_hms)
    for i, (g, r) in enumerate(zip(g_hms, r_hms)):
        r = np.asarray(r)
        assert g.shape == r.shape
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= tol, f"stack {i}: {err:.3g} of max|ref|"
    r_lmks = np.asarray(r_lmks)
    assert g_lmks.shape == r_lmks.shape
    assert np.abs(g_lmks - r_lmks).max() <= tol   # coordinates in [-1, 1]


@pytest.mark.parametrize("bn_mode,merge_bias,dtype,tol", [
    (0, False, np.float32, TOL), (1, False, np.float64, 1e-10),
    (0, True, np.float32, TOL)],
    ids=["stored-stats", "batch-stats-float64", "stored-stats-merge-bias"])
def test_star_stacks_match_jax(bn_mode, merge_bias, dtype, tol):
    """Every stack's activated heatmaps and the soft-argmax landmarks, at
    64^2, batch 2. Batch statistics over the 4 x 4 bottom level make the
    float32 graph ill-conditioned: JAX's own eager and jitted forwards
    differ by 1.2e-5 of max|ref| there, so that mode is held in float64
    (both packages agree to 3e-14)."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3))
    got, ref = run_both(small_tree(bn_mode, merge_bias), x, dtype)
    assert got[0][-1].shape == (2, 16, 16, 68) and got[1].shape == (2, 68, 2)
    assert got[1].dtype == dtype
    assert_close(got, ref, tol)


def test_star_detector_matches_jax():
    """detect_single_image with the same random weights: the whole-image
    pass, the box, the refined crop's soft-argmax landmarks and their
    confidences (continuous decodes: held to 1e-4 px-normalized)."""
    from vhap_tpu.preprocess.landmarks import LandmarkDetectorSTARJax
    from vhap_tpu_torch.preprocess.landmarks import LandmarkDetectorSTARNet
    tree = small_tree(0)
    img = np.random.default_rng(3).integers(0, 256, (180, 240, 3), dtype=np.uint8)
    jbb, jl = LandmarkDetectorSTARJax(params=jax_tree(tree)).detect_single_image(img)
    tbb, tl = LandmarkDetectorSTARNet(params=tree, device="cpu").detect_single_image(img)
    assert jbb[0] >= 0, "the random net found no face"
    np.testing.assert_allclose(tbb, jbb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tl.shape == (68, 3) and tl.dtype == tbb.dtype == np.float32


def test_host_helpers_equal_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    for bbox in ([40.5, 30.0, 180.0, 170.5], [-20.0, -10.0, 150.0, 260.0],
                 [250.0, 150.0, 400.0, 300.0]):
        jc, js = jstar.bbox_to_center_scale(bbox)
        tc, ts = tstar.bbox_to_center_scale(bbox)
        np.testing.assert_array_equal(tc, jc)
        assert ts == js
        np.testing.assert_array_equal(tstar.crop_for_star(img, tc, ts),
                                      jstar.crop_for_star(img, jc, js))
        pts = rng.uniform(-1, 1, (9, 2))
        np.testing.assert_array_equal(tstar.landmarks_to_image(pts, tc, ts),
                                      jstar.landmarks_to_image(pts, jc, js))


def test_soft_argmax_and_coords_match_jax():
    hm = np.random.default_rng(5).normal(0, 1, (2, 12, 10, 7)).astype(np.float32)
    hm[1, ..., 3] = -1.0                 # an all-negative channel: the 1e-8 floor
    ref = np.asarray(jstar.soft_argmax(jnp.asarray(hm)))
    got = tstar.soft_argmax(torch.from_numpy(hm).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(   # torch's and JAX's linspace: within an ulp
        tstar.coord_channels(2, 5, 6).permute(0, 2, 3, 1).numpy(),
        np.asarray(jstar.coord_channels(2, 5, 6)), rtol=0, atol=1e-7)


def official_state_dict(tree):
    """A StackedHGNetV1 state dict under the official container names
    (pre.*, hgs.*, features.*, out_heatmaps.*), with the stem's and the
    feature convs' biases and DataParallel's prefix. The merge convs keep
    the explicit names merge_f<i>/merge_h<i>: both converters rewrite
    `features.` before `merge_features.`, so the official merge names
    come out as merge_feat<i> and stay unmatched (an error in both)."""
    sd = tstar.STAR.from_params(tree, "cpu").state_dict()
    rename = [(r"^pre_conv\.", "pre.0.conv."), (r"^pre_bn\.", "pre.1."),
              (r"^res1\.", "pre.3."), (r"^res2\.", "pre.5."), (r"^res3\.", "pre.6."),
              (r"^hg(\d+)\.", r"hgs.\1."), (r"^feat(\d+)_", r"features.\1_"),
              (r"^out(\d+)\.", r"out_heatmaps.\1.")]
    out = {}
    for k, v in sd.items():
        for pat, rep in rename:
            k = re.sub(pat, rep, k)
        out["module." + k] = v.clone()
    out["module.pre.0.conv.bias"] = torch.linspace(-0.1, 0.1, sd["pre_conv.weight"].shape[0])
    out["module.features.1_conv.bias"] = torch.linspace(0.1, -0.1, 32)
    out["module.pre.1.num_batches_tracked"] = torch.tensor(3)
    return out


def test_convert_torch_checkpoint_matches_jax(tmp_path):
    """One official-named checkpoint through both converters: the same tree
    (conv biases folded into the next BN's mean, merge biases kept), which
    runs alike in both packages."""
    path = tmp_path / "star.pkl"
    torch.save({"net": official_state_dict(small_tree(0, merge_bias=True))}, path)
    ref = jstar.convert_torch_checkpoint(str(path), nstack=2, depth=2)
    got = tstar.convert_torch_checkpoint(str(path), nstack=2, depth=2)

    def same(a, b, where=""):
        assert set(a) == set(b), where
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], where + k + "/")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                              err_msg=where + k)
    same(got, ref)
    assert "merge_f0_bias" in got
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    assert_close(*run_both(got, x))


def test_unmatched_checkpoint_keys_raise(tmp_path):
    sd = official_state_dict(small_tree(0))
    sd["mystery.layer.weight"] = torch.zeros(3)
    path = tmp_path / "bad.pth"
    torch.save({"state_dict": sd}, path)
    for convert in (jstar.convert_torch_checkpoint, tstar.convert_torch_checkpoint):
        with pytest.raises(ValueError, match="mystery"):
            convert(str(path), nstack=2, depth=2)


def test_params_npz_cross_load(tmp_path):
    tree = small_tree(0, merge_bias=True)
    tstar.save_star_params(str(tmp_path / "port.npz"), tree)
    jstar.save_star_params(str(tmp_path / "jax.npz"), jax_tree(tree))
    for loaded in (jstar.load_star_params(str(tmp_path / "port.npz")),
                   tstar.load_star_params(str(tmp_path / "jax.npz"))):
        assert loaded["meta"] == tree["meta"]
        np.testing.assert_array_equal(np.asarray(loaded["hg1"]["bottom"]["conv2"]),
                                      tree["hg1"]["bottom"]["conv2"])
        np.testing.assert_array_equal(np.asarray(loaded["act0_in"]["scale"]),
                                      tree["act0_in"]["scale"])


def test_init_tree_has_the_jax_layout():
    """init_star_params (torch.Generator) gives JAX's tree: keys, shapes,
    meta; the default is the STAR alignment config, 12.99 M values."""
    def layout(t):
        return {k: (v if k == "meta" else layout(v) if isinstance(v, dict)
                    else np.shape(v)) for k, v in t.items()}
    got = tstar.init_star_params(torch.Generator().manual_seed(0), 1, 1, 8, 3)
    ref = jstar.init_star_params(jax.random.PRNGKey(0), 1, 1, 8, 3)
    assert layout(got) == layout(ref)
    with torch.device("meta"):
        full = tstar.STAR()
    assert sum(v.numel() for v in full.state_dict().values()) == 12_986_992
