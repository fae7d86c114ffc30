"""Port parity for preprocess/fan.py: the FAN graph in both BatchNorm modes,
the BN-statistics bake, the bundled weights and their detector, the host
crop/decode helpers, checkpoint conversion and the npz layout, against
vhap_tpu.preprocess.fan on the CPU with the same parameters.

Network outputs are held within 1e-5 of max|ref| per output (float32 on
both sides, in other orders of summation); the host helpers bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.preprocess import fan as jfan
from vhap_tpu_torch.preprocess import fan as tfan

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    """A JAX parameter tree -> the same tree of numpy arrays (meta kept)."""
    return {k: (dict(v) if k == "meta" else np_tree(v) if isinstance(v, dict)
                else np.asarray(v)) for k, v in tree.items()}


def jax_tree(tree):
    return {k: (dict(v) if k == "meta" else jax_tree(v) if isinstance(v, dict)
                else jnp.asarray(v)) for k, v in tree.items()}


def randomize_bn(tree, rng):
    """Non-trivial stored statistics and affine parameters in every BN."""
    for k, v in tree.items():
        if isinstance(v, dict) and "var" in v:
            c = v["var"].shape[0]
            v.update(scale=rng.normal(1, 0.2, c).astype(np.float32),
                     bias=rng.normal(0, 0.2, c).astype(np.float32),
                     mean=rng.normal(0, 0.2, c).astype(np.float32),
                     var=rng.uniform(0.5, 1.5, c).astype(np.float32))
        elif isinstance(v, dict) and k != "meta":
            randomize_bn(v, rng)
    return tree


def small_tree(bn_mode, biased=False):
    """FAN (2 modules, depth 2, 32 features) from the port's initializer
    (its layout is the JAX package's: test_init_tree_has_the_jax_layout)."""
    tree = tfan.init_fan_params(torch.Generator().manual_seed(0), num_modules=2,
                                depth=2, feats=32)
    rng = np.random.default_rng(1)
    if bn_mode == 0:
        randomize_bn(tree, rng)
    if biased:   # the 1x1 head biases official checkpoints carry
        for name in ("conv_last0", "l0", "bl0", "al0", "conv_last1", "l1"):
            tree[name + "_bias"] = rng.normal(0, 0.1, tree[name].shape[-1]).astype(np.float32)
    tree["meta"]["bn_mode"] = bn_mode
    return tree


def assert_outputs_close(got, ref, tol=TOL):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert g.shape == r.shape, (i, g.shape, r.shape)
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= tol, f"output {i}: {err:.3g} of max|ref|"


def run_both(tree, x):
    """Every module's heatmaps from both packages, NHWC."""
    jtree = jax_tree(tree)
    ref = jax.jit(lambda x: jfan.fan_forward(jtree, x))(jnp.asarray(x))
    net = tfan.FAN.from_params(tree, "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    return [g.permute(0, 2, 3, 1).numpy() for g in got], ref


@pytest.mark.parametrize("bn_mode,biased", [(0, False), (1, False), (0, True)],
                         ids=["stored-stats", "batch-stats", "stored-stats-head-bias"])
def test_fan_modules_match_jax(bn_mode, biased):
    """FAN (2 modules, depth 2, 32 features) at 64^2, batch 2: every
    module's heatmaps."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    got, ref = run_both(small_tree(bn_mode, biased), x)
    assert got[-1].shape == (2, 16, 16, 68)
    assert_outputs_close(got, ref)


def test_finalize_bn_stats_matches_jax():
    """Batch statistics baked into stored ones over the same batches, then
    the bn_mode-0 forwards of the two results."""
    tree = small_tree(1)
    rng = np.random.default_rng(3)
    batches = [rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    ref = np_tree(jfan.finalize_bn_stats(jax_tree(tree), batches))
    got = tfan.finalize_bn_stats(tree, batches, device="cpu")
    assert got["meta"]["bn_mode"] == ref["meta"]["bn_mode"] == 0
    assert tree["meta"]["bn_mode"] == 1      # the input tree is not modified

    def leaves(t, prefix=""):
        for k, v in t.items():
            if k != "meta":
                yield from (leaves(v, prefix + k + "/") if isinstance(v, dict)
                            else [(prefix + k, v)])
    ref_leaves = dict(leaves(ref))
    for path, v in leaves(got):
        r = ref_leaves.pop(path)
        np.testing.assert_allclose(v, r, rtol=1e-4, atol=1e-5 * np.abs(r).max(),
                                   err_msg=path)
    assert not ref_leaves
    x = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    assert_outputs_close(*run_both(got, x), tol=1e-4)


def test_bundled_fan_heatmaps_match_jax():
    """The port's copy of the bundled weights is the JAX package's file,
    and each package's load gives the same heatmaps on a 256^2 crop."""
    mine = REPO / "vhap_tpu_torch" / "assets" / "fan_weights.npz"
    theirs = REPO / "vhap_tpu" / "assets" / "fan_weights.npz"
    assert mine.read_bytes() == theirs.read_bytes()
    x = np.random.default_rng(4).uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
    jtree = jfan.load_fan_params(str(theirs))
    ref = jax.jit(lambda x: jfan.fan_forward(jtree, x))(jnp.asarray(x))
    net = tfan.FAN.from_params(tfan.load_fan_params(str(mine)), "cpu")
    assert net.bn_mode == 0
    with torch.no_grad():
        got = [g.permute(0, 2, 3, 1).numpy()
               for g in net(torch.from_numpy(x).permute(0, 3, 1, 2))]
    assert got[-1].shape == (1, 64, 64, 70)
    assert_outputs_close(got, ref)


@pytest.fixture(scope="module")
def rendered_frame(tmp_path_factory):
    """One frame of the port's synthetic sequence (seeded), rendered at
    128^2 and resized to 256^2."""
    from PIL import Image
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    root = tmp_path_factory.mktemp("frame")
    generate(root / "seq", n_frames=1, size=128, n_shape=10, n_expr=5, device="cpu")
    img = Image.open(root / "seq" / "images" / "00000.jpg")
    return np.array(img.resize((256, 256), Image.BILINEAR))


def recorded(fn, log):
    def wrapped(crops):
        out = fn(crops)
        log.append(np.asarray(out))
        return out
    return wrapped


def test_bundled_detector_matches_jax(rendered_frame):
    """detect_single_image with the bundled weights: bbox, landmarks and
    confidences. Both passes' argmaxes have top-2 margins far above the
    heatmaps' difference on this frame, so the two decode alike."""
    from vhap_tpu.preprocess.landmarks import LandmarkDetectorFANJax
    from vhap_tpu_torch.preprocess.landmarks import LandmarkDetectorFANNet
    jdet, tdet = LandmarkDetectorFANJax(), LandmarkDetectorFANNet(device="cpu")
    jhm, thm = [], []
    jdet._heatmaps = recorded(jdet._heatmaps, jhm)
    tdet.heatmaps = recorded(tdet.heatmaps, thm)
    jbb, jl = jdet.detect_single_image(rendered_frame)
    tbb, tl = tdet.detect_single_image(rendered_frame)
    assert len(jhm) == len(thm) == 2, "no face found on the rendered frame"
    for j, t in zip(jhm, thm):
        t = t[0]
        scale = np.abs(j).max()
        assert np.abs(t - j).max() <= TOL * scale
        top2 = np.sort(j.reshape(j.shape[0], -1), axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > TOL * scale
    np.testing.assert_array_equal(tbb, jbb)
    np.testing.assert_array_equal(tl[:, :2], jl[:, :2])
    np.testing.assert_allclose(tl[:, 2], jl[:, 2], rtol=0, atol=TOL)
    assert tl.shape == (70, 3) and tl.dtype == tbb.dtype == np.float32


def test_host_helpers_equal_jax():
    """Crop, decode and the whole-image box: bit for bit."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    for bbox in ([40.5, 30.0, 180.0, 170.5], [-20.0, -10.0, 150.0, 260.0]):
        jc, js = jfan.bbox_to_center_scale(bbox)
        tc, ts = tfan.bbox_to_center_scale(bbox)
        np.testing.assert_array_equal(tc, jc)
        assert ts == js
        np.testing.assert_array_equal(tfan.crop_for_fan(img, tc, ts),
                                      jfan.crop_for_fan(img, jc, js))
        for inv in (False, True):
            np.testing.assert_array_equal(
                tfan._transform([17.0, 33.5], tc, ts, 64, inv),
                jfan._transform([17.0, 33.5], jc, js, 64, inv))
    hm = rng.uniform(0, 1, (7, 16, 16)).astype(np.float32)
    hm[3, 0, 5] = hm[4, 15, 15] = 2.0          # peaks on the border
    center = np.array([150.0, 100.0])
    np.testing.assert_array_equal(tfan.heatmaps_to_landmarks(hm, center, 1.3),
                                  jfan.heatmaps_to_landmarks(hm, center, 1.3))
    np.testing.assert_array_equal(tfan.coarse_bbox_from_heatmaps(hm, img.shape),
                                  jfan.coarse_bbox_from_heatmaps(hm, img.shape))
    assert tfan.coarse_bbox_from_heatmaps(hm * 0.01, img.shape) is None
    assert jfan.coarse_bbox_from_heatmaps(hm * 0.01, img.shape) is None


def face_alignment_state_dict(tree):
    """A face_alignment-named FAN state dict (downsample.0 / .2, conv1 with
    a bias, num_batches_tracked, DataParallel's `module.` prefix) holding
    the weights of the port's module of `tree`."""
    sd = tfan.FAN.from_params(tree, "cpu").state_dict()
    out = {}
    for k, v in sd.items():
        k = k.replace("down_bn.", "downsample.0.").replace("down_conv.", "downsample.2.")
        out["module." + k] = v.clone()
        if k.endswith("running_var"):
            out["module." + k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    out["module.conv1.bias"] = torch.linspace(-0.1, 0.1, sd["conv1.weight"].shape[0])
    return out


def test_convert_torch_checkpoint_matches_jax(tmp_path):
    """One face_alignment checkpoint through both converters: the same tree
    (conv1's bias folded into bn1's mean), and the converted heads' biases
    run in the port's FAN as in JAX's."""
    path = tmp_path / "2dfan.pth.tar"
    torch.save({"state_dict": face_alignment_state_dict(small_tree(0, biased=True))}, path)
    ref = np_tree(jfan.convert_torch_checkpoint(str(path), num_modules=2, depth=2))
    got = tfan.convert_torch_checkpoint(str(path), num_modules=2, depth=2)

    def same(a, b, where=""):
        assert set(a) == set(b), where
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], where + k + "/")
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=where + k)
    same(got, ref)
    assert "conv_last0_bias" in got and "al0_bias" in got
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    assert_outputs_close(*run_both(got, x))


def test_params_npz_cross_load(tmp_path):
    """Each package reads the other's saved tree."""
    tree = small_tree(0, biased=True)
    tfan.save_fan_params(str(tmp_path / "port.npz"), tree)
    jfan.save_fan_params(str(tmp_path / "jax.npz"), jax_tree(tree))
    for a, b in ((jfan.load_fan_params(str(tmp_path / "port.npz")), tree),
                 (tfan.load_fan_params(str(tmp_path / "jax.npz")), tree)):
        assert a["meta"] == b["meta"]
        np.testing.assert_array_equal(np.asarray(a["m1"]["b3_2"]["conv2"]),
                                      b["m1"]["b3_2"]["conv2"])
        np.testing.assert_array_equal(np.asarray(a["l1_bias"]), b["l1_bias"])


def test_init_tree_has_the_jax_layout():
    """init_fan_params (torch.Generator) gives the JAX package's tree: the
    bundled net's keys, shapes and meta from the same configuration; the
    default is face_alignment's FAN(4), 23.87 M values."""
    def layout(t):
        return {k: (v if k == "meta" else layout(v) if isinstance(v, dict)
                    else np.shape(v)) for k, v in t.items()}
    ref = jfan.load_fan_params(str(REPO / "vhap_tpu" / "assets" / "fan_weights.npz"))
    got = tfan.init_fan_params(torch.Generator().manual_seed(0), 1, 3, 64, 70)
    assert layout(got) == layout(dict(ref, meta=dict(ref["meta"], bn_mode=1)))
    assert tfan.FAN.from_params(got, "cpu").bn_mode == 1
    with torch.device("meta"):
        full = tfan.FAN(num_modules=4, depth=4, feats=256, num_landmarks=68)
    assert sum(v.numel() for v in full.state_dict().values()) == 23_871_424
