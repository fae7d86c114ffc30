"""Port parity for preprocess/matting.py: the host matting helpers (box and
guided filters, background difference) bit for bit, the U-Net graph on
shared weights, the bundled U-Net's alpha (odd sizes exercise the edge
padding) and the alpha-map JPEGs of both matting paths, against
vhap_tpu.preprocess.matting on the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vhap_tpu.preprocess import matting as jmat
from vhap_tpu.preprocess.fan import load_fan_params as jload
from vhap_tpu_torch.preprocess import matting as tmat
from vhap_tpu_torch.preprocess.fan import load_fan_params as tload

REPO = Path(__file__).resolve().parents[1]
# the refined alpha: the guided filter's float32 integral images turn the
# U-Net's 1e-6-level differences into up to ~1e-5 on these sizes
ALPHA_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_host_filters_equal_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    bg = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    bg[10:25, 15:40] = rng.uniform(0, 1, (15, 25, 3))
    for r in (1, 4):
        np.testing.assert_array_equal(tmat._box(img, r), jmat._box(img, r))
        np.testing.assert_array_equal(tmat._box(img[..., 0], r), jmat._box(img[..., 0], r))
    guide, src = img.mean(-1), img[..., 1]
    np.testing.assert_array_equal(tmat.guided_filter(guide, src, 4),
                                  jmat.guided_filter(guide, src, 4))
    np.testing.assert_array_equal(tmat.alpha_from_background_diff(img, bg),
                                  jmat.alpha_from_background_diff(img, bg))


def test_background_diff_matting_writes_the_same_jpegs(tmp_path):
    """Per-camera plates found by camera id, one plate resized to the
    frames: both packages write byte-identical alpha maps."""
    rng = np.random.default_rng(1)
    bg = {"cam0": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
          "cam1": rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)}
    outs = {}
    for side, fn in (("jax", jmat.background_diff_matting),
                     ("port", tmat.background_diff_matting)):
        root = tmp_path / side
        (root / "images").mkdir(parents=True)
        (root / "bg").mkdir()
        for cam, plate in bg.items():
            Image.fromarray(plate).save(root / "bg" / f"{cam}.png")
            for t in range(2):
                img = np.array(Image.fromarray(bg["cam0"]))
                img[10:30, 20:40] = 255 - img[10:30, 20:40]
                Image.fromarray(img).save(root / "images" / f"{cam}_{t:05d}.jpg",
                                          quality=95)
        fn(root / "images", root / "bg")
        outs[side] = {p.name: p.read_bytes()
                      for p in sorted((root / "alpha_maps").glob("*.jpg"))}
    assert len(outs["port"]) == 4 and outs["port"] == outs["jax"]


def unet_tree():
    """A small U-Net (base 8, 3 levels) from the port's initializer."""
    return tmat.init_unet_params(torch.Generator().manual_seed(0), base=8, levels=3)


def test_unet_logits_match_jax():
    tree = unet_tree()
    jtree = {k: (v if k == "meta" else jnp.asarray(v)) for k, v in tree.items()}
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jmat.unet_forward(jtree, x))(jnp.asarray(x)))
    net = tmat.UNet.from_params(tree, "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 32, 48, 1)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bundled_unet_alpha_matches_jax():
    """The bundled weights (the JAX package's file) through each package's
    predict on a 66 x 98 image: edge padding to the stride of 8, the
    network, the crop and the guided filter."""
    mine = REPO / "vhap_tpu_torch" / "assets" / "matting_weights.npz"
    theirs = REPO / "vhap_tpu" / "assets" / "matting_weights.npz"
    assert mine.read_bytes() == theirs.read_bytes()
    img = np.random.default_rng(3).uniform(0, 1, (66, 98, 3)).astype(np.float32)
    ref = jmat.MattingUNetJax(params=jload(str(theirs))).predict(img)
    port = tmat.MattingUNet(device="cpu")
    got = port.predict(img)
    assert got.shape == ref.shape == (66, 98) and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= ALPHA_TOL
    assert port.stride == 8 and port.params["meta"] == tload(str(mine))["meta"]


def test_matting_unet_jpegs_match_jax(tmp_path):
    """matting_unet (the port's `matting_jax` method) and JAX's matting_jax
    on the same frames: alpha-map JPEGs within one level."""
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    generate(tmp_path / "seq", n_frames=2, size=64, n_shape=10, n_expr=5, device="cpu")
    written = {}
    for side, fn in (("jax", lambda d: jmat.matting_jax(d)),
                     ("port", lambda d: tmat.matting_unet(d, device="cpu"))):
        root = tmp_path / side
        (root / "images").mkdir(parents=True)
        for f in sorted((tmp_path / "seq" / "images").glob("*.jpg")):
            (root / "images" / f.name).write_bytes(f.read_bytes())
        fn(root / "images")
        written[side] = [np.asarray(Image.open(p), np.int32)
                         for p in sorted((root / "alpha_maps").glob("*.jpg"))]
    assert len(written["port"]) == len(written["jax"]) == 2
    for a, b in zip(written["port"], written["jax"]):
        assert a.shape == (64, 64) and np.abs(a - b).max() <= 1
        assert a.max() > 128 and a.min() < 128       # a head on a background


def test_init_tree_has_the_jax_layout():
    def layout(t):
        return {k: (v if k == "meta" else np.shape(v)) for k, v in t.items()}
    ref = jload(str(REPO / "vhap_tpu" / "assets" / "matting_weights.npz"))
    assert layout(tmat.init_unet_params()) == layout(ref)
