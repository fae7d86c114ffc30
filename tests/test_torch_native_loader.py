"""Port parity of the native frame loader (vhap_tpu_torch/native, data/
native_loader.py, VideoDataset.load_batch_native) against vhap_tpu's.

The port's three entry points against vhap_tpu.data.native_loader's bit for
bit (the same C++ source, the same compiler; the port links the libjpeg that
Pillow bundles, the JAX build the system's), both against PIL to the bounds
of tests/test_native_loader.py, the datasets' native batches against each
other and against the PIL path on a monocular folder and on the colour-
corrected multiview rig, and the build's safety when processes build at once.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vhap_tpu.data import native_loader as jnl
from vhap_tpu_torch.data import native_loader as tnl

REPO = Path(__file__).resolve().parents[1]
RESIZE_TOL = 3 / 255   # float resize coefficients vs PIL's 8-bit fixed point


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """JAX's loader, built from a copy of its sources in a temporary folder
    unless this process loaded it already (so that this file writes nothing
    into vhap_tpu/native, which tests/test_native_loader.py builds in)."""
    if jnl._LIB is None:
        d = tmp_path_factory.mktemp("jax_native")
        for name in ("frameloader.cpp", "Makefile"):
            shutil.copy(REPO / "vhap_tpu" / "native" / name, d / name)
        mp = pytest.MonkeyPatch()
        mp.setattr(jnl, "_NATIVE_DIR", d)
        mp.setattr(jnl, "_TRIED", False)
        try:
            jnl.get_lib()
        finally:
            mp.undo()
    assert jnl._LIB is not None, "the JAX package's loader did not build"
    assert tnl.get_lib() is not None, "the port's loader did not build"
    return jnl._LIB


@pytest.fixture(scope="module")
def jpgs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.default_rng(0)
    paths, apaths = [], []
    for i in range(4):
        img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
        a = rng.integers(0, 255, (64, 64), dtype=np.uint8)
        Image.fromarray(img).save(d / f"{i}.jpg", quality=95)
        Image.fromarray(a).save(d / f"a{i}.jpg", quality=95)
        paths.append(str(d / f"{i}.jpg"))
        apaths.append(str(d / f"a{i}.jpg"))
    return paths, apaths


def _ccs(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([np.concatenate([np.eye(3) + rng.normal(0, 0.05, (3, 3)),
                                     rng.normal(0, 0.02, (3, 1))], axis=1)
                     for _ in range(n)])


def _python_chain(rgb_path, alpha_path, cc, oh, ow, bg):
    """The dataset's transform chain in numpy/PIL (tests/test_native_loader.py)."""
    rgb = np.array(Image.open(rgb_path))
    if cc is not None:
        x = rgb / 255
        x = x @ cc[:3, :3] + cc[np.newaxis, :3, 3]
        rgb = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    if rgb.shape[:2] != (oh, ow):
        rgb = np.array(Image.fromarray(rgb).resize((ow, oh), Image.BILINEAR))
    a = np.array(Image.open(alpha_path))
    if a.shape[:2] != (oh, ow):
        a = np.array(Image.fromarray(a).resize((ow, oh), Image.BILINEAR))
    w = a[..., None] / 255
    if bg is not None:
        bg255 = np.full_like(rgb, int(bg[0] * 255))
        rgb = (w * rgb + (1 - w) * bg255).astype(np.uint8)
    return rgb.astype(np.float32) / 255, a.astype(np.float32) / 255


def test_source_is_the_jax_source():
    """The port's copy of frameloader.cpp differs from the JAX package's in
    its header comment alone."""
    def body(p):
        lines = p.read_text().split("\n")
        return lines[next(i for i, ln in enumerate(lines) if not ln.startswith("//")):]
    assert body(tnl.SOURCE) == body(REPO / "vhap_tpu" / "native" / "frameloader.cpp")


CALLS = {
    "decode": lambda m, p, a: m.decode_batch(p, 64, 64),
    "decode_resize": lambda m, p, a: m.decode_batch(p, 40, 24),
    "composite_white": lambda m, p, a: m.decode_composite_batch(p, a, 48, 64, (1.0, 1.0, 1.0)),
    "composite_none": lambda m, p, a: m.decode_composite_batch(p, None, 64, 64, None),
    "load_cc_resize": lambda m, p, a: m.load_batch(p, a, 32, 40, (1.0, 1.0, 1.0),
                                                   color_correction=_ccs(7, len(p))),
    "load_cc_black": lambda m, p, a: m.load_batch(p, a, 64, 64, (0.0, 0.0, 0.0),
                                                  color_correction=_ccs(8, len(p))),
    "load_plain": lambda m, p, a: m.load_batch(p, None, 21, 33, None),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_entry_points_match_jax_bit_for_bit(call, jpgs, jax_lib):
    paths, apaths = jpgs
    got, ref = (CALLS[call](m, paths, apaths) for m in (tnl, jnl))
    assert got is not None and ref is not None
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_decode_and_composite_match_pil(jpgs, jax_lib):
    """No resize: the decode is PIL's bit for bit (one libjpeg); the
    composite is the dataset's formula (tests/test_native_loader.py)."""
    paths, apaths = jpgs
    out = tnl.decode_batch(paths, 64, 64)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(out[i], np.array(Image.open(p)))
    rgb, alpha = tnl.decode_composite_batch(paths, apaths, 64, 64, (1.0, 1.0, 1.0))
    a = np.array(Image.open(apaths[0])).astype(np.float32) / 255
    r = np.array(Image.open(paths[0])).astype(np.float32) / 255
    np.testing.assert_allclose(rgb[0], a[..., None] * r + (1 - a[..., None]), atol=1e-5)
    np.testing.assert_allclose(alpha[0], a, atol=1e-5)


@pytest.mark.parametrize("size", [(32, 32), (64, 64)], ids=["resize", "no_resize"])
def test_load_batch_matches_the_pil_chain(size, jpgs, jax_lib):
    """Colour correction + resize + composite against numpy/PIL: within
    3/255 with a resize (float vs fixed-point filter taps), bit-exact
    without."""
    paths, apaths = jpgs
    ccs = _ccs(9, len(paths))
    bg = (1.0, 1.0, 1.0) if size == (32, 32) else (0.0, 0.0, 0.0)
    rgb, alpha = tnl.load_batch(paths, apaths, *size, bg, color_correction=ccs)
    for i in range(len(paths)):
        want_rgb, want_a = _python_chain(paths[i], apaths[i], ccs[i], *size, bg)
        if size == (64, 64):
            np.testing.assert_array_equal(rgb[i], want_rgb)
            np.testing.assert_array_equal(alpha[i], want_a)
        else:
            assert np.abs(rgb[i] - want_rgb).max() <= RESIZE_TOL, i
            assert np.abs(alpha[i] - want_a).max() <= RESIZE_TOL, i


def test_missing_file_fails_in_both(jpgs, jax_lib):
    paths, apaths = jpgs
    bad = paths[:1] + ["/nonexistent.jpg"]
    for m in (tnl, jnl):
        assert m.decode_batch(bad, 64, 64) is None
        assert m.load_batch(bad, None, 64, 64, None) is None
        # a requested alpha map that does not decode fails the frame
        assert m.load_batch(paths[:2], [apaths[0], "/nonexistent.jpg"], 64, 64,
                            (1.0, 1.0, 1.0)) is None


def _write_monocular(root: Path, n=3, size=(48, 64)):
    """A video folder (images/, alpha_maps/, landmark2d/STAR.npz) of seeded
    smooth frames."""
    rng = np.random.default_rng(3)
    seq = root / "seq"
    for d in ("images", "alpha_maps", "landmark2d"):
        (seq / d).mkdir(parents=True)
    yy, xx = np.mgrid[:size[0], :size[1]] / max(size)
    for t in range(n):
        rgb = np.stack([np.sin(6 * xx + t + c) * 0.5 + 0.5 for c in range(3)], -1)
        rgb = np.clip(rgb + rng.normal(0, 0.05, rgb.shape), 0, 1)
        a = (np.hypot(xx - 0.5, yy - 0.4) < 0.3 + 0.02 * t).astype(np.float64)
        Image.fromarray((rgb * 255).astype(np.uint8)).save(seq / "images" / f"{t:05d}.jpg")
        Image.fromarray((a * 255).astype(np.uint8)).save(seq / "alpha_maps" / f"{t:05d}.jpg")
    lmk = rng.uniform(0.2, 0.8, (n, 68, 3)).astype(np.float32)
    np.savez(seq / "landmark2d" / "STAR.npz", face_landmark_2d=lmk)


def test_monocular_dataset_native_batch(tmp_path, jax_lib):
    """The port's VideoDataset.load_batch_native against JAX's (bit for
    bit) and against its own PIL items (3/255 with a resize); landmarks as
    the PIL path scales them; the two counters."""
    from vhap_tpu.config.base import DataConfig as JCfg
    from vhap_tpu.data.video_dataset import VideoDataset as JDs
    from vhap_tpu_torch.config.base import DataConfig as TCfg
    from vhap_tpu_torch.data.video_dataset import VideoDataset as TDs
    _write_monocular(tmp_path)
    ds = {}
    for side, Cfg, Ds in (("jax", JCfg, JDs), ("port", TCfg, TDs)):
        cfg = Cfg(root_folder=tmp_path, sequence="seq")
        cfg.background_color = "white"
        cfg.scale_factor = 0.5
        ds[side] = Ds(cfg, img_to_tensor=True)
    t = ds["port"]
    assert t.supports_native_batch() and (t.native_batches, t.pil_batches) == (0, 0)
    got, ref = t.load_batch_native([0, 1, 2]), ds["jax"].load_batch_native([0, 1, 2])
    assert t.native_batches == 1
    assert got[0].shape == (3, 24, 32, 3) and got[0].dtype == np.float32
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    for i in range(3):
        item = t[i]
        assert np.abs(got[0][i] - item["rgb"]).max() <= RESIZE_TOL
        np.testing.assert_allclose(t.load_lmk2d(i), item["lmk2d"], atol=1e-4)
    # a configuration the loader does not cover: None, no batch counted
    t.img_to_tensor = False
    assert t.load_batch_native([0]) is None and t.native_batches == 1


def _multiview(root, side, scale_factor=0.5):
    if side == "jax":
        from vhap_tpu.config.nersemble import NersembleDataConfig
        from vhap_tpu.data.nersemble_dataset import NeRSembleDataset
    else:
        from vhap_tpu_torch.config.nersemble import NersembleDataConfig
        from vhap_tpu_torch.data.nersemble_dataset import NeRSembleDataset
    cfg = NersembleDataConfig()
    cfg.root_folder = root
    cfg.subject = "001"
    cfg.sequence = "SEN-01"
    cfg.align_cameras_to_axes = False
    cfg.use_color_correction = True
    cfg.background_color = "white"
    cfg.use_alpha_map = True
    cfg.scale_factor = scale_factor
    return NeRSembleDataset(cfg, img_to_tensor=True)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """3 cameras x 2 timesteps at 64^2 with per-camera affine colour
    correction (the port's tools/make_synthetic_multiview.py)."""
    import torch
    from vhap_tpu_torch.tools.make_synthetic_multiview import generate_multiview
    root = tmp_path_factory.mktemp("rig")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        generate_multiview(root, n_cams=3, n_frames=2, size=64, device="cpu",
                           color_correction=True)
    finally:
        torch.set_num_threads(n)
    return root


def test_multiview_native_matches_jax_and_pil(rig, jax_lib):
    """getitem_by_timestep through the loader (colour correction, 0.5
    scale, white background): the port's batch is JAX's bit for bit, and
    within 3/255 of its own PIL path; metadata equal; one batch counted on
    each path."""
    t, j = _multiview(rig, "port"), _multiview(rig, "jax")
    assert t.color_correction and t.supports_native_batch()
    nat, ref = t.getitem_by_timestep(1), j.getitem_by_timestep(1)
    assert (t.native_batches, t.pil_batches) == (1, 0)
    assert nat["rgb"].shape == (3, 32, 32, 3)
    for k in ("rgb", "alpha_map", "lmk2d", "intrinsic", "extrinsic"):
        np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)
    t.supports_native_batch = lambda: False          # force the PIL path
    pil = t.getitem_by_timestep(1)
    assert (t.native_batches, t.pil_batches) == (1, 1)
    assert np.abs(nat["rgb"] - pil["rgb"]).max() <= RESIZE_TOL
    assert np.abs(nat["alpha_map"] - pil["alpha_map"]).max() <= RESIZE_TOL
    np.testing.assert_allclose(nat["lmk2d"], pil["lmk2d"], atol=1e-4)
    np.testing.assert_allclose(nat["intrinsic"], pil["intrinsic"], rtol=1e-6)
    np.testing.assert_array_equal(nat["extrinsic"], pil["extrinsic"])


def test_non_affine_ccm_takes_the_pil_path_in_both(rig, jax_lib):
    """A NeRSemble v2 colour correction matrix (Cheung 2004 terms, not a
    3x4 affine) is not the loader's: load_batch_native returns None in both
    packages."""
    for side in ("port", "jax"):
        ds = _multiview(rig, side)
        ds.color_correction = {cid: np.eye(9, 3) for cid in ds.color_correction}
        assert ds.load_batch_native([0, 1, 2]) is None, side
        if side == "port":
            assert ds.native_batches == 0


BUILD_SCRIPT = """
import sys, time
from pathlib import Path
import numpy as np
from vhap_tpu_torch.data import native_loader as n
n.BUILD_DIR = Path(sys.argv[1])
while not Path(sys.argv[2]).exists():       # start together
    time.sleep(0.01)
out = n.load_batch([sys.argv[3]], None, 64, 64, None)
print("OK" if out is not None and np.isfinite(out[0]).all() else "FAILED")
"""


def test_concurrent_builds_each_load_a_whole_library(tmp_path, jpgs):
    """Two processes that build at once into one (empty) build folder both
    load a working library; one library is left, no temporary file."""
    build, go = tmp_path / "build", tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(build), str(go),
                               jpgs[0][0]], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [o[0].strip() for o in outs] == ["OK", "OK"], [o[1][-2000:] for o in outs]
    assert [p.name for p in build.iterdir()] == [tnl.library_path(tnl.pillow_libjpeg()).name]
