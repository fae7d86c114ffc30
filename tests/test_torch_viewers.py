"""Port parity of the headless viewers (flame_viewer.py, flame_editor.py,
util/visualization.py) against vhap_tpu's on the CPU: the sequence viewer's
frames on an archive written by the JAX package's params.save_result (its
residual texture resized onto the painted one), the editor's sweeps with a
highlighted region and with LBS colours, and the landmark overlay bit for
bit; then the port's own camera, sequence writer, GUI guard and CLI.

The JAX side renders through its render_rgba_vis jitted whole (eagerly, its
per-op compiles take ~20 s a configuration); jitted and eager JAX round the
rasterizer's attributes up to 3e-5 apart (tests/test_torch_vis.py), so the
uint8 frames may differ by one level on a few pixels: at most one level, on
at most 0.1 % of the values.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from vhap_tpu.ops import render as jrender
from vhap_tpu.util import visualization as jvis
from vhap_tpu_torch.util import visualization as tvis

FRAME_LEVELS, FRAME_SHARE = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_render_jitted(monkeypatch):
    """vhap_tpu's render_rgba_vis, jitted whole per image size and settings."""
    orig, cache = jrender.render_rgba_vis, {}

    def render(verts, faces, RT, K, image_size, settings, **kw):
        key = (tuple(image_size), id(settings))
        if key not in cache:
            cache[key] = jax.jit(lambda v, f, rt, k, kw: orig(
                v, f, rt, k, image_size, settings, **kw))
        return cache[key](verts, faces, RT, K, kw)
    monkeypatch.setattr(jrender, "render_rgba_vis", render)


def _same_frames(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= FRAME_LEVELS and (d > 0).mean() <= FRAME_SHARE, \
        (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A 2-frame tracked archive (params.save_result) with perturbed
    expression, pose and a 64^2 residual texture."""
    from vhap_tpu.tracker import params as P
    p = P.init_params(2, 20, 10, 100, 100, 64, True, True, True, False, False, False)
    rng = np.random.default_rng(0)
    p = {k: (np.asarray(v) + rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
             if k in ("expr", "jaw_pose", "rotation", "shape", "tex_extra") else v)
         for k, v in p.items()}
    path = tmp_path_factory.mktemp("viewer") / "tracked.npz"
    P.save_result(p, path, ["00000", "00001"], 2, (128, 128), False, True)
    return path


@pytest.mark.parametrize("colors", ["green", (10, 200, 30)])
@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_plot_landmarks_2d_is_bit_identical(kind, colors):
    assert tvis.LANDMARK_CONNECTIVITY == jvis.LANDMARK_CONNECTIVITY
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    if kind == "uint8":
        img = (img * 255).astype(np.uint8)
    lmks = rng.uniform(-5, 60, (68, 3)).astype(np.float32)
    lmks[[3, 40]] = np.nan                      # not drawn, nor their lines
    for kw in ({}, dict(unit=2.6, connectivity=False)):
        got = tvis.plot_landmarks_2d(img, lmks, colors, **kw)
        ref = jvis.plot_landmarks_2d(img, lmks, colors, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_viewer_frames_match_jax(archive, jax_render_jitted):
    from vhap_tpu.flame_viewer import FlameViewer
    from vhap_tpu_torch.flame_viewer import FlameViewer as FlameViewer_port
    ref = FlameViewer(archive, n_shape=20, n_expr=10, add_teeth=False, W=128, H=128)
    got = FlameViewer_port(archive, n_shape=20, n_expr=10, add_teeth=False, W=128,
                           H=128, device="cpu")
    assert got.n_timesteps == ref.n_timesteps == 2
    assert tuple(got.tex.shape) == (1, 3, 64, 64)   # painted 512^2 resized to tex_extra's
    for t in range(2):
        frame = got.render_frame(t)
        assert frame.std() > 0
        _same_frames(frame, ref.render_frame(t))


@pytest.mark.parametrize("kw", [dict(highlight_region="face"), dict(lbs_color=True)],
                         ids=["highlight", "lbs_color"])
def test_editor_sweep_matches_jax(kw, tmp_path, jax_render_jitted, monkeypatch):
    from vhap_tpu.flame_editor import FlameEditor as JEditor
    from vhap_tpu_torch.flame_editor import FlameEditor
    ref = JEditor(n_shape=20, n_expr=10, add_teeth=False, W=64, H=64, **kw)
    ed = FlameEditor(n_shape=20, n_expr=10, add_teeth=False, W=64, H=64,
                     device="cpu", **kw)
    np.testing.assert_array_equal(ed.v_color.numpy(), np.asarray(ref.v_color))
    grid = ed.render_sweep(tmp_path / "port", "jaw", -0.2, 0.3, steps=3)
    assert grid.shape == (64, 64 * 3, 3)
    assert not np.array_equal(grid[:, :64], grid[:, -64:])      # the jaw moved
    assert (tmp_path / "port" / "sweep_jaw.png").exists()
    _same_frames(grid, ref.render_sweep(tmp_path / "jax", "jaw", -0.2, 0.3, steps=3))
    ed.set_param("expr2", 0.5)
    ed.set_param("eyes", [0.1, -0.1])
    assert ed.state["expr"][2] == 0.5 and list(ed.state["eyes"][:2]) == [
        np.float32(0.1), np.float32(-0.1)]
    with pytest.raises(KeyError):
        ed.set_param("nose", 1.0)
    monkeypatch.setitem(sys.modules, "dearpygui", None)
    monkeypatch.setitem(sys.modules, "dearpygui.dearpygui", None)
    with pytest.raises(RuntimeError, match="requires dearpygui"):
        ed.run_gui()


def test_viewer_cli_camera_sequence_and_gui_guard(archive, tmp_path, monkeypatch):
    """main() at 48^2 on the CPU writes one PNG a timestep; the orbit camera
    moves the view; no mp4 without ffmpeg; the GUI raises without
    dearpygui."""
    from vhap_tpu_torch import flame_viewer
    viewer = flame_viewer.main(["--param_path", str(archive), "--out_dir", str(tmp_path),
                                "--n_shape", "20", "--n_expr", "10", "--no-teeth",
                                "--size", "48", "--device", "cpu"])
    assert viewer.W == viewer.H == 48
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == [
        "00000.png", "00001.png"]
    frame = viewer.render_frame(0)
    viewer.cam.orbit(30, 10)
    viewer.cam.scale(1)
    assert not np.array_equal(frame, viewer.render_frame(0))   # camera moved
    monkeypatch.setattr("shutil.which", lambda name: None)      # no ffmpeg
    viewer.render_sequence(tmp_path / "out", video=True)
    assert len(list((tmp_path / "out/frames").glob("*.png"))) == 2
    assert not (tmp_path / "out/sequence.mp4").exists()
    monkeypatch.setitem(sys.modules, "dearpygui", None)
    monkeypatch.setitem(sys.modules, "dearpygui.dearpygui", None)
    with pytest.raises(RuntimeError, match="requires dearpygui"):
        viewer.run_gui()
