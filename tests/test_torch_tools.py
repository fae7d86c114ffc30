"""Port parity of the slice's entry points against the JAX package on the
CPU: the synthetic sequence and multiview generators (the files they write
and the frames they render) and the UV-mask baker.

The generators are held to the JAX ones in what they decide: parameters,
cameras, landmarks, what they hand the renderer and the files they write.
The renderer itself is held to JAX's in tests/test_torch_vis_render.py
(against JAX run op by op: that takes seconds per image shape), so here
the JAX generator's `render_rgba_vis` calls are served by the port's
renderer on the JAX generator's own inputs; its frames must then equal the
port generator's within 1e-5 before JPEG encoding.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from vhap_tpu.model.assets import load_flame_assets
from vhap_tpu.model.flame import FlameHead
from vhap_tpu.ops import render as jrender
from vhap_tpu_torch.convert import head_from_assets
from vhap_tpu_torch.ops import render as trender

NS, NE, SIZE = 10, 5, 48


@pytest.fixture(scope="module")
def heads():
    a = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    jh = FlameHead.build(n_shape=NS, n_expr=NE, assets=a, add_teeth=False)
    return jh, head_from_assets(a, NS, NE, device="cpu")


def _recording(fn, frames):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        frames.append(np.asarray(out["rgba"]))
        return out
    return wrapped


def _port_renderer(verts, faces, RT, K, image_size, settings, **kwargs):
    """JAX's render_rgba_vis call served by the port's renderer."""
    t = {k: None if v is None else torch.as_tensor(np.array(v))
         for k, v in dict(kwargs, verts=verts, RT=RT, K=K).items()}
    t["faces_uv"] = t["faces_uv"].long()
    out = trender.render_rgba_vis(
        t.pop("verts"), torch.as_tensor(np.array(faces)).long(), t.pop("RT"),
        t.pop("K"), image_size,
        trender.RenderSettings(lighting_type=settings.lighting_type,
                               lighting_space=settings.lighting_space,
                               cull_backfaces=settings.cull_backfaces,
                               antialias=settings.antialias), **t)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture
def record(monkeypatch):
    """Record the frames both generators render."""
    frames = {"jax": [], "port": []}
    monkeypatch.setattr(jrender, "render_rgba_vis",
                        _recording(_port_renderer, frames["jax"]))

    def port(module):
        monkeypatch.setattr(module, "render_rgba_vis",
                            _recording(module.render_rgba_vis, frames["port"]))
    return frames, port


def _assert_frames_match(frames, n):
    assert len(frames["jax"]) == len(frames["port"]) == n
    for a, b in zip(frames["jax"], frames["port"]):
        assert a.shape == b.shape and (a[..., 3] > 0).mean() > 0.05
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def _assert_images_match(paths_a, paths_b):
    """Decoded JPEGs within 3/255 on 99.9 % of the pixels."""
    assert len(paths_a) == len(paths_b) > 0
    for pa, pb in zip(paths_a, paths_b):
        assert pa.name == pb.name
        a = np.asarray(Image.open(pa), np.int16)
        b = np.asarray(Image.open(pb), np.int16)
        assert a.shape == b.shape
        assert (np.abs(a - b) > 3).mean() <= 1e-3, pa.name


def _assert_npz_match(pa, pb, atol=1e-5):
    za, zb = np.load(pa), np.load(pb)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=atol, err_msg=k)


def test_make_synthetic_sequence_matches_jax(tmp_path, heads, record):
    from vhap_tpu.tools.make_synthetic_sequence import generate as jgen
    from vhap_tpu_torch.tools import make_synthetic_sequence as tseq
    frames, port = record
    port(tseq)
    jh, th = heads
    ja, tb = tmp_path / "jax", tmp_path / "port"
    gt_j = jgen(ja, n_frames=2, size=SIZE, head=jh)
    gt_t = tseq.generate(tb, n_frames=2, size=SIZE, head=th)
    assert sorted(gt_j) == sorted(gt_t)
    _assert_frames_match(frames, 2)
    _assert_npz_match(ja / "gt_params.npz", tb / "gt_params.npz")
    _assert_npz_match(ja / "landmark2d/STAR.npz", tb / "landmark2d/STAR.npz")
    for sub in ("images", "alpha_maps"):
        _assert_images_match(sorted((ja / sub).glob("*.jpg")),
                             sorted((tb / sub).glob("*.jpg")))


def test_make_synthetic_multiview_matches_jax(tmp_path, heads, record):
    from vhap_tpu.tools.make_synthetic_multiview import generate_multiview as jgen
    from vhap_tpu_torch.tools import make_synthetic_multiview as tmv
    frames, port = record
    port(tmv)
    jh, th = heads
    ja, tb = tmp_path / "jax", tmp_path / "port"
    gt_j, cams_j = jgen(ja, n_cams=2, n_frames=2, size=SIZE, head=jh)
    gt_t, cams_t = tmv.generate_multiview(tb, n_cams=2, n_frames=2, size=SIZE,
                                          head=th)
    assert cams_j == cams_t and sorted(gt_j) == sorted(gt_t)
    _assert_frames_match(frames, 2)
    cam = "camera_params/001/camera_params.json"
    assert json.loads((ja / cam).read_text()) == json.loads((tb / cam).read_text())
    seq = "001/SEN-01"
    _assert_npz_match(ja / seq / "gt_params.npz", tb / seq / "gt_params.npz")
    for cid in cams_j:
        _assert_npz_match(ja / seq / f"landmark2d/STAR/{cid}.npz",
                          tb / seq / f"landmark2d/STAR/{cid}.npz")
    for sub in ("images", "alpha_maps"):
        _assert_images_match(sorted((ja / seq / sub).glob("*.jpg")),
                             sorted((tb / seq / sub).glob("*.jpg")))


def test_generate_flame_uvmask_matches_jax(tmp_path, heads):
    """Masks equal except on at most 0.1 % of the texels; the files as the
    JAX package writes them."""
    from vhap_tpu.generate_flame_uvmask import generate as jgen
    from vhap_tpu_torch.generate_flame_uvmask import generate as tgen
    jh, th = heads
    regions = sorted(jh.masks.vt)[:2]
    assert regions and regions == sorted(th.masks.vt)[:2]
    mj = jgen(tmp_path / "jax", resolution=64, head=jh, regions=regions)
    mt = tgen(tmp_path / "port", resolution=64, head=th, regions=regions)
    assert sorted(mj) == sorted(mt) == regions
    z = np.load(tmp_path / "port" / "uv_masks.npz")
    for name in regions:
        assert mt[name].shape == (64, 64) and mt[name].any()
        assert (mt[name] != mj[name]).mean() <= 1e-3, name
        np.testing.assert_array_equal(z[name], mt[name])
        png = np.asarray(Image.open(tmp_path / "port" / "uv_masks" / f"{name}.png"))
        np.testing.assert_array_equal(png > 0, mt[name])


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without device= the generators and the baker build their head on
    the CUDA card, and raise where there is none."""
    from vhap_tpu_torch import generate_flame_uvmask as guv
    from vhap_tpu_torch.tools import make_synthetic_multiview as tmv
    from vhap_tpu_torch.tools import make_synthetic_sequence as tseq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tseq.generate(tmp_path / "a", n_frames=1, size=16),
                 lambda: tmv.generate_multiview(tmp_path / "b", n_frames=1, size=16),
                 lambda: guv.generate(tmp_path / "c", resolution=16, regions=[])):
        with pytest.raises((RuntimeError, NotImplementedError)):
            call()
