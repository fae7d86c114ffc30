"""Port parity of the NeRF-dataset export (export_as_nerf_dataset.py,
data/nerf_dataset.py, combine_nerf_datasets.py) against the JAX package on
the CPU: both packages export the same tracked run, written by the JAX
package (its config.yml names the JAX package's dataset class), with the
same teeth head (`flame_model=`, the fixture regions of
tools/surgery_regions.py carrying the neck points of the neck-line mask):

  * transforms*.json (the splits included) equal to rtol 1e-6;
  * every flame_param/*.npz and canonical_flame_param.npz within 1e-5;
  * the written images and fg masks within 1 uint8 level, with the mask
    from the mesh on;
  * combine of two exports identical;

on a calibrated 4-camera NeRSemble run and a monocular run (its optimized
focal length replaces the guessed cameras). These replace, for the port,
tests/test_export.py, which needs the FLAME template.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from test_export import _assert_json_equal

NS, NE, S, T = 20, 10, 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    """The JAX teeth head and the port's carried over from it."""
    from vhap_tpu.model.flame import FlameHead as JHead
    from vhap_tpu_torch.convert import head_from_built_head
    from vhap_tpu_torch.tools.surgery_regions import write_region_assets
    assets = tmp_path_factory.mktemp("assets")
    write_region_assets(assets)
    jh = JHead.build(NS, NE, asset_dir=assets, add_teeth=True)
    return assets, jh, head_from_built_head(jh, device="cpu")


@pytest.fixture(scope="module", params=["nersemble", "monocular"])
def tracked_run(request, heads, tmp_path_factory):
    """A finished run in the JAX package's layout: frames, its config.yml
    (saved by the JAX package) and tracked_flame_params_<epoch>.npz."""
    from vhap_tpu.config.cli import save_yaml
    from vhap_tpu.tracker import params as JP
    assets, _, th = heads
    root = tmp_path_factory.mktemp(request.param)
    calibrated = request.param == "nersemble"
    if calibrated:
        from vhap_tpu.config.nersemble import NersembleTrackingConfig
        from vhap_tpu_torch.tools.make_synthetic_multiview import generate_multiview
        gt, _ = generate_multiview(root / "data", n_cams=4, n_frames=T, size=S,
                                   head=th, color_correction=True)
        cfg = NersembleTrackingConfig()
        cfg.data.subject, cfg.data.sequence = "001", "SEN-01"
        cfg.data.align_cameras_to_axes = False
    else:
        from vhap_tpu.config.base import BaseTrackingConfig
        from vhap_tpu_torch.tools.make_synthetic_sequence import generate
        gt = generate(root / "data" / "seq", n_frames=T, size=S, head=th)
        cfg = BaseTrackingConfig()
        cfg.data.sequence = "seq"
        cfg.data.use_alpha_map = True
    cfg.data.root_folder = root / "data"
    cfg.data.background_color = None
    cfg.model.n_shape, cfg.model.n_expr = NS, NE
    cfg.model.asset_dir = assets
    cfg.__post_init__()
    run_dir = root / "track" / "2026-01-01_00-00-00"
    run_dir.mkdir(parents=True)
    save_yaml(cfg, run_dir / "config.yml")
    p = {k: np.array(v) for k, v in JP.init_params(
        T, NS, NE, 100, th.num_verts, 64, True, True, True, True, False,
        calibrated).items()}
    rng = np.random.default_rng(1)
    for k in ("rotation", "translation", "jaw_pose", "expr"):
        p[k] = (gt[k] + rng.normal(0, 0.01, gt[k].shape)).astype(np.float32)
    p["translation"] += np.float32(0.02)
    p["static_offset"] = rng.normal(0, 1e-3, p["static_offset"].shape).astype(np.float32)
    if not calibrated:
        p["focal_length"] = np.asarray([1.8], np.float32)
    JP.save_result(p, run_dir / "tracked_flame_params_30.npz",
                   timestep_ids=[f"{i:05d}" for i in range(T)], n_processed=T,
                   image_size=(S, S), calibrated=calibrated, tex_painted=True)
    return root, run_dir, p


@pytest.fixture(scope="module")
def exports(heads, tracked_run):
    """Both packages' export of the run, the mask from the mesh on."""
    from vhap_tpu.export_as_nerf_dataset import export as jexport
    from vhap_tpu_torch.export_as_nerf_dataset import export as texport
    _, jh, th = heads
    root, run_dir, _ = tracked_run
    jexport(run_dir.parent, root / "jax", flame_mode="param",
            create_mask_from_mesh=True, flame_model=jh)
    texport(run_dir.parent, root / "port", flame_mode="param",
            create_mask_from_mesh=True, flame_model=th)
    return root / "jax", root / "port"


def test_export_transforms_match_jax(exports):
    """transforms.json, its backups and the train/val/test splits."""
    ja, po = exports
    names = sorted(p.name for p in ja.glob("transforms*.json"))
    assert names == sorted(p.name for p in po.glob("transforms*.json"))
    assert {"transforms_train.json", "transforms_val.json",
            "transforms_test.json"} <= set(names)
    for name in names:
        _assert_json_equal(json.load(open(po / name)), json.load(open(ja / name)),
                           path=name, rtol=1e-6)


def test_export_flame_params_match_jax(exports, tracked_run):
    ja, po = exports
    rels = sorted(p.relative_to(ja) for p in ja.rglob("*.npz"))
    assert rels == sorted(p.relative_to(po) for p in po.rglob("*.npz"))
    assert len(rels) == T + 1
    for rel in rels:
        za, zb = dict(np.load(ja / rel)), dict(np.load(po / rel))
        assert set(za) == set(zb), rel
        for k in za:
            np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=1e-5,
                                       err_msg=f"{rel}:{k}")
    cano = np.load(po / "canonical_flame_param.npz")
    np.testing.assert_allclose(cano["jaw_pose"], [[0.3, 0, 0]], atol=1e-6)


def test_export_images_match_jax(exports, tracked_run, tmp_path):
    """Frames and fg masks after the neck-line mask: within 1 uint8 level;
    against the frames before it (the port's first writer alone), the mask
    took foreground below the neck line."""
    from vhap_tpu_torch.export_as_nerf_dataset import NeRFDatasetWriter, load_config
    ja, po = exports
    rels = sorted(p.relative_to(ja) for p in ja.rglob("*.png"))
    assert rels == sorted(p.relative_to(po) for p in po.rglob("*.png")) and rels
    _, cfg = load_config(tracked_run[1].parent)
    NeRFDatasetWriter(cfg.data, tmp_path).write()
    masked = 0
    for rel in rels:
        a = np.asarray(Image.open(ja / rel)).astype(np.int16)
        b = np.asarray(Image.open(po / rel)).astype(np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel
        if rel.parts[0] == "fg_masks":
            before = np.asarray(Image.open(tmp_path / rel)).astype(np.int16)
            assert (b <= before).all()
            masked += int(((b == 0) & (before > 0)).sum())
    assert masked > 0


def test_export_reads_jax_run_as_port_dataset(tracked_run):
    """The run's config.yml names the JAX package's dataset class; the
    port's export reads it as its own, and the tracked npz loads as the
    port's parameters."""
    from vhap_tpu_torch.convert import params_from_tracked_run
    from vhap_tpu_torch.export_as_nerf_dataset import load_config
    _, run_dir, p = tracked_run
    _, cfg = load_config(run_dir.parent)
    raw = (run_dir / "config.yml").read_text()
    assert "vhap_tpu.data." in raw
    assert cfg.data._target.startswith("vhap_tpu_torch.data.")
    got = params_from_tracked_run(run_dir / "tracked_flame_params_30.npz", device="cpu")
    assert set(got) == set(p)
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), p[k], err_msg=k)


def test_nerf_dataset_reader_matches_jax(exports):
    from vhap_tpu.data.nerf_dataset import NeRFDataset as J
    from vhap_tpu_torch.data.nerf_dataset import NeRFDataset as Tn
    ja, po = exports
    for division in (None, "train", "val"):
        jd = J(ja, division=division, use_fg_mask=True, use_flame_param=True)
        td = Tn(po, division=division, use_fg_mask=True, use_flame_param=True)
        assert len(td) == len(jd)
        if not len(jd):          # a monocular run has no validation camera
            continue
        a, b = jd[0], td[0]
        assert set(a) == set(b)
        for k in ("intrinsics", "extrinsics"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7)
        assert np.abs(b["image"].astype(int) - a["image"].astype(int)).max() <= 1
        for k in a["flame_param"]:
            np.testing.assert_allclose(b["flame_param"][k], a["flame_param"][k],
                                       rtol=0, atol=1e-5)


def test_combine_matches_jax(heads, tracked_run, tmp_path):
    """combine of two exports of the run (division 'last'), both packages:
    identical transforms and sequence lists."""
    from vhap_tpu.combine_nerf_datasets import combine as jcombine
    from vhap_tpu.export_as_nerf_dataset import export as jexport
    from vhap_tpu_torch.combine_nerf_datasets import combine as tcombine
    from vhap_tpu_torch.export_as_nerf_dataset import export as texport
    _, jh, th = heads
    _, run_dir, _ = tracked_run
    outs = []
    for side, export, combine, head in (("jax", jexport, jcombine, jh),
                                        ("port", texport, tcombine, th)):
        parent = tmp_path / side
        for name in ("001_a", "001_b"):
            export(run_dir.parent, parent / name, flame_mode="param",
                   create_mask_from_mesh=False, flame_model=head)
        combine([parent / "001_a", parent / "001_b"], parent / "UNION_001",
                division_mode="last")
        outs.append(parent / "UNION_001")
    ja, po = outs
    names = sorted(p.name for p in ja.iterdir())
    assert names == sorted(p.name for p in po.iterdir())
    for name in names:
        if name.endswith(".json"):
            _assert_json_equal(json.load(open(po / name)), json.load(open(ja / name)),
                               path=name, rtol=1e-6)
        elif name.endswith(".txt"):
            assert (po / name).read_text() == (ja / name).read_text()
    te = json.load(open(po / "transforms_test.json"))
    assert te["timestep_indices"] == list(range(T, 2 * T))


def test_head_from_built_head_matches_port_build(heads):
    """convert.head_from_built_head carries the JAX teeth head over with
    the buffers and regions the port's own build makes."""
    from vhap_tpu_torch.model.flame import FlameHead
    assets, jh, th = heads
    own = FlameHead.build(NS, NE, asset_dir=assets, device="cpu")
    for (name, a), b in zip(own.named_buffers(), th.buffers()):
        assert torch.equal(a, b), name
    for k in own.masks.v:
        assert np.array_equal(own.masks.v[k], th.masks.v[k]), k
    assert np.array_equal(own.masks.fid2cid, th.masks.fid2cid)
    assert np.array_equal(np.asarray(jh.faces), th.faces.numpy())


def test_export_runs_on_the_card_unless_asked(tracked_run, tmp_path, monkeypatch):
    """FLAME of the export runs on the card by default: without one the
    export raises unless device='cpu' is given."""
    from vhap_tpu_torch.export_as_nerf_dataset import export
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export(tracked_run[1].parent, tmp_path / "out", create_mask_from_mesh=False)
    export(tracked_run[1].parent, tmp_path / "cpu", create_mask_from_mesh=False,
           device="cpu")
    assert (tmp_path / "cpu" / "transforms_train.json").exists()
