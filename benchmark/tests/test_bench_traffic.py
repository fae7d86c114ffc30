"""The stand-in head and the scene writers."""

import json
import pickle

import numpy as np
import torch

from traffic import head, scene


def test_stand_in_has_flames_face_count():
    v, f, uv = head.grid_mesh()
    assert v.shape == (5074, 3) and f.shape == (9976, 3) and uv.shape == (5074, 2)
    assert f.min() == 0 and f.max() == 5073


def test_teeth_head_builds_through_the_asset_folder(tmp_path):
    from vhap_tpu_torch.model.flame import FlameHead
    d = head.write_assets(tmp_path / "assets", seed=3)
    with open(d / "FLAME_masks.pkl", "rb") as fh:
        masks = pickle.load(fh)
    regions = head.surgery_regions(head.grid_mesh()[0])
    assert len(regions["lip_outside_ring_upper"]) == head.N_RING
    assert all(k in masks for k in regions)
    plain = FlameHead.build(n_shape=20, n_expr=10, asset_dir=d, add_teeth=False,
                            device="cpu")
    teeth = FlameHead.build(n_shape=20, n_expr=10, asset_dir=d, add_teeth=True,
                            remove_lip_inside=True, device="cpu")
    assert plain.num_verts == 5074 and plain.faces.shape[0] == 9976
    assert teeth.num_verts > plain.num_verts


def test_monocular_layout(tmp_path):
    d = head.write_assets(tmp_path / "a", seed=1)
    model = {"n_shape": 20, "n_expr": 10, "add_teeth": False, "remove_lip_inside": False}
    out = scene.write_scene(tmp_path / "data", {"layout": "monocular", "image_size": [32, 32],
                                                "focal": 1.5, "period": 3},
                            model, 7, 1, d, torch.device("cpu"))
    seq = tmp_path / "data" / out["sequence"]
    assert sorted(p.name for p in (seq / "images").iterdir()) == [f"{t:05d}.jpg" for t in range(7)]
    assert len(list((seq / "alpha_maps").iterdir())) == 7
    lmk = np.load(seq / "landmark2d" / "STAR.npz")["face_landmark_2d"]
    assert lmk.shape[0] == 7 and lmk.shape[2] == 3
    assert np.array_equal(lmk[0], lmk[3])             # the period repeats
    assert 0.2 < lmk[0, :, :2].mean() < 0.8


def test_rig_layout(tmp_path):
    from reference.data import rig_batch
    d = head.write_assets(tmp_path / "a", seed=2)
    model = {"n_shape": 20, "n_expr": 10, "add_teeth": True, "remove_lip_inside": True}
    sc = {"layout": "rig", "cameras": 4, "image_size_calibration": [128, 88],
          "n_downsample": 4, "focal_px": 290.0, "distance": 1.0, "span_deg": 120.0,
          "rows_deg": [-10.0, 10.0], "period": 2}
    out = scene.write_scene(tmp_path / "data", sc, model, 3, 2, d, torch.device("cpu"))
    root = tmp_path / "data"
    params = json.loads((root / "camera_params" / "001" / "camera_params.json").read_text())
    assert len(params["world_2_cam"]) == 4
    b = rig_batch(root, out["subject"], out["sequence"], 2, (128, 88), 4, True, "cpu")
    assert tuple(b["rgb"].shape) == (4, 32, 22, 3)
    assert (b["rgb"] < 0.98).float().mean() > 0.1     # the head is in view
    assert tuple(b["intrinsic"].shape) == (4, 3, 3) and float(b["intrinsic"][0, 1, 2]) == 16.0
