"""Port parity of the calibrated multiview (NeRSemble) path against the JAX
package on the CPU, on one rig (4 cameras x 3 timesteps at 32^2, per-camera
affine colour correction) written once by the port's generator with the
teeth head of tools/surgery_regions.py:

  * the NeRSemble v1 and v2 datasets' items (cameras after conversion,
    colour correction, divisions) and util/color_correction.py;
  * the calibrated evaluation energy and the rgb_sequential_tracking
    energy and gradient, all 4 views of one timestep in the batch (one
    timestep index 4 times: its gradients sum);
  * a landmark-only GlobalTracker run of both packages (the schedule of
    tests/test_multiview.py::test_multiview_tracker_loop), each stage's
    steps held side by side, and ground-truth recovery;
  * the track_nersemble_v2 CLI on the CPU.

The port's side runs on one torch thread (see tests/test_torch_tracker.py).
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhap_tpu.config.nersemble import NersembleTrackingConfig as JConfig
from vhap_tpu.config.nersemble_v2 import NersembleV2TrackingConfig as JConfigV2
from vhap_tpu_torch.config.nersemble import NersembleTrackingConfig as TConfig
from vhap_tpu_torch.config.nersemble_v2 import NersembleV2TrackingConfig as TConfigV2

NS, NE, R, S, N_CAMS, N_T = 20, 10, 64, 32, 4, 3
SUBJECT, SEQ = "001", "SEN-01"
CLUSTERS = ("skin", "hair", "boundary", "lips_tight", "teeth", "sclerae", "irises")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """The v1 rig, its v2 layout (same frames; a Cheung 2004 CCM per
    camera) and the region assets both packages load the teeth head from."""
    from vhap_tpu_torch.model.flame import FlameHead
    from vhap_tpu_torch.tools.make_synthetic_multiview import generate_multiview
    from vhap_tpu_torch.tools.surgery_regions import write_region_assets
    root = tmp_path_factory.mktemp("mv")
    write_region_assets(root / "assets")
    head = FlameHead.build(n_shape=NS, n_expr=NE, asset_dir=root / "assets",
                           device="cpu")
    gt, cams = generate_multiview(root / "v1", SUBJECT, SEQ, n_cams=N_CAMS,
                                  n_frames=N_T, size=S, head=head,
                                  color_correction=True)
    v2 = root / "v2" / SUBJECT
    shutil.copytree(root / "v1" / SUBJECT / SEQ, v2 / "sequences" / SEQ)
    (v2 / "calibration").mkdir()
    shutil.copy(root / "v1" / "camera_params" / SUBJECT / "camera_params.json",
                v2 / "calibration" / "camera_params.json")
    rng = np.random.default_rng(9)
    ccm = {c: (np.hstack([np.eye(3), np.zeros((3, 7))])
               + rng.normal(0, 0.02, (3, 10))).tolist() for c in cams}
    (v2 / "calibration" / "color_calibration.json").write_text(json.dumps(ccm))
    return root, gt, cams


def _data_cfg(cls, root, version="v1", **kw):
    cfg = cls().data
    cfg.root_folder = Path(root) / version
    cfg.subject, cfg.sequence = SUBJECT, SEQ
    cfg.background_color = None
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _datasets(root, version, **kw):
    if version == "v1":
        from vhap_tpu.data.nersemble_dataset import NeRSembleDataset as J
        from vhap_tpu_torch.data.nersemble_dataset import NeRSembleDataset as T
        jc, tc = JConfig, TConfig
    else:
        from vhap_tpu.data.nersemble_v2_dataset import NeRSembleV2Dataset as J
        from vhap_tpu_torch.data.nersemble_v2_dataset import NeRSembleV2Dataset as T
        jc, tc = JConfigV2, TConfigV2
    return (J(_data_cfg(jc, root, version, **kw), batchify_all_views=False),
            T(_data_cfg(tc, root, version, **kw), batchify_all_views=False))


@pytest.mark.parametrize("version,align", [("v1", True), ("v1", False), ("v2", True)])
def test_nersemble_items_match_jax(rig, version, align):
    """Every item of the PIL path: cameras after conversion within 1e-6,
    colour-corrected frames, alpha maps and landmarks equal; the port's
    one-timestep batch stacks its items."""
    root, _, cams = rig
    jd, td = _datasets(root, version, align_cameras_to_axes=align,
                       use_alpha_map=True)
    assert td.camera_ids == jd.camera_ids == cams and len(td) == len(jd) == N_CAMS * N_T
    for i in range(len(jd)):
        a, b = jd.getitem_single_image(i), td.getitem_single_image(i)
        assert set(a) == set(b)
        for k in ("intrinsic", "extrinsic", "lmk2d"):
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)
        for k in ("rgb", "alpha_map"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        for k in ("timestep_index", "camera_id", "timestep_id"):
            assert a[k] == b[k]
    from PIL import Image
    raw = np.asarray(Image.open(td.get_property_path("rgb", 0)))
    assert not np.array_equal(raw, td.getitem_single_image(0)["rgb"])   # corrected
    td.batchify_all_views = True
    item = td[1]
    assert item["rgb"].shape == (N_CAMS, S, S, 3) and item["num_cameras"] == N_CAMS
    for ci in range(N_CAMS):
        one = td.getitem_single_image(N_CAMS + ci)
        np.testing.assert_array_equal(item["rgb"][ci], one["rgb"])
        np.testing.assert_array_equal(item["extrinsic"][ci], one["extrinsic"])


@pytest.mark.parametrize("division", [None, "train", "val", "side-view"])
def test_nersemble_divisions_match_jax(rig, division):
    root, _, _ = rig
    jd, td = _datasets(root, "v1", division=division)
    assert td.camera_ids == jd.camera_ids and len(td) == len(jd)
    for name in ("intrinsic", "extrinsic"):
        for c in td.camera_ids:
            np.testing.assert_allclose(td.camera_params[c][name],
                                       jd.camera_params[c][name], rtol=0, atol=1e-6)


def test_color_correction_matches_jax():
    from vhap_tpu.util import color_correction as J
    from vhap_tpu_torch.util import color_correction as T
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(6, 5, 3))
    for f in ("cctf_decoding", "cctf_encoding"):
        assert np.array_equal(getattr(T, f)(x), getattr(J, f)(x)), f
    for terms in (3, 5, 7, 8, 10, 11, 14, 16, 17, 19, 20, 22):
        assert np.array_equal(T.matrix_augmented_Cheung2004(x, terms),
                              J.matrix_augmented_Cheung2004(x, terms)), terms
        ccm = rng.normal(0, 0.3, (3, terms))
        assert np.array_equal(T.color_correction_Cheung2004_precomputed(x, ccm),
                              J.color_correction_Cheung2004_precomputed(x, ccm))
    u8 = rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)
    ccm = np.hstack([np.eye(3), rng.normal(0, 0.05, (3, 7))])
    assert np.array_equal(T.correct_color(u8, ccm), J.correct_color(u8, ccm))
    assert np.array_equal(T.correct_color(x, ccm), J.correct_color(x, ccm))


# ---------------------------------------------------------------------------
# the calibrated energies: all views of one timestep
# ---------------------------------------------------------------------------

def _energy_config(cls, root):
    cfg = cls()
    cfg.data = _data_cfg(cls, root)
    cfg.model.n_shape, cfg.model.n_expr, cfg.model.tex_resolution = NS, NE, R
    cfg.model.tex_clusters = CLUSTERS
    cfg.model.asset_dir = Path(root) / "assets"
    cfg.render.disturb_rate_fg = cfg.render.disturb_rate_bg = None
    cfg.__post_init__()
    return cfg


@pytest.fixture(scope="module")
def calibrated(rig):
    """Both teeth heads, the parameters (no focal length) and the batch of
    timestep 1's 4 views, read by the port's dataset."""
    from vhap_tpu.model.flame import FlameHead as JHead
    from vhap_tpu.tracker import params as JP
    from vhap_tpu_torch.data.nersemble_dataset import NeRSembleDataset
    from vhap_tpu_torch.model.flame import FlameHead as THead
    root, gt, _ = rig
    jh = JHead.build(NS, NE, asset_dir=root / "assets", face_clusters=CLUSTERS)
    th = THead.build(NS, NE, asset_dir=root / "assets", face_clusters=CLUSTERS,
                     device="cpu")
    rng = np.random.default_rng(3)
    p = {k: np.array(v) for k, v in JP.init_params(
        N_T, NS, NE, 100, th.num_verts, R, True, True, True, True, False,
        True).items()}
    assert "focal_length" not in p
    for k in ("expr", "rotation", "jaw_pose", "translation"):
        p[k] = (gt[k] + rng.normal(0, 0.02, gt[k].shape)).astype(np.float32)
    p["shape"] = gt["shape"].astype(np.float32)
    p["tex_extra"] = rng.normal(0, 0.1, p["tex_extra"].shape).astype(np.float32)
    p["lights"] = p["lights"] + rng.normal(0, 0.3, (9, 3)).astype(np.float32)
    p["static_offset"] = rng.normal(0, 2e-3, p["static_offset"].shape).astype(np.float32)
    ds = NeRSembleDataset(_data_cfg(TConfig, root), img_to_tensor=True)
    item = ds.getitem_by_timestep(1)
    batch = {"rgb": item["rgb"].astype(np.float32),
             "lmk2d": item["lmk2d"].astype(np.float32),
             "intrinsic": item["intrinsic"].astype(np.float32),
             "extrinsic": item["extrinsic"].astype(np.float32),
             "timestep_index": np.full(N_CAMS, 1, np.int32),
             "weight": np.ones(N_CAMS, np.float32)}
    return jh, th, p, batch


def _energies(calibrated, root, stage):
    from vhap_tpu.model.flame import FlameTexPainted as JTex
    from vhap_tpu.tracker import energy as JE
    from vhap_tpu_torch.model.flame import FlameTexPainted as TTex
    from vhap_tpu_torch.tracker import energy as TE
    jh, th, _, _ = calibrated
    jc, tc = _energy_config(JConfig, root), _energy_config(TConfig, root)
    tex = jh.assets.tex_painted
    jen = JE.make_energy_fn(jh, jc, JE.make_albedo_fn(jc, JTex(tex, R), None),
                            (S, S), N_T, stage, with_aux=stage is None)
    ten = TE.make_energy_fn(th, tc, TE.make_albedo_fn(tc, TTex(tex, R, device="cpu"), None),
                            (S, S), N_T, stage, with_aux=stage is None, device="cpu")
    return jc, tc, jen, ten


def test_calibrated_eval_energy_matches_jax(rig, calibrated):
    _, _, p, batch = calibrated
    _, _, jen, ten = _energies(calibrated, rig[0], None)
    jE, (jlog, jaux) = jax.jit(jen)({k: jnp.asarray(v) for k, v in p.items()},
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.PRNGKey(0))
    tE, (tlog, taux) = ten({k: torch.as_tensor(v) for k, v in p.items()},
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(tlog) >= {"lmk", "photo", "total"} and set(tlog) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=1e-4, err_msg=k)
    assert float((taux["pred_alpha"] > 0).float().mean()) > 0.02
    np.testing.assert_allclose(taux["pred_lmk2d"].numpy(), np.asarray(jaux["pred_lmk2d"]),
                               rtol=0, atol=1e-5)


def test_calibrated_train_step_matches_jax(rig, calibrated):
    """rgb_sequential_tracking on the 4 views of timestep 1, disturbance
    rates None: every term within 1e-4 relative, each optimizable leaf's
    gradient within 1e-3 * max|g| of eager jax.value_and_grad; the
    per-timestep leaves' gradient lands on timestep 1 alone, summed over
    the views (4 gathers of one row)."""
    from vhap_tpu.tracker import optim as JO
    from vhap_tpu_torch.tracker import optim as TO
    stage = "rgb_sequential_tracking"
    _, _, p, batch = calibrated
    jc, tc, jen, ten = _energies(calibrated, rig[0], stage)
    leaves = JO.stage_optimizable_leaves(jc, stage, p)
    assert leaves == TO.stage_optimizable_leaves(tc, stage, p)
    assert "focal_length" not in leaves
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    frozen = {k: jnp.asarray(v) for k, v in p.items() if k not in leaves}

    def loss(op):
        E, (log, _) = jen({**frozen, **op}, jb, jax.random.PRNGKey(0))
        return E, log

    (jE, jlog), jg = jax.value_and_grad(loss, has_aux=True)(
        {k: jnp.asarray(p[k]) for k in leaves})
    tE, tlog, tg = TO.loss_and_grads(
        ten, {k: torch.as_tensor(v) for k, v in p.items()}, leaves,
        {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    assert set(tlog) == set(jlog) and {"photo", "lmk"} <= set(tlog)
    for k in jlog:
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    for k in leaves:
        ref = np.asarray(jg[k])
        got = tg[k].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, k
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * scale, err_msg=k)
    g = tg["expr"].numpy()
    assert np.abs(g[[0, 2]]).max() == 0 and np.abs(g[1]).max() > 0


# ---------------------------------------------------------------------------
# the tracker loop, landmark-only
# ---------------------------------------------------------------------------

def _tracker_cfg(cls, root, out):
    """tests/test_multiview.py::test_multiview_tracker_loop's config."""
    cfg = cls()
    cfg.data = _data_cfg(cls, root, align_cameras_to_axes=False)
    cfg.model.n_shape, cfg.model.n_expr = NS, NE
    cfg.model.asset_dir = Path(root) / "assets"
    cfg.model.use_static_offset = False
    cfg.model.tex_extra = False
    cfg.exp.photometric = False
    cfg.exp.output_folder = Path(out)
    cfg.w.photo = None
    cfg.pipeline.lmk_init_rigid.num_steps = 120
    cfg.pipeline.lmk_init_all.num_steps = 120
    cfg.pipeline.lmk_sequential_tracking.num_steps = 20
    cfg.pipeline.lmk_global_tracking.num_epochs = 1
    cfg.log.interval_scalar = 10 ** 6
    cfg.log.interval_media = 10 ** 6
    cfg.__post_init__()
    return cfg


@pytest.fixture(scope="module")
def mv_runs(rig, tmp_path_factory):
    from vhap_tpu.tracker.tracker import GlobalTracker as JTracker
    from vhap_tpu_torch.tracker.tracker import GlobalTracker as TTracker
    root = rig[0]
    out = tmp_path_factory.mktemp("mvout")
    jt = JTracker(_tracker_cfg(JConfig, root, out / "jax"))
    jt.optimize()
    tt = TTracker(_tracker_cfg(TConfig, root, out / "port"), device="cpu")
    assert tt.batchify_all_views and tt.n_timesteps == N_T
    assert tt.head.num_verts == jt.head.num_verts == 3192     # the teeth head
    tt.optimize()
    return jt, tt


@pytest.mark.parametrize("stage", ["lmk_init_rigid", "lmk_init_all",
                                   "lmk_sequential_tracking"])
def test_multiview_steps_match_jax(mv_runs, stage):
    """Each landmark stage's step, JAX's and the port's, 40 steps side by
    side from the same parameters on timestep 0's 4 views: parameters
    within 1e-5, the energy within 1e-4 relative (the terms' gate: it sums
    L1 residuals of ~1e-2 between coordinates of ~1, whose float32
    rounding moves it ~5e-6 relative at equal parameters)."""
    jt, tt = mv_runs
    start = {k: v.numpy().copy() for k, v in tt.params.items()}
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.as_tensor(v) for k, v in start.items()}
    jb, tb = jt._make_batch([0]), tt._make_batch([0])
    assert tb["rgb"].shape[0] == N_CAMS and tb["intrinsic"].shape == (N_CAMS, 3, 3)
    (j_init, j_step), (t_init, t_step) = jt._get_step(stage, 1.0), tt._get_step(stage, 1.0)
    js, ts = j_init(jp), t_init(tp)
    for _ in range(40):
        jp, js, jE, _ = j_step(jp, js, jb, jt._next_key(), jnp.asarray(1.0))
        tp, ts, tE, _ = t_step(tp, ts, tb, tt.generator, 1.0)
    np.testing.assert_allclose(float(tE), float(jE), rtol=1e-4)
    for k in start:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_multiview_fit_recovers_ground_truth(rig, mv_runs, side):
    """tests/test_multiview.py's bounds: mean |d translation| < 0.02, mean
    |d rotation| < 0.08, and no focal length (calibrated cameras)."""
    _, gt, _ = rig
    tr = mv_runs[0 if side == "jax" else 1]
    z = np.load(sorted(Path(tr.out_dir).glob("tracked_flame_params_*.npz"))[-1])
    assert np.abs(z["translation"] - gt["translation"]).mean() < 0.02
    assert np.abs(z["rotation"] - gt["rotation"]).mean() < 0.08
    assert "focal_length" not in z.files
    if side == "port":
        assert tr.steps_by_stage == {"lmk_init_rigid": 120, "lmk_init_all": 120,
                                     "lmk_sequential_tracking": 20 * N_T,
                                     "lmk_global_tracking": N_T}


def test_track_nersemble_v2_cli_on_cpu(rig, tmp_path):
    """python -m vhap_tpu_torch.track_nersemble_v2 ... --device cpu."""
    from vhap_tpu_torch import track_nersemble_v2
    root = rig[0]
    info = track_nersemble_v2.main([
        "--data.root_folder", str(root / "v2"), "--data.subject", SUBJECT,
        "--data.sequence", SEQ, "--data.background_color", "None",
        "--model.n_shape", str(NS), "--model.n_expr", str(NE),
        "--model.asset_dir", str(root / "assets"),
        "--model.no-use-static-offset", "--model.no-tex-extra",
        "--exp.no-photometric", "--w.photo", "None",
        "--exp.output_folder", str(tmp_path / "out"),
        "--pipeline.lmk_init_rigid.num_steps", "5",
        "--pipeline.lmk_init_all.num_steps", "5",
        "--pipeline.lmk_sequential_tracking.num_steps", "2",
        "--pipeline.lmk_global_tracking.num_epochs", "1",
        "--log.interval_scalar", "1000000", "--log.interval_media", "1000000",
        "--device", "cpu"])
    assert info["dataset"] == "NeRSembleV2Dataset"
    assert info["color_correction"] and info["batchify_all_views"]
    z = np.load(sorted(Path(info["out_dir"]).glob("tracked_flame_params_*.npz"))[-1])
    assert "focal_length" not in z.files and z["rotation"].shape == (N_T, 3)


def test_track_nersemble_runs_on_the_card_unless_asked(rig, monkeypatch):
    """Without a card both CLIs raise unless --device cpu is given."""
    from vhap_tpu_torch import track_nersemble, track_nersemble_v2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, version in ((track_nersemble.main, "v1"), (track_nersemble_v2.main, "v2")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--data.root_folder", str(rig[0] / version),
                  "--data.subject", SUBJECT, "--data.sequence", SEQ])


def test_multiview_slice_is_the_bench_step_with_teeth_showing(tmp_path):
    """tools/multiview_slice.py (the step chip_smoke.py times, here 2 views
    at 64^2): bench.py's metric-3 configuration (BaseTrackingConfig, so the
    texture is optimized; no focal length), one timestep x all views per
    batch, and the teeth head with its inner lips removed, so that teeth
    faces win pixels in every view."""
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    from vhap_tpu_torch.ops import camera as cam
    from vhap_tpu_torch.ops.rasterize import visibility
    from vhap_tpu_torch.tools.multiview_slice import build_multiview_slice, write_rig
    from vhap_tpu_torch.tracker.energy import fill_cam_params
    write_rig(tmp_path, n_cams=2, n_frames=2, size=64, n_shape=NS, n_expr=NE,
              device="cpu")
    ts = build_multiview_slice(tmp_path, device="cpu", n_shape=NS, n_expr=NE,
                               tex_res=R)
    s = ts.eval
    assert type(s.cfg) is BaseTrackingConfig and s.cfg.data.calibrated
    assert ts.stage == "rgb_sequential_tracking" and "tex_extra" in ts.opt_leaves
    assert "focal_length" not in s.params and s.cfg.batch_size == 2
    assert s.batch["timestep_index"].tolist() == [0, 0]
    H, W = s.image_size
    with torch.no_grad():
        _, (_, aux) = s.make_energy(False)(s.params, s.batch)
        K, RT = fill_cam_params(s.batch, s.params, True, (H, W))
        clip = cam.camera_to_clip(cam.world_to_camera(aux["verts"], RT), K, (H, W))
        tri, _ = visibility(clip, s.head.faces, H, W)
    teeth = torch.zeros(s.head.num_faces + 1, dtype=torch.bool)
    teeth[1 + torch.as_tensor(s.head.masks.f["teeth"])] = True
    assert bool((teeth[tri.long()].sum(dim=(1, 2)) > 0).all())
