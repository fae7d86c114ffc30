"""Port parity for preprocess/landmarks.py and preprocess/video.py, and the
tracker's annotate-on-construction, against the JAX package on the CPU:
annotate_landmarks' npz files, GlobalTracker with landmark_source 'fan-jax'
(its landmark steps side by side), frame extraction (the ffmpeg argv, the
OpenCV fallback), the preprocess entry point with the 'matting_jax' method,
and the package-gated paths, which raise offline (torch.hub.load is
replaced, so no test reaches the network).
"""

import json
import shutil
import subprocess
import sys
import urllib.error
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

SEQ = "seq"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A 2-frame 64^2 sequence from the port's generator, its landmark
    file removed."""
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    root = tmp_path_factory.mktemp("frames")
    generate(root / SEQ, n_frames=2, size=64, n_shape=10, n_expr=5, device="cpu")
    (root / SEQ / "landmark2d" / "STAR.npz").unlink()
    return root / SEQ


def copy_seq(frames, root):
    shutil.copytree(frames, root / SEQ)
    return root


def data_cfg(cls, root):
    cfg = cls().data
    cfg.root_folder, cfg.sequence = Path(root), SEQ
    cfg.use_landmark = False
    return cfg


def assert_same_npz(got, ref):
    with np.load(got) as g, np.load(ref) as r:
        assert sorted(g.files) == sorted(r.files) == ["bounding_box", "face_landmark_2d"]
        for k in r.files:
            assert g[k].shape == r[k].shape and g[k].dtype == r[k].dtype
        np.testing.assert_array_equal(g["bounding_box"], r["bounding_box"])
        np.testing.assert_array_equal(g["face_landmark_2d"][..., :2],
                                      r["face_landmark_2d"][..., :2])
        np.testing.assert_allclose(g["face_landmark_2d"][..., 2],
                                   r["face_landmark_2d"][..., 2], rtol=0, atol=1e-5)


def test_annotate_landmarks_matches_jax(frames, tmp_path):
    """The bundled FAN through each package's annotate_landmarks: the same
    npz, at the same path (landmark2d/fan-jax.npz)."""
    from vhap_tpu.config.base import BaseTrackingConfig as JConfig
    from vhap_tpu.data.video_dataset import VideoDataset as JData
    from vhap_tpu.preprocess.landmarks import annotate_landmarks as jannotate
    from vhap_tpu_torch.config.base import BaseTrackingConfig as TConfig
    from vhap_tpu_torch.data.video_dataset import VideoDataset as TData
    from vhap_tpu_torch.preprocess.landmarks import annotate_landmarks as tannotate
    jroot, troot = copy_seq(frames, tmp_path / "jax"), copy_seq(frames, tmp_path / "port")
    jannotate(JData(data_cfg(JConfig, jroot)), source="fan-jax")
    tannotate(TData(data_cfg(TConfig, troot)), source="fan-jax", device="cpu")
    out = Path(SEQ) / "landmark2d" / "fan-jax.npz"
    assert_same_npz(troot / out, jroot / out)
    with np.load(troot / out) as z:
        assert z["face_landmark_2d"].shape == (2, 70, 3)


class FakeDetector:
    """Deterministic stand-in: landmarks on a grid, no face on the second
    frame (known by its pixels, so that the annotator's threads may call in
    any order)."""

    def __init__(self, no_face, frames):
        self.no_face = no_face
        self.no_face_img = np.array(Image.open(sorted((frames / "images").glob("*.jpg"))[1]))

    def detect_single_image(self, img):
        if np.array_equal(img, self.no_face_img):
            return self.no_face
        xy = np.stack([np.linspace(0.2, 0.8, 68), np.linspace(0.3, 0.7, 68)], -1)
        lmks = np.concatenate([xy, np.ones((68, 1))], -1).astype(np.float32)
        return np.asarray([0.2, 0.3, 0.8, 0.7, 1.0], np.float32), lmks


def test_annotate_with_a_given_detector_matches_jax(frames, tmp_path):
    """Any detector object, and the no-face sentinel rows, into the 'star'
    source's file (landmark2d/STAR.npz), read back with zero confidence."""
    from vhap_tpu.config.base import BaseTrackingConfig as JConfig
    from vhap_tpu.data.video_dataset import VideoDataset as JData
    from vhap_tpu.preprocess import landmarks as jl
    from vhap_tpu_torch.config.base import BaseTrackingConfig as TConfig
    from vhap_tpu_torch.data.video_dataset import VideoDataset as TData
    from vhap_tpu_torch.preprocess import landmarks as tl
    np.testing.assert_array_equal(tl.NO_FACE_BBOX, jl.NO_FACE_BBOX)
    np.testing.assert_array_equal(tl.NO_FACE_LMKS, jl.NO_FACE_LMKS)
    assert tl.SOURCE_DIRS == jl.SOURCE_DIRS and set(tl._DETECTORS) == set(jl._DETECTORS)
    jroot, troot = copy_seq(frames, tmp_path / "jax"), copy_seq(frames, tmp_path / "port")
    jl.annotate_landmarks(JData(data_cfg(JConfig, jroot)), source="star",
                          detector=FakeDetector((jl.NO_FACE_BBOX, jl.NO_FACE_LMKS), frames))
    tl.annotate_landmarks(TData(data_cfg(TConfig, troot)), source="star", n_jobs=2,
                          detector=FakeDetector((tl.NO_FACE_BBOX, tl.NO_FACE_LMKS), frames))
    out = Path(SEQ) / "landmark2d" / "STAR.npz"
    assert_same_npz(troot / out, jroot / out)
    cfg = data_cfg(TConfig, troot)
    cfg.use_landmark = True
    ds = TData(cfg, img_to_tensor=True)
    assert ds[0]["lmk2d"][:, 2].min() == 1.0 and ds[1]["lmk2d"][:, 2].max() == 0.0


def tracker_cfg(cls, root):
    """tests/test_landmark_annotation.py's fan-jax configuration."""
    cfg = cls()
    cfg.data.root_folder = Path(root)
    cfg.data.sequence = SEQ
    cfg.data.landmark_source = "fan-jax"
    cfg.data.landmark_detector_njobs = 1
    cfg.data.background_color = None
    cfg.model.n_shape, cfg.model.n_expr = 10, 5
    cfg.model.add_teeth = False
    cfg.model.use_static_offset = False
    cfg.model.tex_extra = False
    cfg.exp.photometric = False
    cfg.exp.output_folder = Path(root) / "out"
    cfg.w.photo = None
    cfg.batch_size = 2
    cfg.pipeline.lmk_init_rigid.num_steps = 3
    cfg.log.interval_scalar = 10 ** 6
    cfg.log.interval_media = 10 ** 6
    cfg.__post_init__()
    return cfg


def test_tracker_annotates_on_construction(frames, tmp_path):
    """GlobalTracker with data.landmark_source='fan-jax' detects the
    missing landmarks on construction, as the JAX tracker does, into the
    same file; the lmk_init_rigid steps of both, from the same parameters
    on their own batches, agree side by side."""
    import jax.numpy as jnp
    from vhap_tpu.config.base import BaseTrackingConfig as JConfig
    from vhap_tpu.tracker.tracker import GlobalTracker as JTracker
    from vhap_tpu_torch.config.base import BaseTrackingConfig as TConfig
    from vhap_tpu_torch.tracker.tracker import GlobalTracker as TTracker
    jroot, troot = copy_seq(frames, tmp_path / "jax"), copy_seq(frames, tmp_path / "port")
    jt = JTracker(tracker_cfg(JConfig, jroot))
    tt = TTracker(tracker_cfg(TConfig, troot), device="cpu")
    out = Path(SEQ) / "landmark2d" / "fan-jax.npz"
    assert_same_npz(troot / out, jroot / out)

    start = {k: v.numpy().copy() for k, v in tt.params.items()}
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.as_tensor(v) for k, v in start.items()}
    jb, tb = jt._make_batch([0, 1]), tt._make_batch([0, 1])
    assert tb["lmk2d"].shape[1:] == (70, 3)
    np.testing.assert_allclose(tb["lmk2d"].numpy(), np.asarray(jb["lmk2d"])[:2],
                               rtol=0, atol=1e-5)
    (j_init, j_step), (t_init, t_step) = (jt._get_step("lmk_init_rigid", 1.0),
                                          tt._get_step("lmk_init_rigid", 1.0))
    js, ts = j_init(jp), t_init(tp)
    for _ in range(3):
        jp, js, jE, _ = j_step(jp, js, jb, jt._next_key(), jnp.asarray(1.0))
        tp, ts, tE, _ = t_step(tp, ts, tb, tt.generator, 1.0)
    np.testing.assert_allclose(float(tE), float(jE), rtol=1e-5)
    for k in start:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert np.isfinite(tp["rotation"].numpy()).all()
    assert not np.allclose(tp["rotation"].numpy(), start["rotation"])


def test_tracker_reuses_landmarks(frames, tmp_path, monkeypatch):
    """exp.reuse_landmarks with the file on disk: no detection."""
    from vhap_tpu_torch.config.base import BaseTrackingConfig as TConfig
    from vhap_tpu_torch.data.video_dataset import VideoDataset
    from vhap_tpu_torch.preprocess import landmarks
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    root = copy_seq(frames, tmp_path)
    landmarks.annotate_landmarks(
        VideoDataset(data_cfg(TConfig, root)), source="fan-jax",
        detector=FakeDetector((landmarks.NO_FACE_BBOX, landmarks.NO_FACE_LMKS), frames))
    monkeypatch.setattr(landmarks, "annotate_landmarks",
                        lambda *a, **k: pytest.fail("detected again"))
    tr = GlobalTracker(tracker_cfg(TConfig, root), device="cpu")
    assert tr._make_batch([0, 1])["lmk2d"][1, :, 2].max() == 0.0


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------

def test_video2frames_ffmpeg_argv_matches_jax(tmp_path, monkeypatch):
    from vhap_tpu.preprocess import video as jvideo
    from vhap_tpu_torch.preprocess import video as tvideo
    calls = []

    def fake_run(argv, **kw):
        calls.append(list(argv))
        stdout = json.dumps({"streams": [{"codec_type": "audio"},
                                         {"codec_type": "video", "width": 1920,
                                          "height": 1080}]}).encode()
        return subprocess.CompletedProcess(argv, 0, stdout=stdout)
    monkeypatch.setattr(shutil, "which", lambda name: f"/usr/bin/{name}")
    monkeypatch.setattr(subprocess, "run", fake_run)
    for mod in (jvideo, tvideo):
        mod.video2frames(tmp_path / "clip.mp4", tmp_path / "images",
                         keep_video_name=True, target_fps=25, n_downsample=2)
    assert len(calls) == 4 and calls[:2] == calls[2:]
    assert calls[1][:5] == ["ffmpeg", "-y", "-v", "warning", "-i"]
    assert "fps=25,scale=960:540" in calls[1]


def write_video(path, images, fps=25):
    import cv2
    first = np.asarray(Image.open(images[0]))
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (first.shape[1], first.shape[0]))
    for f in images:
        writer.write(np.asarray(Image.open(f))[..., ::-1])
    writer.release()


def test_opencv_fallback_matches_jax(frames, tmp_path, monkeypatch):
    """Without ffmpeg both packages extract the same JPEGs with OpenCV
    (fps resampled, downscaled); with neither, the port says what is
    missing."""
    pytest.importorskip("cv2")
    from vhap_tpu.preprocess import video as jvideo
    from vhap_tpu_torch.preprocess import video as tvideo
    images = sorted((frames / "images").glob("*.jpg"))
    write_video(tmp_path / "clip.mp4", images * 2)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for side, mod in (("jax", jvideo), ("port", tvideo)):
        mod.video2frames(tmp_path / "clip.mp4", tmp_path / side, target_fps=12,
                         n_downsample=2)
    got = {p.name: p.read_bytes() for p in sorted((tmp_path / "port").iterdir())}
    ref = {p.name: p.read_bytes() for p in sorted((tmp_path / "jax").iterdir())}
    assert list(got) == ["000000.jpg", "000001.jpg"] and got == ref
    assert Image.open(tmp_path / "port" / "000000.jpg").size == (32, 32)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="neither ffmpeg .* nor OpenCV"):
        tvideo.video2frames(tmp_path / "clip.mp4", tmp_path / "none")


def test_preprocess_cli_matches_jax(frames, tmp_path, monkeypatch):
    """`python -m vhap_tpu_torch.preprocess.video --input clip.mp4
    --matting_method matting_jax --device cpu` against JAX's preprocess:
    the same frames, alpha maps within one JPEG level."""
    pytest.importorskip("cv2")
    from vhap_tpu.preprocess import video as jvideo
    from vhap_tpu_torch.preprocess import video as tvideo
    monkeypatch.setattr(shutil, "which", lambda name: None)
    images = sorted((frames / "images").glob("*.jpg"))
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        write_video(tmp_path / side / "clip.mp4", images)
    jvideo.preprocess(tmp_path / "jax" / "clip.mp4", matting_method="matting_jax")
    tvideo.main(["--input", str(tmp_path / "port" / "clip.mp4"),
                 "--matting_method", "matting_jax", "--device", "cpu"])
    for sub in ("images", "alpha_maps"):
        got = sorted((tmp_path / "port" / "clip" / sub).glob("*.jpg"))
        ref = sorted((tmp_path / "jax" / "clip" / sub).glob("*.jpg"))
        assert [p.name for p in got] == [p.name for p in ref] == ["000000.jpg", "000001.jpg"]
        for a, b in zip(got, ref):
            a, b = (np.asarray(Image.open(p), np.int32) for p in (a, b))
            assert np.abs(a - b).max() <= (0 if sub == "images" else 1)
    with pytest.raises(ValueError, match="Unknown matting method"):
        tvideo.preprocess(tmp_path / "port" / "clip.mp4", matting_method="rvm")


def test_gated_paths_raise_offline(tmp_path, monkeypatch):
    """The backends that need a package or a download raise a clear
    RuntimeError without them, in both packages where both have them."""
    from vhap_tpu.preprocess import landmarks as jl
    from vhap_tpu_torch.preprocess import landmarks as tl
    from vhap_tpu_torch.preprocess import video as tvideo

    def offline(*args, **kw):
        raise urllib.error.URLError("no network")
    monkeypatch.setattr(torch.hub, "load", offline)
    (tmp_path / "images").mkdir()
    with pytest.raises(RuntimeError, match="RobustVideoMatting"):
        tvideo.robust_video_matting(tmp_path / "images", device="cpu")
    with pytest.raises(RuntimeError, match="BackgroundMattingV2"):
        tvideo.background_matting_v2(tmp_path / "images", tmp_path, device="cpu")
    for mod in (jl, tl):
        with pytest.raises(RuntimeError, match="face.alignment"):
            mod.LandmarkDetectorFA()
        with pytest.raises(RuntimeError, match="dlib"):
            mod.LandmarkDetectorSTAR()
    with pytest.raises(RuntimeError, match="No STAR weights"):
        tl.LandmarkDetectorSTARNet(device="cpu")
