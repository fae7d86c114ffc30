"""2D facial landmark annotation with pluggable detector backends.

Counterpart of vhap_tpu/preprocess/landmarks.py (the reference's
vhap/util/landmark_detector_{star,fa}.py behind one annotator). The npz
contract is the reference's (read at vhap/data/video_dataset.py:223-238):

    landmark2d/<source>/<camera_id>.npz   (or landmark2d/<source>.npz mono)
      face_landmark_2d: (T, L, 3) float32 - x, y normalized to [0, 1] + conf
      bounding_box:     (T, 5) float32    - x1, y1, x2, y2, score, normalized
    rows of -1 mean "no face found" (zero confidence downstream).

Backends, by landmark source:
  * 'star'           - dlib bbox + STAR alignment (the STAR and dlib
                       packages, as in the reference);
  * 'face-alignment' - the face_alignment package's 2.5D FAN;
  * 'fan-jax'        - the in-repo FAN (preprocess/fan.py) with the bundled
                       synthetic-trained weights or converted ones;
  * 'star-jax'       - the in-repo STAR net (preprocess/star.py) with
                       converted weights.
The source keys and their folders are shared with the JAX package, whose
datasets and job files name them. The package-gated backends raise a clear
RuntimeError when their package is absent; any object with
`detect_single_image(img) -> (bbox, lmks)` can be passed directly. The
in-repo networks run on the card unless given another device, in full
float32 and without autograd; the annotator's threads share one module and
run its forwards one at a time (the host crops and decodes overlap).
"""

from __future__ import annotations

import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vhap_tpu_torch.data.video_dataset import SOURCE_DIRS
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.preprocess import fan, star
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

NO_FACE_BBOX = np.zeros(5, np.float32) - 1
NO_FACE_LMKS = np.zeros([68, 3], np.float32) - 1

ASSETS = Path(__file__).resolve().parents[1] / "assets"


class LandmarkDetectorSTAR:
    """dlib 68-pt init + STAR alignment (vhap/util/landmark_detector_star.py:221-273)."""

    def __init__(self, model_path: Optional[str] = None,
                 predictor_path: Optional[str] = None, device=None):
        try:
            import dlib
            from STAR.lib import api as star_api
        except ImportError as e:
            raise RuntimeError(
                "LandmarkDetectorSTAR requires the 'dlib' and 'STAR' packages "
                "(see github.com/ShenhanQian/STAR). Install them or use "
                "landmark_source='fan-jax'.") from e
        dev = resolve_device(device)
        self.detector = dlib.get_frontal_face_detector()
        self.shape_predictor = dlib.shape_predictor(predictor_path)
        import argparse
        args = argparse.Namespace()
        args.config_name = "alignment"
        self.alignment = star_api.Alignment(
            args, model_path, dl_framework="pytorch",
            device_ids=[dev.index or 0] if dev.type == "cuda" else [-1])

    def detect_single_image(self, img: np.ndarray):
        bbox = self.detector(img, 1)
        if len(bbox) == 0:
            return NO_FACE_BBOX.copy(), NO_FACE_LMKS.copy()
        face = self.shape_predictor(img, bbox[0])
        shape = np.array([(face.part(i).x, face.part(i).y) for i in range(68)])
        x1, x2 = shape[:, 0].min(), shape[:, 0].max()
        y1, y2 = shape[:, 1].min(), shape[:, 1].max()
        scale = min(x2 - x1, y2 - y1) / 200 * 1.05
        center_w, center_h = (x2 + x1) / 2, (y2 + y1) / 2
        lmks = self.alignment.analyze(img, float(scale), float(center_w),
                                      float(center_h))
        h, w = img.shape[:2]
        lmks = np.concatenate([lmks, np.ones([lmks.shape[0], 1])], 1).astype(np.float32)
        lmks[:, 0] /= w
        lmks[:, 1] /= h
        bb = np.array([bbox[0].left(), bbox[0].top(), bbox[0].right(),
                       bbox[0].bottom(), 1.0], np.float32)
        bb[[0, 2]] /= w
        bb[[1, 3]] /= h
        return bb, lmks


class LandmarkDetectorFA:
    """face_alignment 2.5D FAN (vhap/util/landmark_detector_fa.py:25-74)."""

    def __init__(self, device=None):
        try:
            import face_alignment
        except ImportError as e:
            raise RuntimeError(
                "LandmarkDetectorFA requires the 'face-alignment' package "
                "(pip install face-alignment).") from e
        self.fa = face_alignment.FaceAlignment(
            face_alignment.LandmarksType.TWO_HALF_D, face_detector="sfd",
            flip_input=True, device=str(resolve_device(device)))

    def detect_single_image(self, img: np.ndarray):
        h, w = img.shape[:2]
        preds = self.fa.get_landmarks_from_image(img, return_bboxes=True)
        lmks_all, _, bboxes = preds if isinstance(preds, tuple) else (preds, None, None)
        if not lmks_all:
            return NO_FACE_BBOX.copy(), NO_FACE_LMKS.copy()
        # highest-confidence box (landmark_detector_fa.py:60-64)
        scores = [b[-1] for b in bboxes] if bboxes is not None else [0]
        i = int(np.argmax(scores))
        lmks = np.asarray(lmks_all[i], np.float32)[:, :2]
        lmks = np.concatenate([lmks, np.ones([lmks.shape[0], 1], np.float32)], 1)
        lmks[:, 0] /= w
        lmks[:, 1] /= h
        if bboxes is not None:
            bb = np.asarray(bboxes[i][:4], np.float32)
            bb = np.concatenate([bb, [1.0]]).astype(np.float32)
            bb[[0, 2]] /= w
            bb[[1, 3]] /= h
        else:
            bb = NO_FACE_BBOX.copy()
        return bb, lmks


def _normalized(bb: np.ndarray, lmks: np.ndarray, hm: np.ndarray, w: int, h: int):
    """Image-space box and landmarks + per-landmark confidence (the
    heatmap peak, clipped to [0, 1]) -> the npz contract's normalized rows."""
    conf = hm.max(axis=(1, 2)).clip(0.0, 1.0)[:, None].astype(np.float32)
    lmks = np.concatenate([lmks, conf], axis=1).astype(np.float32)
    lmks[:, 0] /= w
    lmks[:, 1] /= h
    bb = bb.astype(np.float32)
    bb[[0, 2]] /= w
    bb[[1, 3]] /= h
    return bb, lmks


def _no_face(n_landmarks: int):
    return NO_FACE_BBOX.copy(), np.zeros([n_landmarks, 3], np.float32) - 1


class LandmarkDetectorFANNet:
    """The in-repo FAN (preprocess/fan.py), counterpart of the JAX
    package's LandmarkDetectorFANJax.

    Runs the stacked-hourglass network of the reference's face_alignment
    path (vhap/util/landmark_detector_fa.py:25-74) with the bundled
    synthetic-trained weights or a converted official checkpoint
    (fan.convert_torch_checkpoint). The sfd face detector is replaced by a
    whole-image FAN pass whose heatmap extent seeds the refined crop.
    """

    def __init__(self, params_path: Optional[str] = None, params=None, device=None):
        self.device = resolve_device(device)
        if params is None:
            params_path = Path(params_path) if params_path is not None \
                else ASSETS / "fan_weights.npz"
            if not params_path.exists():
                raise RuntimeError(
                    f"No FAN weights at {params_path}. Convert an official "
                    "face_alignment checkpoint with vhap_tpu_torch.preprocess.fan."
                    "convert_torch_checkpoint (then save_fan_params); the bundled "
                    "weights are vhap_tpu_torch/assets/fan_weights.npz")
            params = fan.load_fan_params(str(params_path))
        self.params = params
        self.net = fan.FAN.from_params(params, self.device)

    def heatmaps(self, crops: np.ndarray) -> np.ndarray:
        """crops (N, H, W, 3) float32 [0, 1] -> the last module's heatmaps
        (N, L, H/4, W/4)."""
        x = torch.from_numpy(np.ascontiguousarray(crops, np.float32)).to(self.device)
        with torch.no_grad(), fan.full_float32():
            return self.net(x.permute(0, 3, 1, 2))[-1].cpu().numpy()

    def detect_single_image(self, img: np.ndarray):
        h, w = img.shape[:2]
        # pass 1: whole-image scan substitutes for the sfd bbox detector
        center0 = np.array([w / 2.0, h / 2.0])
        scale0 = max(h, w) / 195.0
        hm0 = self.heatmaps(fan.crop_for_fan(img, center0, scale0)[None])[0]
        bb = fan.coarse_bbox_from_heatmaps(hm0, img.shape)
        if bb is None:
            return _no_face(hm0.shape[0])
        # pass 2: refined crop around the detection
        center, scale = fan.bbox_to_center_scale(bb)
        hm = self.heatmaps(fan.crop_for_fan(img, center, scale)[None])[0]
        return _normalized(bb, fan.heatmaps_to_landmarks(hm, center, scale), hm, w, h)


class LandmarkDetectorSTARNet:
    """The in-repo STAR net (preprocess/star.py), counterpart of the JAX
    package's LandmarkDetectorSTARJax.

    Runs the StackedHGNetV1 alignment network the reference uses by
    default (vhap/util/landmark_detector_star.py:221-273) without dlib:
    weights come from a converted STAR checkpoint
    (star.convert_torch_checkpoint); the dlib box is replaced by the same
    whole-image self-scan as the FAN detector's."""

    def __init__(self, params_path: Optional[str] = None, params=None, device=None):
        self.device = resolve_device(device)
        if params is None:
            params_path = Path(params_path) if params_path is not None \
                else ASSETS / "star_weights.npz"
            if not params_path.exists():
                raise RuntimeError(
                    f"No STAR weights at {params_path}. Convert an official "
                    "STAR checkpoint with vhap_tpu_torch.preprocess.star."
                    "convert_torch_checkpoint (then save_star_params), or "
                    "use the zero-download 'fan-jax' backend.")
            params = star.load_star_params(str(params_path))
        self.params = params
        self.net = star.STAR.from_params(params, self.device)

    def infer(self, crops: np.ndarray):
        """crops (N, H, W, 3) float32 [0, 1] -> (the last stack's heatmaps
        (N, L, H/4, W/4), landmarks (N, L, 2) in [-1, 1])."""
        x = torch.from_numpy(np.ascontiguousarray(crops, np.float32)).to(self.device)
        with torch.no_grad(), fan.full_float32():
            hms, lmks = self.net(x.permute(0, 3, 1, 2))
            return hms[-1].cpu().numpy(), lmks.cpu().numpy()

    def detect_single_image(self, img: np.ndarray):
        h, w = img.shape[:2]
        # pass 1: whole-image scan substitutes for the dlib detector
        center0 = np.array([w / 2.0, h / 2.0])
        scale0 = max(h, w) / 200.0
        hm0, lmks0 = self.infer(star.crop_for_star(img, center0, scale0)[None])
        if float(hm0.max()) < 0.1:
            return _no_face(hm0.shape[1])
        pts0 = star.landmarks_to_image(lmks0[0], center0, scale0)
        x1, y1 = pts0.min(axis=0)
        x2, y2 = pts0.max(axis=0)
        pw, ph = (x2 - x1) * 0.15, (y2 - y1) * 0.15
        bb = np.array([max(0, x1 - pw), max(0, y1 - ph),
                       min(w, x2 + pw), min(h, y2 + ph), 1.0], np.float32)
        # pass 2: refined crop with the reference wrapper's scale convention
        center, scale = star.bbox_to_center_scale(bb)
        hm, lmks_crop = self.infer(star.crop_for_star(img, center, scale)[None])
        lmks = star.landmarks_to_image(lmks_crop[0], center, scale)
        return _normalized(bb, lmks, hm[0], w, h)


_DETECTORS = {"star": LandmarkDetectorSTAR, "face-alignment": LandmarkDetectorFA,
              "fan-jax": LandmarkDetectorFANNet, "star-jax": LandmarkDetectorSTARNet}


def annotate_landmarks(dataset, source: str = "star", n_jobs: int = 1,
                       detector=None, device=None):
    """Detect landmarks for every (camera, timestep) of a dataset and write
    the per-camera npz files (vhap/util/landmark_detector_star.py:348-390).

    `dataset` is any VideoDataset-like object with `.items` and
    `get_property_path`; raw images are loaded directly, without the
    dataset's transforms. The detector of `source` is built on `device`
    (the card unless given another) unless one is passed; `n_jobs` threads
    load, crop and decode frames around it.
    """
    os.umask(0o002)
    if detector is None:
        detector = _DETECTORS[source](device=device)
    prop = SOURCE_DIRS[source]

    from PIL import Image

    landmarks = defaultdict(dict)
    bboxes = defaultdict(dict)

    def work(i):
        item = dataset.items[i]
        img = np.array(Image.open(dataset.get_property_path("rgb", i)))
        bbox, lmks = detector.detect_single_image(img)
        return item["camera_id"], item["timestep_id"], bbox, lmks

    if n_jobs > 1:
        with ThreadPoolExecutor(n_jobs) as ex:
            results = list(ex.map(work, range(len(dataset.items))))
    else:
        results = [work(i) for i in range(len(dataset.items))]

    for camera_id, timestep_id, bbox, lmks in results:
        landmarks[camera_id][timestep_id] = lmks
        bboxes[camera_id][timestep_id] = bbox

    for camera_id, lmk_face_camera in landmarks.items():
        ts_sorted = sorted(lmk_face_camera.keys())
        lmk_dict = {
            "bounding_box": np.stack([bboxes[camera_id][t] for t in ts_sorted]),
            "face_landmark_2d": np.stack([lmk_face_camera[t] for t in ts_sorted]),
        }
        out_path = dataset.get_property_path(prop, camera_id=camera_id)
        logger.info(f"Saving landmarks to: {out_path}")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, **lmk_dict)
