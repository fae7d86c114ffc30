"""Video preprocessing: frame extraction + foreground matting.

Counterpart of vhap_tpu/preprocess/video.py (the reference's
vhap/preprocess_video.py without the ffmpeg-python wrapper: a direct
ffmpeg subprocess, OpenCV when there is no ffmpeg), with the
package-gated matting backends loaded lazily:

  * robust_video_matting  - RobustVideoMatting (torch.hub, recurrent, with
    the reference's 10-frame warmup) for monocular video;
  * background_matting_v2 - BackgroundMattingV2 with background plates for
    multiview rigs (its pip package);
  * background_diff       - classical matting against background plates
    (preprocess/matting.py, host numpy);
  * matting_jax           - the bundled synthetic-trained U-Net
    (preprocess/matting.py; no download). The name is the JAX package's
    CLI choice, kept so that both packages' job files agree.

The networks run on the card unless given another device.

    python -m vhap_tpu_torch.preprocess.video --input VIDEO.mp4 \
        --matting_method matting_jax [--device cpu]
"""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
from typing import List, Literal, Optional

import numpy as np
from PIL import Image

from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.preprocess.matting import background_diff_matting, matting_unet
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

MATTING_METHODS = ("robust_video_matting", "background_matting_v2",
                   "background_diff", "matting_jax")


def _ffprobe(video_path: Path) -> dict:
    out = subprocess.run(
        ["ffprobe", "-v", "quiet", "-print_format", "json", "-show_streams",
         str(video_path)], capture_output=True, check=True)
    return json.loads(out.stdout)


def video2frames(video_path: Path, image_dir: Path, keep_video_name: bool = False,
                 target_fps: int = 30, n_downsample: int = 1):
    """Extract jpg frames with fps resample + downscale
    (vhap/preprocess_video.py:14-52). Uses ffmpeg when present, OpenCV
    otherwise."""
    if shutil.which("ffmpeg") is None:
        return _video2frames_cv2(video_path, image_dir, keep_video_name,
                                 target_fps, n_downsample)
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    stem = video_path.stem + "_" if keep_video_name else ""

    probe = _ffprobe(video_path)
    video = next(s for s in probe["streams"] if s["codec_type"] == "video")
    W, H = int(video["width"]), int(video["height"])
    w, h = W // n_downsample, H // n_downsample
    logger.info(f"{video_path} -> {image_dir} at {target_fps} fps, {w}x{h}")

    subprocess.run([
        "ffmpeg", "-y", "-v", "warning", "-i", str(video_path),
        "-vf", f"fps={target_fps},scale={w}:{h}",
        "-start_number", "0", "-qscale:v", "1",
        str(image_dir / f"{stem}%06d.jpg"),
    ], check=True)


def _video2frames_cv2(video_path: Path, image_dir: Path, keep_video_name: bool,
                      target_fps: int, n_downsample: int):
    """OpenCV fallback: fps resample by frame-index selection + downscale."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"cannot extract frames from {video_path}: neither ffmpeg (on PATH) "
            "nor OpenCV (the cv2 module) is available; install one of them") from e
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    stem = video_path.stem + "_" if keep_video_name else ""

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video: {video_path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or target_fps
    W = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    H = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w, h = W // n_downsample, H // n_downsample
    logger.info(f"{video_path} -> {image_dir} via OpenCV at {target_fps} fps, {w}x{h}")

    out_i = 0
    next_t = 0.0
    frame_i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            t = frame_i / src_fps
            if t + 1e-9 >= next_t:
                if (w, h) != (W, H):
                    frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)
                cv2.imwrite(str(image_dir / f"{stem}{out_i:06d}.jpg"), frame,
                            [cv2.IMWRITE_JPEG_QUALITY, 95])
                out_i += 1
                next_t += 1.0 / target_fps
            frame_i += 1
    finally:
        cap.release()
    logger.info(f"extracted {out_i} frames")


def robust_video_matting(image_dir: Path, n_warmup: int = 10, device=None):
    """Recurrent alpha matting without background plates
    (vhap/preprocess_video.py:54-86). Writes alpha_maps/*.jpg next to
    images/. The model comes from torch.hub (network or a filled hub
    cache)."""
    import torch
    device = resolve_device(device)
    try:
        model = torch.hub.load("PeterL1n/RobustVideoMatting", "resnet50")
    except OSError as e:   # no network and no cached copy
        raise RuntimeError(
            "robust_video_matting needs RobustVideoMatting from torch.hub "
            "(PeterL1n/RobustVideoMatting), which could not be fetched; run it "
            "with network access once, or use --matting_method matting_jax") from e
    model = model.to(device).eval()

    image_dir = Path(image_dir)
    alpha_dir = image_dir.parent / "alpha_maps"
    alpha_dir.mkdir(exist_ok=True)
    paths = sorted(image_dir.glob("*.jpg"))
    if not paths:
        raise FileNotFoundError(f"no jpg frames in {image_dir}")

    rec = [None] * 4
    with torch.no_grad():
        # warmup: feed the first frame several times so the recurrent states
        # settle before real output (reference's 10-frame trick)
        first = _load_tensor(paths[0], device)
        downsample_ratio = min(512 / max(first.shape[-2:]), 1.0)
        for _ in range(n_warmup):
            _, _, *rec = model(first, *rec, downsample_ratio)
        for p in paths:
            src = _load_tensor(p, device)
            fgr, pha, *rec = model(src, *rec, downsample_ratio)
            alpha = (pha[0, 0].cpu().numpy() * 255).astype(np.uint8)
            Image.fromarray(alpha).save(alpha_dir / p.name)
    logger.info(f"wrote {len(paths)} alpha maps to {alpha_dir}")


def background_matting_v2(image_dir: Path, background_folder: Path, device=None):
    """Alpha matting with background plates (vhap/preprocess_video.py:88-134).

    Requires the BackgroundMattingV2 package (not bundled); raises a clear
    error when absent.
    """
    try:
        from BackgroundMattingV2.asset import get_weights_path
        from BackgroundMattingV2.model import MattingRefine
    except ImportError as e:
        raise RuntimeError(
            "background_matting_v2 requires the BackgroundMattingV2 package "
            "(pip install from https://github.com/ShenhanQian/BackgroundMattingV2)"
        ) from e
    import torch
    device = resolve_device(device)
    model = MattingRefine(backbone="resnet50", backbone_scale=1 / 4,
                          refine_mode="sampling", refine_sample_pixels=80000)
    model.load_state_dict(torch.load(get_weights_path("pytorch_resnet50"),
                                     map_location=device), strict=False)
    model = model.to(device).eval()

    image_dir = Path(image_dir)
    alpha_dir = image_dir.parent / "alpha_maps"
    alpha_dir.mkdir(exist_ok=True)
    paths = sorted(image_dir.glob("*.jpg"))
    with torch.no_grad():
        for p in paths:
            cam = p.stem.split("_")[0] + "_" + p.stem.split("_")[1] \
                if p.stem.startswith("cam_") else p.stem
            bgr_path = _find_background(Path(background_folder), cam)
            src = _load_tensor(p, device)
            bgr = _load_tensor(bgr_path, device)
            pha = model(src, bgr)[0]
            alpha = (pha[0, 0].cpu().numpy() * 255).astype(np.uint8)
            Image.fromarray(alpha).save(alpha_dir / p.name)
    logger.info(f"wrote {len(paths)} alpha maps to {alpha_dir}")


def _find_background(background_folder: Path, cam: str) -> Path:
    for candidate in (background_folder / f"{cam}.jpg",
                      background_folder / f"{cam}.png"):
        if candidate.exists():
            return candidate
    candidates = sorted(background_folder.glob("*.jpg"))
    if not candidates:
        raise FileNotFoundError(f"no background plates in {background_folder}")
    return candidates[0]


def _load_tensor(path: Path, device):
    import torch
    img = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    return torch.from_numpy(img).permute(2, 0, 1)[None].to(device)


def preprocess(
    input: Path,
    target_fps: int = 25,
    downsample_scales: Optional[List[int]] = None,
    matting_method: Optional[Literal["robust_video_matting",
                                     "background_matting_v2",
                                     "background_diff",
                                     "matting_jax"]] = None,
    background_folder: Path = Path("../../BACKGROUND"),
    device=None,
):
    """Full preprocess entry (vhap/preprocess_video.py:148-192): frames of
    a video (or of a directory's cam_*.mp4) into images/, then the
    matting. The matting networks run on `device` (the card unless given
    another), resolved before any frame is written."""
    if matting_method is not None and matting_method not in MATTING_METHODS:
        raise ValueError(f"Unknown matting method: {matting_method}")
    if matting_method not in (None, "background_diff"):
        device = resolve_device(device)
    input = Path(input)
    downsample_scales = downsample_scales or []
    if not input.exists():
        matched = list(input.parent.glob(input.name))
        if len(matched) == 1:
            input = matched[0]
        else:
            raise FileNotFoundError(f"Cannot resolve input: {input} -> {matched}")

    if input.suffix in (".mov", ".mp4"):
        videos = [input]
        image_dir = input.parent / input.stem / "images"
    elif input.is_dir():
        videos = (list(input.glob("cam_*.mp4"))
                  + list(input.glob("images/cam_*.mp4")))
        image_dir = input / "images"
    else:
        raise ValueError(f"Input must be a video or directory: {input}")
    if not videos:
        raise FileNotFoundError(f"No video files found in {input}")

    for video_path in videos:
        for n_downsample in [1] + list(downsample_scales):
            image_dir_ = (image_dir if n_downsample == 1
                          else Path(str(image_dir) + f"_{n_downsample}"))
            video2frames(video_path, image_dir_, keep_video_name=len(videos) > 1,
                         target_fps=target_fps, n_downsample=n_downsample)

    if matting_method == "robust_video_matting":
        robust_video_matting(image_dir, device=device)
    elif matting_method == "background_matting_v2":
        background_matting_v2(image_dir, background_folder, device=device)
    elif matting_method == "background_diff":
        background_diff_matting(image_dir, background_folder)
    elif matting_method == "matting_jax":
        matting_unet(image_dir, device=device)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", type=Path, required=True)
    ap.add_argument("--target_fps", type=int, default=25)
    ap.add_argument("--downsample_scales", type=int, nargs="*", default=[])
    ap.add_argument("--matting_method", default=None, choices=MATTING_METHODS)
    ap.add_argument("--background_folder", type=Path,
                    default=Path("../../BACKGROUND"))
    ap.add_argument("--device", default=None,
                    help="torch device of the matting networks (default: the CUDA card)")
    args = ap.parse_args(argv)
    preprocess(args.input, args.target_fps, args.downsample_scales,
               args.matting_method, args.background_folder, args.device)


if __name__ == "__main__":
    main()
