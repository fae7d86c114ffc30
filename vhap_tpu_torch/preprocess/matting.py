"""Foreground alpha matting backends that run without external downloads.

Counterpart of vhap_tpu/preprocess/matting.py, with the same output
contract as the reference's matting (alpha_maps/<frame>.jpg next to
images/, vhap/preprocess_video.py:54-134):

  * background_diff_matting: classical matting for a calibrated rig with
    background plates: colour distance against the plate, a hysteresis
    ramp and a guided-filter refinement (He et al. 2010). Host numpy, as
    in the JAX package.
  * UNet / MattingUNet / matting_unet: the small encoder-decoder the JAX
    package trained on synthetic FLAME renders (bundled as
    assets/matting_weights.npz, the JAX package's file), as an nn.Module
    on cuDNN convolutions: the monocular path with no plates and no
    downloads (`--matting_method matting_jax` of the preprocess CLI).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vhap_tpu_torch.convert import unet_params_to_torch
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.preprocess.fan import (_init_conv, avg_pool2, conv, full_float32,
                                           load_fan_params, upsample2_nearest)
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

WEIGHTS = Path(__file__).resolve().parents[1] / "assets" / "matting_weights.npz"


# ---------------------------------------------------------------------------
# classical: background-difference matting with guided-filter refinement
# ---------------------------------------------------------------------------

def _box(img: np.ndarray, r: int) -> np.ndarray:
    """Box filter with edge-clamped window sums via integral images."""
    h, w = img.shape[:2]
    pad = np.pad(img, [(1, 0), (1, 0)] + [(0, 0)] * (img.ndim - 2))
    ii = pad.cumsum(0).cumsum(1)
    y0 = np.clip(np.arange(h) - r, 0, h)
    y1 = np.clip(np.arange(h) + r + 1, 0, h)
    x0 = np.clip(np.arange(w) - r, 0, w)
    x1 = np.clip(np.arange(w) + r + 1, 0, w)
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.float32)
    s = ii[y1[:, None], x1[None, :]] - ii[y0[:, None], x1[None, :]] \
        - ii[y1[:, None], x0[None, :]] + ii[y0[:, None], x0[None, :]]
    return s / area.reshape(area.shape + (1,) * (img.ndim - 2))


def guided_filter(guide: np.ndarray, src: np.ndarray, r: int = 8,
                  eps: float = 1e-3) -> np.ndarray:
    """Single-channel guided filter (guide, src (H, W) float32)."""
    mean_i = _box(guide, r)
    mean_p = _box(src, r)
    corr_ip = _box(guide * src, r)
    corr_ii = _box(guide * guide, r)
    cov_ip = corr_ip - mean_i * mean_p
    var_i = corr_ii - mean_i * mean_i
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return _box(a, r) * guide + _box(b, r)


def alpha_from_background_diff(img: np.ndarray, bg: np.ndarray,
                               lo: float = 0.04, hi: float = 0.14,
                               refine_r: int = 8) -> np.ndarray:
    """img, bg (H, W, 3) float32 in [0,1] -> alpha (H, W) float32.

    Distance is the max channel difference with a local-mean term for
    robustness to noise; lo/hi give a soft hysteresis ramp; the guided
    filter snaps the ramp to image edges.
    """
    d = np.abs(img - bg)
    dist = 0.5 * d.max(-1) + 0.5 * _box(d.mean(-1), 2)
    alpha = np.clip((dist - lo) / (hi - lo), 0.0, 1.0).astype(np.float32)
    guide = img.mean(-1).astype(np.float32)
    alpha = np.clip(guided_filter(guide, alpha, refine_r), 0.0, 1.0)
    return alpha


def _frames(image_dir: Path):
    return sorted(p for p in Path(image_dir).iterdir()
                  if p.suffix.lower() in (".jpg", ".png", ".jpeg"))


def _save_alpha(alpha: np.ndarray, path: Path) -> None:
    from PIL import Image
    Image.fromarray((alpha * 255).astype(np.uint8)).save(path, quality=95)


def background_diff_matting(image_dir: Path, background_folder: Path,
                            lo: float = 0.04, hi: float = 0.14):
    """Write alpha_maps/ for every frame using per-camera background plates
    (same output contract as vhap/preprocess_video.py:88-134)."""
    from PIL import Image
    from vhap_tpu_torch.preprocess.video import _find_background

    image_dir = Path(image_dir)
    out_dir = image_dir.parent / "alpha_maps"
    out_dir.mkdir(exist_ok=True, parents=True)
    frames = _frames(image_dir)
    bg_cache: Dict[str, np.ndarray] = {}
    for f in frames:
        cam = f.stem.split("_")[0]
        if cam not in bg_cache:
            bg_path = _find_background(Path(background_folder), cam)
            bg_cache[cam] = np.asarray(
                Image.open(bg_path), np.float32)[..., :3] / 255.0
        img = np.asarray(Image.open(f), np.float32)[..., :3] / 255.0
        bg = bg_cache[cam]
        if bg.shape != img.shape:
            bg = np.asarray(Image.fromarray(
                (bg * 255).astype(np.uint8)).resize(
                    (img.shape[1], img.shape[0])), np.float32) / 255.0
        _save_alpha(alpha_from_background_diff(img, bg, lo, hi), out_dir / f"{f.stem}.jpg")
    logger.info(f"background_diff_matting: wrote {len(frames)} alpha maps "
                f"to {out_dir}")


# ---------------------------------------------------------------------------
# learned: the small synthetic-trained U-Net
# ---------------------------------------------------------------------------

class UNet(nn.Module):
    """Encoder/decoder with skip connections (3x3 convs, ReLU, 2x2 mean
    pools, nearest upsampling); a 1-channel logit out. H and W must be
    multiples of 2^(levels-1)."""

    def __init__(self, base: int = 16, levels: int = 4, in_ch: int = 3):
        super().__init__()
        self.levels = levels
        c_in = in_ch
        for i in range(levels):
            c_out = base << i
            self.add_module(f"enc{i}_a", conv(c_in, c_out, 3))
            self.add_module(f"enc{i}_b", conv(c_out, c_out, 3))
            c_in = c_out
        for i in range(levels - 2, -1, -1):
            c_skip, c_up = base << i, base << (i + 1)
            self.add_module(f"dec{i}_a", conv(c_up + c_skip, c_skip, 3))
            self.add_module(f"dec{i}_b", conv(c_skip, c_skip, 3))
        self.out = conv(base, 1, 3)

    @classmethod
    def from_params(cls, params: Dict, device=None) -> "UNet":
        """The module of a parameter tree, in eval mode on `device` (the
        card unless given another)."""
        m = params["meta"]
        net = cls(int(m["base"]), int(m["levels"]), int(m["in_ch"]))
        net.load_state_dict(unet_params_to_torch(params))
        return net.to(resolve_device(device)).eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, in_ch, H, W) -> alpha logits (B, 1, H, W)."""
        skips = []
        h = x
        for i in range(self.levels):
            h = F.relu(getattr(self, f"enc{i}_a")(h))
            h = F.relu(getattr(self, f"enc{i}_b")(h))
            if i < self.levels - 1:
                skips.append(h)
                h = avg_pool2(h)
        for i in range(self.levels - 2, -1, -1):
            h = torch.cat([upsample2_nearest(h), skips[i]], dim=1)
            h = F.relu(getattr(self, f"dec{i}_a")(h))
            h = F.relu(getattr(self, f"dec{i}_b")(h))
        return self.out(h)


def init_unet_params(gen: Optional[torch.Generator] = None, base: int = 16,
                     levels: int = 4, in_ch: int = 3) -> Dict:
    """Random-initialized U-Net parameter tree (numpy)."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    p: Dict = {"meta": {"base": base, "levels": levels, "in_ch": in_ch}}
    c_in = in_ch
    for i in range(levels):
        c_out = base << i
        p[f"enc{i}_a"] = _init_conv(gen, 3, 3, c_in, c_out)
        p[f"enc{i}_b"] = _init_conv(gen, 3, 3, c_out, c_out)
        c_in = c_out
    for i in range(levels - 2, -1, -1):
        c_skip, c_up = base << i, base << (i + 1)
        p[f"dec{i}_a"] = _init_conv(gen, 3, 3, c_up + c_skip, c_skip)
        p[f"dec{i}_b"] = _init_conv(gen, 3, 3, c_skip, c_skip)
    p["out"] = _init_conv(gen, 3, 3, base, 1)
    return p


class MattingUNet:
    """Per-frame alpha matting with the synthetic-trained U-Net, on
    `device` (the card unless given another)."""

    def __init__(self, params_path: Optional[str] = None, params=None, device=None):
        self.device = resolve_device(device)
        if params is None:
            params_path = Path(params_path) if params_path is not None else WEIGHTS
            if not params_path.exists():
                raise RuntimeError(
                    f"No matting weights at {params_path}; the bundled ones are "
                    "vhap_tpu_torch/assets/matting_weights.npz")
            params = load_fan_params(str(params_path))
        self.params = params
        self.net = UNet.from_params(params, self.device)
        self.stride = 1 << (self.net.levels - 1)

    def alpha(self, x: np.ndarray) -> np.ndarray:
        """x (B, H, W, 3) float32 [0,1], H and W multiples of the stride ->
        the network's alpha (B, H, W), before refinement."""
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        with torch.no_grad(), full_float32():
            a = torch.sigmoid(self.net(xt.permute(0, 3, 1, 2)))[:, 0]
            return a.cpu().numpy()

    def predict(self, img: np.ndarray) -> np.ndarray:
        """img (H, W, 3) float32 [0,1] -> alpha (H, W) float32 [0,1].

        Pads to the U-Net's stride (edge values), runs at full resolution,
        and refines with the guided filter like the classical path.
        """
        h, w = img.shape[:2]
        x = np.pad(img, ((0, (-h) % self.stride), (0, (-w) % self.stride), (0, 0)),
                   mode="edge")
        alpha = self.alpha(x[None])[0][:h, :w]
        return np.clip(guided_filter(img.mean(-1).astype(np.float32), alpha, 4),
                       0.0, 1.0)


def matting_unet(image_dir: Path, params_path: Optional[str] = None, device=None):
    """Write alpha_maps/ for every frame with MattingUNet (monocular, no
    background plates: the RobustVideoMatting slot)."""
    from PIL import Image

    net = MattingUNet(params_path, device=device)
    image_dir = Path(image_dir)
    out_dir = image_dir.parent / "alpha_maps"
    out_dir.mkdir(exist_ok=True, parents=True)
    frames = _frames(image_dir)
    for f in frames:
        img = np.asarray(Image.open(f), np.float32)[..., :3] / 255.0
        _save_alpha(net.predict(img), out_dir / f"{f.stem}.jpg")
    logger.info(f"matting_unet: wrote {len(frames)} alpha maps to {out_dir}")
