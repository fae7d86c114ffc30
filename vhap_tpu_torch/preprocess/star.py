"""STAR 68-point landmark alignment in PyTorch.

Counterpart of vhap_tpu/preprocess/star.py: the reference's default
landmark detector (vhap/util/landmark_detector_star.py:221-273) runs the
STAR alignment network, a stacked hourglass ("StackedHGNetV1", Zhou et
al., "STAR Loss: Reducing Semantic Ambiguity in Facial Landmark
Detection", CVPR 2023): a CoordConv stem, four 4-level hourglass stacks at
256 features, per-stack heatmap heads with instance-norm + ReLU
activation, and a soft-argmax decoder.

The graph is an nn.Module over NCHW tensors, built from the JAX package's
parameter tree through `vhap_tpu_torch.convert`, with the same pinned
micro-choices: max-pool in the stem and the hourglass, nearest
upsampling, pre-activation bottleneck residuals (BN-ReLU-1x1-half,
BN-ReLU-3x3-half, BN-ReLU-1x1-full, 1x1 skip on a channel change).
`convert_torch_checkpoint` maps a torch state dict onto the tree (official
container prefixes through OFFICIAL_KEY_MAP; an unmatched key raises). No
STAR weights are bundled.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vhap_tpu_torch.convert import star_params_to_torch
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.preprocess.fan import (BatchNorm, _init_bn, _init_conv, conv,
                                           load_fan_params, load_torch_state_dict,
                                           save_fan_params, upsample2_nearest)

_IN_EPS = 1e-5


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max, VALID."""
    return F.max_pool2d(x, 2)


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W (biased variance)
    with affine parameters."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((x - mean) * torch.rsqrt(var + _IN_EPS) * weight[:, None, None]
            + bias[:, None, None])


def coord_channels(B: int, H: int, W: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """CoordConv channels (B, 2, H, W): x and y in [-1, 1] (row 0 / col 0
    = -1)."""
    ys = torch.linspace(-1.0, 1.0, H, dtype=dtype, device=device)
    xs = torch.linspace(-1.0, 1.0, W, dtype=dtype, device=device)
    grid = torch.stack([xs[None, :].expand(H, W), ys[:, None].expand(H, W)])
    return grid[None].expand(B, 2, H, W)


def soft_argmax(hm: torch.Tensor) -> torch.Tensor:
    """(B, L, H, W) activated heatmaps -> (B, L, 2) coords in [-1, 1]: the
    per-channel expectation of the pixel grid under the (non-negative,
    normalized) heatmap."""
    B, L, H, W = hm.shape
    w = torch.clamp_min(hm, 0.0)
    w = w / torch.clamp_min(w.sum(dim=(2, 3), keepdim=True), 1e-8)
    ys = torch.linspace(-1.0, 1.0, H, dtype=hm.dtype, device=hm.device)
    xs = torch.linspace(-1.0, 1.0, W, dtype=hm.dtype, device=hm.device)
    cx = (w * xs[None, None, None, :]).sum(dim=(2, 3))
    cy = (w * ys[None, None, :, None]).sum(dim=(2, 3))
    return torch.stack([cx, cy], dim=-1)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class Residual(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        half = cout // 2
        self.bn1, self.conv1 = BatchNorm(cin), conv(cin, half, 1)
        self.bn2, self.conv2 = BatchNorm(half), conv(half, half, 3)
        self.bn3, self.conv3 = BatchNorm(half), conv(half, cout, 1)
        if cin != cout:
            self.skip_conv = conv(cin, cout, 1)

    def forward(self, x, batch_stats: bool):
        o = self.conv1(F.relu(self.bn1(x, batch_stats)))
        o = self.conv2(F.relu(self.bn2(o, batch_stats)))
        o = self.conv3(F.relu(self.bn3(o, batch_stats)))
        return o + (self.skip_conv(x) if hasattr(self, "skip_conv") else x)


class Hourglass(nn.Module):
    def __init__(self, depth: int, feats: int):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            for part in ("up1", "low1", "low3"):
                self.add_module(f"{part}_{level}", Residual(feats, feats))
        self.bottom = Residual(feats, feats)

    def level(self, x, level: int, batch_stats: bool):
        block = lambda part, y: getattr(self, f"{part}_{level}")(y, batch_stats)
        up1 = block("up1", x)
        low1 = block("low1", max_pool2(x))
        low2 = (self.level(low1, level - 1, batch_stats) if level > 1
                else self.bottom(low1, batch_stats))
        return up1 + upsample2_nearest(block("low3", low2))

    def forward(self, x, batch_stats: bool):
        return self.level(x, self.depth, batch_stats)


class _InstanceNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return instance_norm(x, self.weight, self.bias)


class STAR(nn.Module):
    """StackedHGNetV1. `biased` names the merge convs that carry a bias
    (the heatmap heads out{i} always do)."""

    def __init__(self, nstack: int = 4, depth: int = 4, feats: int = 256,
                 num_landmarks: int = 68, in_ch: int = 3, bn_mode: int = 0,
                 biased=()):
        super().__init__()
        biased = set(biased)
        self.nstack, self.bn_mode = nstack, bn_mode
        f4, f2 = max(feats // 4, 8), max(feats // 2, 8)
        self.pre_conv = conv(in_ch + 2, f4, 7, stride=2)   # CoordConv
        self.pre_bn = BatchNorm(f4)
        self.res1 = Residual(f4, f2)
        self.res2 = Residual(f2, f2)
        self.res3 = Residual(f2, feats)
        for i in range(nstack):
            self.add_module(f"hg{i}", Hourglass(depth, feats))
            self.add_module(f"feat{i}_res", Residual(feats, feats))
            self.add_module(f"feat{i}_conv", conv(feats, feats, 1))
            self.add_module(f"feat{i}_bn", BatchNorm(feats))
            self.add_module(f"out{i}", conv(feats, num_landmarks, 1, bias=True))
            self.add_module(f"act{i}_in", _InstanceNorm(num_landmarks))
            if i < nstack - 1:
                for name, cin in ((f"merge_f{i}", feats), (f"merge_h{i}", num_landmarks)):
                    self.add_module(name, conv(cin, feats, 1, bias=name in biased))

    @classmethod
    def from_params(cls, params: Dict, device=None) -> "STAR":
        """The module of a parameter tree, in eval mode on `device` (the
        card unless given another)."""
        m = params["meta"]
        net = cls(int(m["nstack"]), int(m["depth"]), int(m["feats"]),
                  int(m["num_landmarks"]), in_ch=np.shape(params["pre_conv"])[2] - 2,
                  bn_mode=int(m.get("bn_mode", 0)),
                  biased=[k[:-len("_bias")] for k in params
                          if k.startswith("merge_") and k.endswith("_bias")])
        net.load_state_dict(star_params_to_torch(params))
        return net.to(resolve_device(device)).eval()

    def forward(self, x: torch.Tensor, batch_stats: Optional[bool] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x (B, 3, H, W) in [0, 1] -> (every stack's activated heatmaps
        (B, L, H/4, W/4), the last stack's landmarks (B, L, 2) in [-1, 1]
        crop coordinates)."""
        bs = bool(self.bn_mode) if batch_stats is None else batch_stats
        B, _, H, W = x.shape
        x = torch.cat([x, coord_channels(B, H, W, x.dtype, x.device)], dim=1)
        x = F.relu(self.pre_bn(self.pre_conv(x), bs))
        x = max_pool2(self.res1(x, bs))
        x = self.res3(self.res2(x, bs), bs)
        outputs = []
        for i in range(self.nstack):
            sub = lambda name: getattr(self, name.format(i))
            feat = sub("feat{}_res")(sub("hg{}")(x, bs), bs)
            feat = F.relu(sub("feat{}_bn")(sub("feat{}_conv")(feat), bs))
            hm = F.relu(sub("act{}_in")(sub("out{}")(feat)))
            outputs.append(hm)
            if i < self.nstack - 1:
                x = x + sub("merge_f{}")(feat) + sub("merge_h{}")(hm)
        return outputs, soft_argmax(outputs[-1])


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_residual(gen, cin, cout):
    half = cout // 2
    p = {"bn1": _init_bn(cin), "conv1": _init_conv(gen, 1, 1, cin, half),
         "bn2": _init_bn(half), "conv2": _init_conv(gen, 3, 3, half, half),
         "bn3": _init_bn(half), "conv3": _init_conv(gen, 1, 1, half, cout)}
    if cin != cout:
        p["skip_conv"] = _init_conv(gen, 1, 1, cin, cout)
    return p


def _init_hourglass(gen, depth, feats):
    p = {}
    for level in range(depth, 0, -1):
        p[f"up1_{level}"] = _init_residual(gen, feats, feats)
        p[f"low1_{level}"] = _init_residual(gen, feats, feats)
        if level == 1:
            p["bottom"] = _init_residual(gen, feats, feats)
        p[f"low3_{level}"] = _init_residual(gen, feats, feats)
    return p


def init_star_params(gen: Optional[torch.Generator] = None, nstack: int = 4,
                     depth: int = 4, feats: int = 256, num_landmarks: int = 68,
                     in_ch: int = 3) -> Dict:
    """Random-initialized StackedHGNetV1 parameter tree (numpy). Defaults:
    the STAR "alignment" config (4 stacks, depth 4, 256 features, 68
    landmarks; 256x256 input -> 64x64 heatmaps)."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    f4, f2 = max(feats // 4, 8), max(feats // 2, 8)
    p = {"pre_conv": _init_conv(gen, 7, 7, in_ch + 2, f4),
         "pre_bn": _init_bn(f4),
         "res1": _init_residual(gen, f4, f2),
         "res2": _init_residual(gen, f2, f2),
         "res3": _init_residual(gen, f2, feats),
         "meta": {"nstack": nstack, "depth": depth, "feats": feats,
                  "num_landmarks": num_landmarks, "bn_mode": 0}}
    for i in range(nstack):
        p[f"hg{i}"] = _init_hourglass(gen, depth, feats)
        p[f"feat{i}_res"] = _init_residual(gen, feats, feats)
        p[f"feat{i}_conv"] = _init_conv(gen, 1, 1, feats, feats)
        p[f"feat{i}_bn"] = _init_bn(feats)
        p[f"out{i}"] = _init_conv(gen, 1, 1, feats, num_landmarks)
        p[f"out{i}_bias"] = np.zeros(num_landmarks, np.float32)
        p[f"act{i}_in"] = {"scale": np.ones(num_landmarks, np.float32),
                           "bias": np.zeros(num_landmarks, np.float32)}
        if i < nstack - 1:
            p[f"merge_f{i}"] = _init_conv(gen, 1, 1, feats, feats)
            p[f"merge_h{i}"] = _init_conv(gen, 1, 1, num_landmarks, feats)
    return p


# ---------------------------------------------------------------------------
# crop / decode (the reference wrapper's 200-pixel scale convention,
# vhap/util/landmark_detector_star.py:240-273)
# ---------------------------------------------------------------------------

def landmarks_to_image(lmks_crop: np.ndarray, center, scale,
                       resolution: int = 256) -> np.ndarray:
    """(L, 2) soft-argmax coords in [-1, 1] -> image-space pixels.

    The crop frame spans 200*scale image pixels centered on `center`."""
    h = 200.0 * scale
    pts = (np.asarray(lmks_crop, np.float64) * 0.5 + 0.5) * h
    pts[:, 0] += center[0] - h / 2.0
    pts[:, 1] += center[1] - h / 2.0
    return pts.astype(np.float32)


def bbox_to_center_scale(bbox) -> Tuple[np.ndarray, float]:
    """The reference wrapper's dlib-box post-processing
    (landmark_detector_star.py:244-248): scale from the smaller box side
    over the 200-pixel reference, padded 5%."""
    x1, y1, x2, y2 = [float(v) for v in bbox[:4]]
    center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])
    scale = min(x2 - x1, y2 - y1) / 200.0 * 1.05
    return center, scale


def crop_for_star(img: np.ndarray, center, scale,
                  resolution: int = 256) -> np.ndarray:
    """Crop the 200*scale square around center, resized to resolution."""
    h = 200.0 * scale
    ul = np.array([center[0] - h / 2.0, center[1] - h / 2.0]).astype(int)
    br = (ul + int(round(h))).astype(int)
    H, W = img.shape[:2]
    crop = np.zeros((br[1] - ul[1], br[0] - ul[0], 3), img.dtype)
    sx0, sx1 = max(0, ul[0]), min(W, br[0])
    sy0, sy1 = max(0, ul[1]), min(H, br[1])
    dx0, dy0 = max(0, -ul[0]), max(0, -ul[1])
    if sy1 > sy0 and sx1 > sx0:
        crop[dy0:dy0 + (sy1 - sy0), dx0:dx0 + (sx1 - sx0)] = \
            img[sy0:sy1, sx0:sx1]
    from PIL import Image
    out = np.asarray(Image.fromarray(crop.astype(np.uint8)).resize(
        (resolution, resolution), Image.BILINEAR))
    return out.astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# torch checkpoint conversion
# ---------------------------------------------------------------------------

# Official StackedHGNetV1 checkpoints name their modules through
# nn.Sequential/ModuleList containers; this table translates those prefixes
# onto this module's explicit names. It is best-effort (the package is not
# available to test against); convert_torch_checkpoint reports unmatched
# keys.
OFFICIAL_KEY_MAP = {
    "pre.0.conv": "pre_conv",
    "pre.1": "pre_bn",
    "pre.3": "res1",
    "pre.5": "res2",
    "pre.6": "res3",
}
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def _bn_from(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"],
            "mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}


def _conv_from(sd, name):
    return sd[name + ".weight"].transpose(2, 3, 1, 0)   # OIHW -> HWIO


def _residual_from(sd, prefix, used):
    p = {}
    for bn, cv in (("bn1", "conv1"), ("bn2", "conv2"), ("bn3", "conv3")):
        p[bn] = _bn_from(sd, f"{prefix}.{bn}")
        p[cv] = _conv_from(sd, f"{prefix}.{cv}")
        used.update(f"{prefix}.{bn}.{s}" for s in _BN_FIELDS)
        used.add(f"{prefix}.{cv}.weight")
    if f"{prefix}.skip_conv.weight" in sd:
        p["skip_conv"] = _conv_from(sd, f"{prefix}.skip_conv")
        used.add(f"{prefix}.skip_conv.weight")
    return p


def convert_torch_checkpoint(path: str, nstack: int = 4, depth: int = 4) -> Dict:
    """Convert a STAR/StackedHGNetV1 torch checkpoint into the parameter
    tree (numpy). Containers named with OFFICIAL_KEY_MAP prefixes are
    remapped; any state-dict key that matches no known module raises with
    the unmatched list (a layout drift is loud, never silent)."""
    sd = load_torch_state_dict(path, "net", "state_dict")
    remapped = {}
    for k, v in sd.items():
        for off, mine in OFFICIAL_KEY_MAP.items():
            if k.startswith(off + "."):
                k = mine + k[len(off):]
                break
        k = (k.replace("hgs.", "hg").replace("features.", "feat")
              .replace("out_heatmaps.", "out").replace("merge_features.", "merge_f")
              .replace("merge_heatmaps.", "merge_h"))
        remapped[k] = v
    sd = remapped

    used: set = {"pre_conv.weight"} | {f"pre_bn.{s}" for s in _BN_FIELDS}
    p: Dict = {"pre_conv": _conv_from(sd, "pre_conv"), "pre_bn": _bn_from(sd, "pre_bn")}
    if "pre_conv.bias" in sd:
        p["pre_bn"] = dict(p["pre_bn"], mean=p["pre_bn"]["mean"] - sd["pre_conv.bias"])
        used.add("pre_conv.bias")
    for name in ("res1", "res2", "res3"):
        p[name] = _residual_from(sd, name, used)

    L = sd["out0.weight"].shape[0]
    feats = sd["feat0_conv.weight"].shape[0]
    p["meta"] = {"nstack": nstack, "depth": depth, "feats": feats,
                 "num_landmarks": L, "bn_mode": 0}
    for i in range(nstack):
        hg = {}
        for level in range(depth, 0, -1):
            for part in ("up1", "low1", "low3"):
                hg[f"{part}_{level}"] = _residual_from(sd, f"hg{i}.{part}_{level}", used)
            if level == 1:
                hg["bottom"] = _residual_from(sd, f"hg{i}.bottom", used)
        p[f"hg{i}"] = hg
        p[f"feat{i}_res"] = _residual_from(sd, f"feat{i}_res", used)
        p[f"feat{i}_conv"] = _conv_from(sd, f"feat{i}_conv")
        used.add(f"feat{i}_conv.weight")
        bn = _bn_from(sd, f"feat{i}_bn")
        if f"feat{i}_conv.bias" in sd:
            bn = dict(bn, mean=bn["mean"] - sd[f"feat{i}_conv.bias"])
            used.add(f"feat{i}_conv.bias")
        p[f"feat{i}_bn"] = bn
        used.update(f"feat{i}_bn.{s}" for s in _BN_FIELDS)
        p[f"out{i}"] = _conv_from(sd, f"out{i}")
        used.update({f"out{i}.weight", f"out{i}.bias"})
        p[f"out{i}_bias"] = (sd[f"out{i}.bias"] if f"out{i}.bias" in sd
                             else np.zeros(L, np.float32))
        p[f"act{i}_in"] = ({"scale": sd[f"act{i}_in.weight"],
                            "bias": sd[f"act{i}_in.bias"]}
                           if f"act{i}_in.weight" in sd
                           else {"scale": np.ones(L, np.float32),
                                 "bias": np.zeros(L, np.float32)})
        used.update({f"act{i}_in.weight", f"act{i}_in.bias"})
        if i < nstack - 1:
            for name in (f"merge_f{i}", f"merge_h{i}"):
                p[name] = _conv_from(sd, name)
                used.add(f"{name}.weight")
                if f"{name}.bias" in sd:
                    p[name + "_bias"] = sd[f"{name}.bias"]
                    used.add(f"{name}.bias")

    unmatched = sorted(k for k in sd if k not in used
                       and not k.endswith("num_batches_tracked"))
    if unmatched:
        raise ValueError(
            "STAR checkpoint keys with no place in the converted tree "
            f"(layout drift?): {unmatched[:20]}{'...' if len(unmatched) > 20 else ''}")
    return p


save_star_params = save_fan_params
load_star_params = load_fan_params
