"""FAN (Face Alignment Network) 68-point landmark inference in PyTorch.

Counterpart of vhap_tpu/preprocess/fan.py. The stacked-hourglass graph of
face_alignment's FAN (Bulat & Tzimiropoulos, ICCV 2017; the module graph of
face_alignment/models.py) is an nn.Module over NCHW tensors, built from the
same parameter tree as the JAX package's (HWIO kernels, BatchNorm
scale/bias/mean/var, `meta`) through `vhap_tpu_torch.convert`, so

  * the bundled synthetic-trained weights (assets/fan_weights.npz, the
    same file as the JAX package's) and converted official face_alignment
    checkpoints load into it, and the two packages read each other's npz
    files;
  * convolutions run on cuDNN in full float32: `full_float32()` turns
    TF32 off around every forward of the preprocess networks (TF32 moves
    the heatmaps by ~1e-3 relative and can flip a landmark's argmax).

BatchNorm runs from stored statistics (`meta.bn_mode` 0) or from the
batch's own biased statistics (1: the synthetic nets were trained so);
`finalize_bn_stats` bakes batch statistics into stored ones.

The face detector of the reference stack (sfd) is not ported: boxes come
from an external detector or from `coarse_bbox_from_heatmaps`, a
whole-image FAN pass whose landmark extent seeds the refined crop. The
crop and decode helpers are host numpy, copied from the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vhap_tpu_torch.convert import fan_params_to_torch
from vhap_tpu_torch.device import resolve_device

_BN_EPS = 1e-5

# cuDNN's TF32 switch is one flag for the process: the networks' forwards
# hold this lock while they turn it off, so threads running them (the
# landmark annotator's pool) never restore it under one another
_FLOAT32_LOCK = threading.RLock()


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions in full float32 (TF32 off) for the duration."""
    with _FLOAT32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """BatchNorm from stored statistics, or (batch_stats=True) from the
    batch's own mean and biased variance over N, H, W."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        if not batch_stats:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=_BN_EPS)
        # the JAX package's form: x * inv + (bias - mean * inv)
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        inv = torch.rsqrt(var + _BN_EPS) * self.weight
        return x * inv[:, None, None] + (self.bias - mean * inv)[:, None, None]


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """A k x k convolution padded to keep the size (stride 1)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean, VALID: an odd size is floored."""
    return F.avg_pool2d(x, 2)


def upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class ConvBlock(nn.Module):
    """face_alignment's ConvBlock: three pre-activation 3x3 convs whose
    outputs are concatenated, plus the (downsampled) input."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1, self.conv1 = BatchNorm(cin), conv(cin, cout // 2, 3)
        self.bn2, self.conv2 = BatchNorm(cout // 2), conv(cout // 2, cout // 4, 3)
        self.bn3, self.conv3 = BatchNorm(cout // 4), conv(cout // 4, cout // 4, 3)
        if cin != cout:
            self.down_bn, self.down_conv = BatchNorm(cin), conv(cin, cout, 1)

    def forward(self, x, batch_stats: bool):
        o1 = self.conv1(F.relu(self.bn1(x, batch_stats)))
        o2 = self.conv2(F.relu(self.bn2(o1, batch_stats)))
        o3 = self.conv3(F.relu(self.bn3(o2, batch_stats)))
        out = torch.cat([o1, o2, o3], dim=1)
        if hasattr(self, "down_conv"):
            x = self.down_conv(F.relu(self.down_bn(x, batch_stats)))
        return out + x


class Hourglass(nn.Module):
    def __init__(self, depth: int, feats: int):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            for name in ("b1", "b2", "b3") + (("b2_plus",) if level == 1 else ()):
                self.add_module(f"{name}_{level}", ConvBlock(feats, feats))

    def level(self, x, level: int, batch_stats: bool):
        block = lambda name, y: getattr(self, f"{name}_{level}")(y, batch_stats)
        up1 = block("b1", x)
        low1 = block("b2", avg_pool2(x))
        low2 = (self.level(low1, level - 1, batch_stats) if level > 1
                else block("b2_plus", low1))
        return up1 + upsample2_nearest(block("b3", low2))

    def forward(self, x, batch_stats: bool):
        return self.level(x, self.depth, batch_stats)


class FAN(nn.Module):
    """face_alignment's FAN: stem, `num_modules` hourglasses with heatmap
    heads and merge connections. `biased` names the 1x1 head convs that
    carry a bias (official checkpoints' conv_last/l/bl/al)."""

    def __init__(self, num_modules: int = 4, depth: int = 4, feats: int = 256,
                 num_landmarks: int = 68, in_ch: int = 3, bn_mode: int = 0,
                 biased: Iterable[str] = ()):
        super().__init__()
        biased = set(biased)
        self.num_modules, self.bn_mode = num_modules, bn_mode
        f2, f4 = feats // 2, feats // 4
        self.conv1 = conv(in_ch, f4, 7, stride=2)
        self.bn1 = BatchNorm(f4)
        self.conv2 = ConvBlock(f4, f2)
        self.conv3 = ConvBlock(f2, f2)
        self.conv4 = ConvBlock(f2, feats)
        head = lambda name, cin, cout: self.add_module(
            name, conv(cin, cout, 1, bias=name in biased))
        for i in range(num_modules):
            self.add_module(f"m{i}", Hourglass(depth, feats))
            self.add_module(f"top_m_{i}", ConvBlock(feats, feats))
            head(f"conv_last{i}", feats, feats)
            self.add_module(f"bn_end{i}", BatchNorm(feats))
            head(f"l{i}", feats, num_landmarks)
            if i < num_modules - 1:
                head(f"bl{i}", feats, feats)
                head(f"al{i}", num_landmarks, feats)

    @classmethod
    def from_params(cls, params: Dict, device=None) -> "FAN":
        """The module of a parameter tree, in eval mode on `device` (the
        card unless given another)."""
        m = params["meta"]
        net = cls(int(m["num_modules"]), int(m["depth"]), int(m["feats"]),
                  int(m["num_landmarks"]), in_ch=np.shape(params["conv1"])[2],
                  bn_mode=int(m.get("bn_mode", 0)),
                  biased=[k[:-len("_bias")] for k in params if k.endswith("_bias")])
        net.load_state_dict(fan_params_to_torch(params))
        return net.to(resolve_device(device)).eval()

    def forward(self, x: torch.Tensor, batch_stats: Optional[bool] = None
                ) -> List[torch.Tensor]:
        """x (B, 3, H, W) in [0, 1] -> every module's heatmaps (B, L, H/4,
        W/4); the last is the prediction. batch_stats=None reads bn_mode."""
        bs = bool(self.bn_mode) if batch_stats is None else batch_stats
        x = F.relu(self.bn1(self.conv1(x), bs))
        x = avg_pool2(self.conv2(x, bs))
        x = self.conv4(self.conv3(x, bs), bs)
        outputs = []
        previous = x
        for i in range(self.num_modules):
            sub = lambda name: getattr(self, f"{name}{i}")
            ll = sub("top_m_")(sub("m")(previous, bs), bs)
            ll = F.relu(sub("bn_end")(sub("conv_last")(ll), bs))
            tmp_out = sub("l")(ll)
            outputs.append(tmp_out)
            if i < self.num_modules - 1:
                previous = previous + sub("bl")(ll) + sub("al")(tmp_out)
        return outputs


def finalize_bn_stats(params: Dict, batches, device=None) -> Dict:
    """Estimate BatchNorm running statistics over `batches` ((B, H, W, 3)
    arrays in [0, 1]) with batch-statistics forwards and bake them in.

    A net trained with batch statistics (bn_mode 1) degrades at batch-1
    inference. Returns a copy of params with each BatchNorm's mean and var
    replaced (the law of total variance over the batches) and
    meta.bn_mode 0."""
    dev = resolve_device(device)
    net = FAN.from_params(params, dev)
    names = {mod: name for name, mod in net.named_modules()
             if isinstance(mod, BatchNorm)}
    acc: Dict[str, list] = {}

    def record(mod, inputs, _):
        x = inputs[0].double()
        m = x.mean(dim=(0, 2, 3))
        v = x.var(dim=(0, 2, 3), unbiased=False)
        a = acc.setdefault(names[mod], [0.0, 0.0])
        a[0] = a[0] + m
        a[1] = a[1] + v + m ** 2

    hooks = [mod.register_forward_hook(record) for mod in names]
    try:
        n = 0
        with torch.no_grad(), full_float32():
            for x in batches:
                xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
                net(xt.permute(0, 3, 1, 2), batch_stats=True)
                n += 1
    finally:
        for h in hooks:
            h.remove()
    out = copy.deepcopy(params)
    for name, (m_sum, v_sum) in acc.items():
        node = out
        for part in name.split("."):
            node = node[part]
        mean = m_sum / n
        node["mean"] = mean.float().cpu().numpy()
        node["var"] = (v_sum / n - mean ** 2).float().cpu().numpy()
    out["meta"] = dict(params["meta"], bn_mode=0)
    return out


# ---------------------------------------------------------------------------
# parameter initialization (the JAX package's tree, drawn from a torch
# Generator)
# ---------------------------------------------------------------------------

def _init_conv(gen, kh, kw, cin, cout) -> np.ndarray:
    w = torch.randn((kh, kw, cin, cout), generator=gen) * np.sqrt(2.0 / (kh * kw * cin))
    return w.numpy()


def _init_bn(c) -> Dict[str, np.ndarray]:
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}


def _init_convblock(gen, cin, cout):
    p = {"bn1": _init_bn(cin), "conv1": _init_conv(gen, 3, 3, cin, cout // 2),
         "bn2": _init_bn(cout // 2),
         "conv2": _init_conv(gen, 3, 3, cout // 2, cout // 4),
         "bn3": _init_bn(cout // 4),
         "conv3": _init_conv(gen, 3, 3, cout // 4, cout // 4)}
    if cin != cout:
        p["down_bn"] = _init_bn(cin)
        p["down_conv"] = _init_conv(gen, 1, 1, cin, cout)
    return p


def _init_hourglass(gen, depth, feats):
    p = {}
    for level in range(depth, 0, -1):
        p[f"b1_{level}"] = _init_convblock(gen, feats, feats)
        p[f"b2_{level}"] = _init_convblock(gen, feats, feats)
        if level == 1:
            p[f"b2_plus_{level}"] = _init_convblock(gen, feats, feats)
        p[f"b3_{level}"] = _init_convblock(gen, feats, feats)
    return p


def init_fan_params(gen: Optional[torch.Generator] = None, num_modules: int = 4,
                    depth: int = 4, feats: int = 256, num_landmarks: int = 68,
                    in_ch: int = 3) -> Dict:
    """Random-initialized FAN parameter tree (numpy, He-normal kernels,
    identity BatchNorms, bn_mode 1). The defaults are face_alignment's
    FAN(4); small configurations train quickly on synthetic data."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    f2, f4 = feats // 2, feats // 4
    p = {"conv1": _init_conv(gen, 7, 7, in_ch, f4), "bn1": _init_bn(f4),
         "conv2": _init_convblock(gen, f4, f2),
         "conv3": _init_convblock(gen, f2, f2),
         "conv4": _init_convblock(gen, f2, feats),
         "meta": {"num_modules": num_modules, "depth": depth, "feats": feats,
                  "num_landmarks": num_landmarks, "bn_mode": 1}}
    for i in range(num_modules):
        p[f"m{i}"] = _init_hourglass(gen, depth, feats)
        p[f"top_m_{i}"] = _init_convblock(gen, feats, feats)
        p[f"conv_last{i}"] = _init_conv(gen, 1, 1, feats, feats)
        p[f"bn_end{i}"] = _init_bn(feats)
        p[f"l{i}"] = _init_conv(gen, 1, 1, feats, num_landmarks)
        if i < num_modules - 1:
            p[f"bl{i}"] = _init_conv(gen, 1, 1, feats, feats)
            p[f"al{i}"] = _init_conv(gen, 1, 1, num_landmarks, feats)
    return p


# ---------------------------------------------------------------------------
# crop / decode (face_alignment utils.py transform & get_preds_fromhm)
# ---------------------------------------------------------------------------

def _transform(point, center, scale, resolution, invert=False):
    """Map an image point to/from the FAN crop frame."""
    h = 200.0 * scale
    m = np.eye(3, dtype=np.float64)
    m[0, 0] = resolution / h
    m[1, 1] = resolution / h
    m[0, 2] = resolution * (-center[0] / h + 0.5)
    m[1, 2] = resolution * (-center[1] / h + 0.5)
    if invert:
        m = np.linalg.inv(m)
    pt = np.array([point[0], point[1], 1.0])
    return (m @ pt)[:2]


def bbox_to_center_scale(bbox) -> Tuple[np.ndarray, float]:
    """face_alignment's detector post-processing: center shifted down 12%,
    scale from the box diagonal over the 195-pixel reference."""
    x1, y1, x2, y2 = [float(v) for v in bbox[:4]]
    center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])
    center[1] -= (y2 - y1) * 0.12
    scale = (x2 - x1 + y2 - y1) / 195.0
    return center, scale


def crop_for_fan(img: np.ndarray, center, scale,
                 resolution: int = 256) -> np.ndarray:
    """Crop + resize the face region to (resolution, resolution), float [0,1]."""
    ul = _transform([1, 1], center, scale, resolution, invert=True).astype(int)
    br = _transform([resolution, resolution], center, scale, resolution,
                    invert=True).astype(int)
    h, w = img.shape[:2]
    crop = np.zeros((br[1] - ul[1], br[0] - ul[0], 3), img.dtype)
    sx0, sx1 = max(0, ul[0]), min(w, br[0])
    sy0, sy1 = max(0, ul[1]), min(h, br[1])
    dx0, dy0 = max(0, -ul[0]), max(0, -ul[1])
    crop[dy0:dy0 + (sy1 - sy0), dx0:dx0 + (sx1 - sx0)] = img[sy0:sy1, sx0:sx1]
    from PIL import Image
    out = np.asarray(Image.fromarray(crop.astype(np.uint8)).resize(
        (resolution, resolution), Image.BILINEAR))
    return out.astype(np.float32) / 255.0


def heatmaps_to_landmarks(hm: np.ndarray, center, scale) -> np.ndarray:
    """hm (L, Hh, Wh) -> (L, 2) image-space landmarks.

    argmax + quarter-pixel neighbor offset, then the inverse crop transform
    (face_alignment get_preds_fromhm).
    """
    L, H, W = hm.shape
    flat = hm.reshape(L, -1)
    idx = flat.argmax(axis=1)
    xs = (idx % W).astype(np.float64)
    ys = (idx // W).astype(np.float64)
    for i in range(L):
        x, y = int(xs[i]), int(ys[i])
        if 0 < x < W - 1:
            xs[i] += 0.25 * np.sign(hm[i, y, x + 1] - hm[i, y, x - 1])
        if 0 < y < H - 1:
            ys[i] += 0.25 * np.sign(hm[i, y + 1, x] - hm[i, y - 1, x])
    pts = np.stack([xs + 1.0, ys + 1.0], axis=1)  # 1-based like the reference
    out = np.stack([_transform(p, center, scale, H, invert=True)
                    for p in pts])
    return out.astype(np.float32)


def coarse_bbox_from_heatmaps(hm: np.ndarray, img_shape,
                              resolution: int = 256) -> Optional[np.ndarray]:
    """Derive a face bbox from a whole-image FAN pass (sfd substitute).

    The image is treated as one big crop; the landmark extent (padded 30%)
    becomes the detection box. Returns None when the peak response is too
    weak to be a face.
    """
    if float(hm.max()) < 0.1:
        return None
    h, w = img_shape[:2]
    center = np.array([w / 2.0, h / 2.0])
    scale = max(h, w) / 195.0
    pts = heatmaps_to_landmarks(hm, center, scale)
    x1, y1 = pts.min(axis=0)
    x2, y2 = pts.max(axis=0)
    pw, ph = (x2 - x1) * 0.15, (y2 - y1) * 0.15
    return np.array([max(0, x1 - pw), max(0, y1 - ph),
                     min(w, x2 + pw), min(h, y2 + ph), 1.0], np.float32)


# ---------------------------------------------------------------------------
# torch checkpoint conversion (official face_alignment weights)
# ---------------------------------------------------------------------------

def _bn_from_torch(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"],
            "mean": sd[prefix + ".running_mean"],
            "var": sd[prefix + ".running_var"]}


def _conv_from_torch(sd, name):
    return sd[name + ".weight"].transpose(2, 3, 1, 0)   # OIHW -> HWIO


def _convblock_from_torch(sd, prefix):
    p = {"bn1": _bn_from_torch(sd, prefix + ".bn1"),
         "conv1": _conv_from_torch(sd, prefix + ".conv1"),
         "bn2": _bn_from_torch(sd, prefix + ".bn2"),
         "conv2": _conv_from_torch(sd, prefix + ".conv2"),
         "bn3": _bn_from_torch(sd, prefix + ".bn3"),
         "conv3": _conv_from_torch(sd, prefix + ".conv3")}
    if prefix + ".downsample.0.weight" in sd:
        p["down_bn"] = _bn_from_torch(sd, prefix + ".downsample.0")
        p["down_conv"] = _conv_from_torch(sd, prefix + ".downsample.2")
    return p


def load_torch_state_dict(path: str, *keys: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict (under the first of `keys` it has,
    else the whole file) as numpy, the DataParallel `module.` prefix off."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = next((ckpt[k] for k in keys if k in ckpt), ckpt)
    return {k.removeprefix("module."): v.numpy() if hasattr(v, "numpy") else v
            for k, v in sd.items()}


def convert_torch_checkpoint(path: str, num_modules: int = 4,
                             depth: int = 4) -> Dict:
    """Convert a face_alignment FAN checkpoint (2DFAN4/3DFAN4 .pth[.tar])
    into the parameter tree (numpy)."""
    sd = load_torch_state_dict(path, "state_dict")
    p = {"conv1": _conv_from_torch(sd, "conv1"),
         "bn1": _bn_from_torch(sd, "bn1"),
         "conv2": _convblock_from_torch(sd, "conv2"),
         "conv3": _convblock_from_torch(sd, "conv3"),
         "conv4": _convblock_from_torch(sd, "conv4")}
    if "conv1.bias" in sd:
        # face_alignment's conv1 carries a bias; fold it into bn1's mean
        p["bn1"] = dict(p["bn1"], mean=p["bn1"]["mean"] - sd["conv1.bias"])
    L = sd["l0.weight"].shape[0]
    feats = sd["conv_last0.weight"].shape[0]
    p["meta"] = {"num_modules": num_modules, "depth": depth, "feats": feats,
                 "num_landmarks": L, "bn_mode": 0}
    for i in range(num_modules):
        hg = {}
        for level in range(depth, 0, -1):
            for b_ in ("b1", "b2", "b3"):
                hg[f"{b_}_{level}"] = _convblock_from_torch(sd, f"m{i}.{b_}_{level}")
            if level == 1:
                hg[f"b2_plus_{level}"] = _convblock_from_torch(
                    sd, f"m{i}.b2_plus_{level}")
        p[f"m{i}"] = hg
        p[f"top_m_{i}"] = _convblock_from_torch(sd, f"top_m_{i}")
        p[f"bn_end{i}"] = _bn_from_torch(sd, f"bn_end{i}")
        heads = [f"conv_last{i}", f"l{i}"]
        if i < num_modules - 1:
            heads += [f"bl{i}", f"al{i}"]
        for name in heads:
            p[name] = _conv_from_torch(sd, name)
            if name + ".bias" in sd:
                p[name + "_bias"] = sd[name + ".bias"]
    return p


# ---------------------------------------------------------------------------
# tree save / load (the JAX package's npz layout: "/"-joined paths)
# ---------------------------------------------------------------------------

def save_fan_params(path: str, params: Dict):
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(key, v)
            else:
                flat[key] = np.asarray(v)

    walk("", params)
    np.savez(path, **flat)


def load_fan_params(path: str) -> Dict:
    params: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = params
            for pkey in parts[:-1]:
                node = node.setdefault(pkey, {})
            v = data[key]
            node[parts[-1]] = int(v) if parts[0] == "meta" else v
    return params
