"""Train a small FAN landmark detector on synthetic FLAME renders.

Counterpart of vhap_tpu/tools/train_fan_synthetic.py. The reference needs a
68/70-point face landmark detector (vhap/util/landmark_detector_star.py /
landmark_detector_fa.py) whose weights are external downloads; this tool
makes the preprocess stage self-contained. Each step renders random FLAME
heads (shape, expression, pose, camera, lighting and background drawn on
the host from a numpy generator, as in the JAX tool) through
`render_rgba_vis` on the card's kernels (K5 visibility under rasterize(),
K6 plane gathers, K3 trilinear sampler) under torch.no_grad(), resamples
each through a random detector-geometry crop, adds photometric noise, and
trains the port's FAN (preprocess/fan.py) with batch statistics to regress
64x64 heatmaps of the model's 70 landmarks, with optax.adam's update and
cosine schedule. After training the BatchNorm statistics are baked on
detector-geometry crops (finalize_bn_stats), the held-out error is taken at
batch 1 from the stored statistics (what the detector runs), and the tree
is written in the npz layout both packages' load_fan_params read.

The crop resampler is jax.image.scale_and_translate's "linear" method
rebuilt in plain PyTorch: a triangle filter widened by 1/scale when it
downsamples, its weights renormalized, as separable per-sample weight
matrices applied with einsum. The augmentation's random draws come from a
torch.Generator and differ from jax.random's.

Usage: python -m vhap_tpu_torch.tools.train_fan_synthetic \\
           [--steps 1500] [--batch 8] \\
           [--out vhap_tpu_torch/assets/fan_weights.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vhap_tpu_torch.convert import fan_params_from_torch
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.model.flame import FlameHead, FlameTexPainted
from vhap_tpu_torch.ops import camera as cam
from vhap_tpu_torch.ops.render import RenderSettings, render_rgba_vis
from vhap_tpu_torch.ops.shading import uniform_sh_lights
from vhap_tpu_torch.preprocess import fan
from vhap_tpu_torch.tracker.energy import render_verts_uv
from vhap_tpu_torch.tracker.optim import adam_update
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

HM_SIZE = 64
IMG_SIZE = 256
N_LMK = 70
DEFAULT_OUT = "vhap_tpu_torch/assets/fan_weights.npz"


def _sample_params(rng, head, B):
    """Random FLAME + camera + light parameters (host side)."""
    head_center = np.asarray(head.v_template.cpu()).mean(0)
    t = {
        "shape": rng.normal(0, 0.7, (B, head.n_shape)).astype(np.float32),
        "expr": rng.normal(0, 0.7, (B, head.n_expr)).astype(np.float32),
        "rotation": rng.normal(0, 0.25, (B, 3)).astype(np.float32),
        "neck": rng.normal(0, 0.1, (B, 3)).astype(np.float32),
        "jaw": np.abs(rng.normal(0, 0.12, (B, 3))).astype(np.float32)
        * np.array([1, 0.2, 0.2], np.float32),
        "eyes": rng.normal(0, 0.05, (B, 6)).astype(np.float32),
        # head roughly centered, depth varying => scale augmentation
        "translation": (-head_center[None] + np.concatenate([
            rng.normal(0, 0.035, (B, 2)),
            rng.uniform(-0.25, 0.45, (B, 1))], -1)).astype(np.float32),
        # camera intrinsics jitter: principal point + focal
        "K": np.stack([
            rng.uniform(1.1, 1.9, B) * IMG_SIZE,
            rng.uniform(1.1, 1.9, B) * IMG_SIZE,
            IMG_SIZE / 2 + rng.normal(0, 18, B),
            IMG_SIZE / 2 + rng.normal(0, 18, B)], -1).astype(np.float32),
        "bg": rng.uniform(0, 1, (B, 1, 1, 3)).astype(np.float32),
        "tint": rng.uniform(0.6, 1.3, (B, 1, 1, 3)).astype(np.float32),
        "light_scale": rng.uniform(0.7, 1.4, (B, 1, 1)).astype(np.float32),
        "light_noise": rng.normal(0, 0.12, (B, 9, 3)).astype(np.float32),
    }
    return t


def to_device(p: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in p.items()}


def build_head(device=None):
    """The trainers' head (50 shape, 30 expression components, no teeth),
    its painted texture at 256^2 and the render's uv table."""
    head = FlameHead.build(n_shape=50, n_expr=30, add_teeth=False, device=device)
    dev = head.v_template.device
    tex = FlameTexPainted(head.assets.tex_painted, 256, device=dev)()
    return head, tex, render_verts_uv(head, dev)


def render_heads(head, tex, verts_uv, p, settings: Optional[RenderSettings] = None):
    """One batch of sampled heads: (tinted rgb (B, S, S, 3), alpha (B, S,
    S, 1), world landmarks, RT), without an autograd graph."""
    settings = settings or RenderSettings(lighting_type="SH")
    with torch.no_grad():
        B = p["shape"].shape[0]
        verts, lmks = head(shape=p["shape"], expr=p["expr"],
                           rotation=p["rotation"], neck=p["neck"],
                           jaw=p["jaw"], eyes=p["eyes"],
                           translation=p["translation"])
        RT = torch.eye(3, 4, device=verts.device)
        RT[2, 3] = -1.0
        RT = RT[None].expand(B, 3, 4)
        base_lights = torch.as_tensor(uniform_sh_lights(), device=verts.device)[None]
        lights = (base_lights + p["light_noise"]) * p["light_scale"]
        out = render_rgba_vis(verts, head.faces, RT, p["K"], (IMG_SIZE, IMG_SIZE),
                              settings, verts_uv=verts_uv, faces_uv=head.textures_idx,
                              tex=tex, lights=lights)
        rgba = out["rgba"]
        alpha = torch.clamp(rgba[..., 3:4], 0, 1)
        rgb = torch.clamp(rgba[..., :3] * p["tint"], 0, 1)
    return rgb, alpha, lmks, RT


def make_render_fn(head, tex, verts_uv, settings: Optional[RenderSettings] = None):
    """p (tensors of _sample_params) -> (image (B, S, S, 3) on its
    background, landmarks (B, L, 2) in pixels)."""
    def render(p):
        rgb, alpha, lmks, RT = render_heads(head, tex, verts_uv, p, settings)
        with torch.no_grad():
            img = rgb * alpha + p["bg"] * (1 - alpha)
            ndc = cam.world_to_ndc(lmks, RT, p["K"], (IMG_SIZE, IMG_SIZE), flip_y=True)
            px = (ndc[..., :2] * 0.5 + 0.5) * IMG_SIZE       # (B, L, 2) pixels
        return img, px
    return render


# ---------------------------------------------------------------------------
# the detector-geometry crop (jax.image.scale_and_translate, "linear")
# ---------------------------------------------------------------------------

def scale_translate_weights(in_size: int, out_size: int, scale: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """Per-sample (B, in_size, out_size) weights of JAX's compute_weight_mat
    with the triangle kernel and antialiasing: output o samples input
    position (o + 0.5 - t) / s - 0.5; when downsampling the kernel widens by
    1/s; each output's weights are renormalized, and an output whose sample
    falls outside [-0.5, in_size - 0.5] gets none."""
    dev, dt = scale.device, scale.dtype
    inv_scale = 1.0 / scale[:, None, None]                       # (B, 1, 1)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5) * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)  # (B, 1, out)
    x = (sample_f - torch.arange(in_size, dtype=dt, device=dev)[:, None]).abs() / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0)                          # (B, in, out)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def resample(img: torch.Tensor, sf: torch.Tensor, cx: torch.Tensor,
             cy: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) through the crop out = (in - c) * sf + S/2 per
    sample: JAX's scale_and_translate with scale (sf, sf) and translation
    (S/2 - cy sf, S/2 - cx sf) over (y, x), at the input's size."""
    B, H, W, _ = img.shape
    wy = scale_translate_weights(H, H, sf, IMG_SIZE / 2 - cy * sf)
    wx = scale_translate_weights(W, W, sf, IMG_SIZE / 2 - cx * sf)
    rows = torch.einsum("bijc,bjp->bipc", img, wx)
    return torch.einsum("bipc,bio->bopc", rows, wy)


def crop_draws(gen: torch.Generator, B: int, device) -> Dict[str, torch.Tensor]:
    kw = dict(generator=gen, device=device)
    return {"scale": torch.rand(B, **kw) * 0.5 + 0.8,
            "shift": torch.randn(B, 2, **kw),
            "whole": torch.rand(B, **kw),
            "whole_jitter": torch.randn(B, 3, **kw)}


def crop_with(img: torch.Tensor, px: torch.Tensor, draws: Dict[str, torch.Tensor]):
    """Each sample's crop for its draws -> (image, landmarks in the crop).
    The JAX tool's crop_augment geometry: the landmark box padded 15 % a
    side, its centre shifted up 12 % of its height and scale (bw + bh) /
    195 (fan.bbox_to_center_scale), both jittered; a ~30 % slice keeps the
    whole-image geometry of pass 1; out = (in - c) * sf + S/2."""
    x1, x2 = px[..., 0].amin(1), px[..., 0].amax(1)
    y1, y2 = px[..., 1].amin(1), px[..., 1].amax(1)
    bw, bh = 1.3 * (x2 - x1), 1.3 * (y2 - y1)
    cx = (x1 + x2) / 2
    cy = (y1 + y2) / 2 - 0.12 * bh
    scale = (bw + bh) / 195.0
    scale = scale * draws["scale"]
    jit_px = draws["shift"] * (0.04 * 200.0 * scale[:, None])
    cx, cy = cx + jit_px[:, 0], cy + jit_px[:, 1]
    whole = draws["whole"] < 0.3                   # pass-1 geometry
    wj = 1.0 + 0.15 * draws["whole_jitter"]
    scale = torch.where(whole, IMG_SIZE / 195.0 * wj[:, 0], scale)
    cx = torch.where(whole, IMG_SIZE / 2 * wj[:, 1], cx)
    cy = torch.where(whole, IMG_SIZE / 2 * wj[:, 2], cy)
    sf = IMG_SIZE / (200.0 * scale)
    out = resample(img, sf, cx, cy)
    c = torch.stack([cx, cy], -1)[:, None]         # (B, 1, 2)
    px = (px - c) * sf[:, None, None] + IMG_SIZE / 2
    return torch.clamp(out, 0.0, 1.0), px


def crop_augment(gen: torch.Generator, img: torch.Tensor, px: torch.Tensor):
    """Resample each sample through a random FAN-style crop so that training
    sees the detector's geometry (a whole-image pass and a refined crop,
    fan.crop_for_fan) -> (image, landmarks in the crop)."""
    return crop_with(img, px, crop_draws(gen, img.shape[0], img.device))


def heatmap_targets(px: torch.Tensor, size: int = HM_SIZE, sigma: float = 1.6):
    """px (B, L, 2) in image pixels -> (B, size, size, L) gaussians."""
    c = px / (IMG_SIZE / size)                            # heatmap coords
    ys = torch.arange(size, dtype=torch.float32, device=px.device)[:, None]
    xs = torch.arange(size, dtype=torch.float32, device=px.device)[None, :]
    dx = xs[None, None] - c[:, :, 0:1, None]              # (B, L, 1, S)
    dy = ys[None, None] - c[:, :, 1:2, None]              # (B, L, S, 1)
    hm = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))  # (B, L, S, S)
    return hm.permute(0, 2, 3, 1)


def box_blur3(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C): the 3x3 window sum over zero padding, / 9 (JAX's
    reduce_window SAME)."""
    x = F.avg_pool2d(img.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=True)
    return x.permute(0, 2, 3, 1)


def photometric(img, gamma, noise_std, noise, mix):
    """Gamma, gaussian pixel noise and a 3x3 box-blur mix, given the draws."""
    img = torch.clamp(img, 1e-4, 1.0) ** gamma
    img = img + noise_std * noise
    img = torch.where(mix, box_blur3(img), img)
    return torch.clamp(img, 0.0, 1.0)


def augment_image(gen: torch.Generator, img: torch.Tensor) -> torch.Tensor:
    """Photometric image-space augmentation (landmark-preserving)."""
    B, kw = img.shape[0], dict(generator=gen, device=img.device)
    gamma = torch.rand((B, 1, 1, 1), **kw) * 0.7 + 0.7
    noise_std = torch.rand((B, 1, 1, 1), **kw) * 0.04
    noise = torch.randn(img.shape, **kw)
    mix = torch.rand((B, 1, 1, 1), **kw) < 0.5
    return photometric(img, gamma, noise_std, noise, mix)


# ---------------------------------------------------------------------------
# optimizer and loss
# ---------------------------------------------------------------------------

def cosine_decay(lr: float, steps: int, alpha: float = 0.1) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, steps, alpha), in float32."""
    f = np.float32

    def schedule(count: int) -> float:
        c = f(min(count, steps))
        decay = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(steps)))
        return float(f(lr) * (f(1 - alpha) * decay + f(alpha)))
    return schedule


class Adam:
    """optax.adam on named parameters: tracker/optim.adam_update's
    bias-corrected direction times -lr(count), the schedule read at the
    count before the step (counted on the host too), added to each
    parameter in place."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 lr: Callable[[int], float]):
        self.params, self.lr = params, lr
        self.count = 0
        dev = next(iter(params.values())).device
        self.state = {"count": torch.zeros((), dtype=torch.int64, device=dev),
                      "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                      "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        step_size = -self.lr(self.count)
        self.count += 1
        updates, self.state = adam_update(grads, self.state)
        with torch.no_grad():
            for k, u in updates.items():
                self.params[k].add_(u * step_size)


def fan_loss(outs: List[torch.Tensor], hm_t: torch.Tensor) -> torch.Tensor:
    """Mean weighted squared heatmap error over the modules' outputs (B, L,
    h, w); positive regions (~0.4 % of a heatmap) weigh 31x, so the
    zero-output minimum is never attractive."""
    t = hm_t.permute(0, 3, 1, 2)
    w = 1.0 + 30.0 * t
    return sum(torch.mean((o - t) ** 2 * w) for o in outs) / len(outs)


def fan_step(net: fan.FAN, opt: Adam, img: torch.Tensor,
             hm_t: torch.Tensor) -> torch.Tensor:
    """One training step on (B, S, S, 3) images: batch-statistics forward,
    the loss's gradient, Adam; returns the loss."""
    with fan.full_float32():
        loss = fan_loss(net(img.permute(0, 3, 1, 2), batch_stats=True), hm_t)
        grads = torch.autograd.grad(loss, list(opt.params.values()))
    opt.step(dict(zip(opt.params, grads)))
    return loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FanTrainer:
    """The tool's run; `render_s` and `net_s` hold the host seconds of the
    training steps' renders (with the crop and augmentation) and of the
    network's forward, backward and Adam, each ended by a synchronize on
    the card."""

    def __init__(self, batch: int = 8, seed: int = 0, feats: int = 64,
                 num_modules: int = 1, depth: int = 3, lr: float = 2.5e-4,
                 steps: int = 1500, device=None):
        self.device = resolve_device(device)
        self.batch, self.steps = batch, steps
        self.head, self.tex, self.verts_uv = build_head(self.device)
        self.render = make_render_fn(self.head, self.tex, self.verts_uv)
        params = fan.init_fan_params(torch.Generator().manual_seed(seed),
                                     num_modules=num_modules, depth=depth,
                                     feats=feats, num_landmarks=N_LMK)
        self.meta = params["meta"]
        self.net = fan.FAN.from_params(params, self.device)
        # cosine decay to lr/10: the late low-lr phase sharpens heatmap peaks
        self.opt = Adam(dict(self.net.named_parameters()),
                        cosine_decay(lr, steps, alpha=0.1))
        self.rng = np.random.default_rng(seed + 1)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        self.render_s = self.net_s = 0.0
        self.err = None

    def sample(self) -> Dict[str, torch.Tensor]:
        return to_device(_sample_params(self.rng, self.head, self.batch), self.device)

    def step(self) -> float:
        t0 = time.perf_counter()
        img, px = self.render(self.sample())
        img, px = crop_augment(self.gen, img, px)
        img = augment_image(self.gen, img)
        hm_t = heatmap_targets(px)
        _sync(self.device)
        t1 = time.perf_counter()
        loss = fan_step(self.net, self.opt, img, hm_t)
        _sync(self.device)
        self.render_s += t1 - t0
        self.net_s += time.perf_counter() - t1
        return float(loss)

    def finalize(self) -> Dict:
        """The trained tree with BN statistics baked on 16 batches of
        detector-geometry crops (batch-1 inference parity)."""
        params = fan_params_from_torch(self.net.state_dict(), self.meta)

        def stat_batches():
            for _ in range(16):
                img, px = self.render(self.sample())
                yield crop_augment(self.gen, img, px)[0].cpu().numpy()
        return fan.finalize_bn_stats(params, stat_batches(), self.device)

    def evaluate(self, params: Dict) -> float:
        """Mean pixel error on held-out renders at batch 1 from the stored
        statistics: exactly what the detector runs."""
        net = fan.FAN.from_params(params, self.device)
        errs = []
        for _ in range(4):
            img, px = self.render(self.sample())
            for b in range(self.batch):
                with torch.no_grad(), fan.full_float32():
                    hm = net(img[b:b + 1].permute(0, 3, 1, 2))[-1][0].cpu().numpy()
                pred = fan.heatmaps_to_landmarks(
                    hm, np.array([IMG_SIZE / 2, IMG_SIZE / 2]), IMG_SIZE / 200.0)
                errs.append(np.linalg.norm(pred - px[b].cpu().numpy(), axis=-1).mean())
        return float(np.mean(errs))

    def run(self, out_path, log_every: int = 100) -> "FanTrainer":
        t0 = time.time()
        for i in range(self.steps):
            loss = self.step()
            if i % log_every == 0 or i == self.steps - 1:
                logger.info(f"step {i}: loss {loss:.5f} ({time.time() - t0:.0f}s)")
        params = self.finalize()
        self.err = self.evaluate(params)
        logger.info(f"held-out mean landmark error: {self.err:.2f} px @ {IMG_SIZE}px "
                    "(batch-1, stored BN stats)")
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        fan.save_fan_params(str(out_path), params)
        logger.info(f"saved {out_path}")
        return self


def train(steps: int = 1500, batch: int = 8, seed: int = 0,
          out_path: str = DEFAULT_OUT, feats: int = 64, num_modules: int = 1,
          depth: int = 3, lr: float = 2.5e-4, log_every: int = 100,
          device=None) -> float:
    """Train, bake, evaluate and save; the held-out error in pixels."""
    return FanTrainer(batch, seed, feats, num_modules, depth, lr, steps,
                      device).run(out_path, log_every).err


def main(argv=None) -> FanTrainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--feats", type=int, default=64)
    ap.add_argument("--num_modules", type=int, default=1)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    trainer = FanTrainer(args.batch, args.seed, args.feats, args.num_modules,
                         args.depth, args.lr, args.steps, args.device)
    trainer.run(args.out)
    print(f"RESULT: err={trainer.err:.2f}px")
    return trainer


if __name__ == "__main__":
    main()
