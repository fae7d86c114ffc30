"""Train the matting U-Net on synthetic FLAME renders.

Counterpart of vhap_tpu/tools/train_matting_synthetic.py, the companion of
train_fan_synthetic.py for the monocular matting slot (reference:
RobustVideoMatting, vhap/preprocess_video.py:54-86): random FLAME heads are
rendered on the card's kernels (the FAN trainer's sampler and render,
under torch.no_grad()), composited over augmented backgrounds (solid
colours, gradients, noise textures; drawn on the host from a numpy
generator as in the JAX tool), and the port's U-Net (preprocess/matting.py)
learns the render's alpha under a sigmoid binary cross-entropy with
optax.adam's update. The tree is written in the npz layout both packages'
loaders read.

Usage: python -m vhap_tpu_torch.tools.train_matting_synthetic [--steps 1200]
           [--out vhap_tpu_torch/assets/matting_weights.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from vhap_tpu_torch.convert import unet_params_from_torch
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.preprocess.fan import full_float32, save_fan_params
from vhap_tpu_torch.preprocess.matting import UNet, init_unet_params
from vhap_tpu_torch.tools.train_fan_synthetic import (Adam, _sample_params, _sync,
                                                      build_head, render_heads,
                                                      to_device)
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

IMG_SIZE = 256
DEFAULT_OUT = "vhap_tpu_torch/assets/matting_weights.npz"


def _sample_backgrounds(rng, B):
    """Solid / vertical-gradient / noise-texture backgrounds (B, S, S, 3)."""
    kinds = rng.integers(0, 3, B)
    bgs = np.empty((B, IMG_SIZE, IMG_SIZE, 3), np.float32)
    for b in range(B):
        c0 = rng.uniform(0, 1, 3)
        if kinds[b] == 0:
            bgs[b] = c0
        elif kinds[b] == 1:
            c1 = rng.uniform(0, 1, 3)
            t = np.linspace(0, 1, IMG_SIZE)[:, None, None]
            bgs[b] = c0 * (1 - t) + c1 * t
        else:
            coarse = rng.uniform(0, 1, (8, 8, 3))
            from PIL import Image
            bgs[b] = np.asarray(Image.fromarray(
                (coarse * 255).astype(np.uint8)).resize(
                    (IMG_SIZE, IMG_SIZE), Image.BILINEAR), np.float32) / 255.0
    return bgs


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def matting_step(net: UNet, opt: Adam, img: torch.Tensor,
                 alpha_t: torch.Tensor) -> torch.Tensor:
    """One training step on (B, S, S, 3) images and (B, S, S) alpha targets;
    returns the loss."""
    with full_float32():
        logit = net(img.permute(0, 3, 1, 2))[:, 0]
        loss = torch.mean(sigmoid_binary_cross_entropy(logit, alpha_t))
        grads = torch.autograd.grad(loss, list(opt.params.values()))
    opt.step(dict(zip(opt.params, grads)))
    return loss.detach()


class MattingTrainer:
    """The tool's run; `render_s` and `net_s` as FanTrainer's."""

    def __init__(self, batch: int = 8, seed: int = 0, lr: float = 4e-4,
                 steps: int = 1200, device=None):
        self.device = resolve_device(device)
        self.batch, self.steps = batch, steps
        self.head, self.tex, self.verts_uv = build_head(self.device)
        params = init_unet_params(torch.Generator().manual_seed(seed))
        self.meta = params["meta"]
        self.net = UNet.from_params(params, self.device)
        self.opt = Adam(dict(self.net.named_parameters()), lambda count: lr)
        self.rng = np.random.default_rng(seed + 1)
        self.render_s = self.net_s = 0.0
        self.err = None

    def render(self, p: Dict[str, torch.Tensor], bg: torch.Tensor):
        """-> (image over bg (B, S, S, 3), alpha target (B, S, S))."""
        rgb, alpha, _, _ = render_heads(self.head, self.tex, self.verts_uv, p)
        return rgb * alpha + bg * (1 - alpha), alpha[..., 0]

    def sample(self):
        p = to_device(_sample_params(self.rng, self.head, self.batch), self.device)
        bg = torch.as_tensor(_sample_backgrounds(self.rng, self.batch), device=self.device)
        return p, bg

    def step(self) -> float:
        t0 = time.perf_counter()
        img, alpha_t = self.render(*self.sample())
        _sync(self.device)
        t1 = time.perf_counter()
        loss = matting_step(self.net, self.opt, img, alpha_t)
        _sync(self.device)
        self.render_s += t1 - t0
        self.net_s += time.perf_counter() - t1
        return float(loss)

    def evaluate(self) -> float:
        """Mean |alpha - gt| on held-out renders."""
        errs = []
        for _ in range(4):
            img, alpha_t = self.render(*self.sample())
            with torch.no_grad(), full_float32():
                pred = torch.sigmoid(self.net(img.permute(0, 3, 1, 2)))[:, 0]
            errs.append(float((pred - alpha_t).abs().mean()))
        return float(np.mean(errs))

    def run(self, out_path, log_every: int = 100) -> "MattingTrainer":
        t0 = time.time()
        for i in range(self.steps):
            loss = self.step()
            if i % log_every == 0 or i == self.steps - 1:
                logger.info(f"step {i}: loss {loss:.4f} ({time.time() - t0:.0f}s)")
        self.err = self.evaluate()
        logger.info(f"held-out mean alpha error: {self.err:.4f}")
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        save_fan_params(str(out_path), unet_params_from_torch(self.net.state_dict(),
                                                              self.meta))
        logger.info(f"saved {out_path}")
        return self


def train(steps: int = 1200, batch: int = 8, seed: int = 0,
          out_path: str = DEFAULT_OUT, lr: float = 4e-4, log_every: int = 100,
          device=None) -> float:
    """Train, evaluate and save; the held-out mean |alpha - gt|."""
    return MattingTrainer(batch, seed, lr, steps, device).run(out_path, log_every).err


def main(argv=None) -> MattingTrainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    trainer = MattingTrainer(args.batch, args.seed, steps=args.steps,
                             device=args.device)
    trainer.run(args.out)
    print(f"RESULT: err={trainer.err:.4f}")
    return trainer


if __name__ == "__main__":
    main()
