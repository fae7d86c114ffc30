"""The tracker's train step, set up as the bench sets it up.

One `rgb_sequential_tracking` step (render -> energy with every regularizer
of the stage and the cluster disturbance -> backward -> leaf-lr Adam) on
the evaluation slice's scene (tools/eval_slice.py): the bench's full width
by default (bench.py:113-171: batch 16, 512x512, texture 2048,
n_shape=300, n_expr=100, SH lighting, antialias, residual texture, static
offset, 64 timesteps), targets rendered from perturbed parameters on white,
rendered landmarks, every random number of the setup from one numpy seed.
The disturbance runs at the config's defaults (rates 0.5 / 0.5, pool
stride 4). Used by chip_smoke.py and tools/profile_eval.py; the tests build
it at a tiny size on the CPU.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Tuple

import torch

from vhap_tpu_torch.tools.eval_slice import N_TIMESTEPS, EvalSlice, build_eval_slice
from vhap_tpu_torch.tracker.energy import make_energy_fn
from vhap_tpu_torch.tracker.optim import (leaf_learning_rates, make_train_step,
                                          stage_optimizable_leaves)

STAGE = "rgb_sequential_tracking"


@dataclass
class TrainSlice:
    eval: EvalSlice
    stage: str
    opt_leaves: FrozenSet[str]
    lr_map: Dict[str, float]
    make_energy: Callable   # (use_kernels, disturb) -> energy(params, batch, gen)

    def make_step(self, use_kernels: bool = True, disturb: bool = True
                  ) -> Tuple[Callable, Callable]:
        """(init_opt_state, step) of make_train_step on this slice's energy."""
        return make_train_step(self.make_energy(use_kernels, disturb),
                               self.opt_leaves, self.lr_map)

    def generator(self, seed: int = 0) -> torch.Generator:
        """A generator on the slice's device, for the disturbance."""
        return torch.Generator(device=self.eval.params["shape"].device).manual_seed(seed)


def build_train_slice(device=None, batch_size: int = 16,
                      image_size: Tuple[int, int] = (512, 512),
                      tex_res: int = 2048, n_shape: int = 300,
                      n_expr: int = 100, seed: int = 0,
                      stage: str = STAGE) -> TrainSlice:
    s = build_eval_slice(device=device, batch_size=batch_size,
                         image_size=image_size, tex_res=tex_res,
                         n_shape=n_shape, n_expr=n_expr, seed=seed)
    dev = s.params["shape"].device

    def make_energy(use_kernels: bool = True, disturb: bool = True):
        cfg = s.cfg
        if not disturb:
            cfg = copy.deepcopy(cfg)
            cfg.render.disturb_rate_fg = cfg.render.disturb_rate_bg = None
        return make_energy_fn(s.head, cfg, s.get_albedo, s.image_size,
                              N_TIMESTEPS, stage, with_aux=False, device=dev,
                              use_kernels=use_kernels)

    return TrainSlice(s, stage, stage_optimizable_leaves(s.cfg, stage, s.params),
                      leaf_learning_rates(s.cfg), make_energy)
