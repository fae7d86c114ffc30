"""Per-leaf Adam with stage-dependent optimizable subsets.

Counterpart of vhap_tpu/tracker/optim.py (reference: the torch param
groups of vhap/model/tracker.py:159-211): a leaf -> learning-rate map
applied after Adam's bias-corrected update; the per-epoch ExponentialLR of
the global stage is the step's `lr_factor` argument.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

from vhap_tpu_torch.config.base import BaseTrackingConfig
from vhap_tpu_torch.parallel import sharding
from vhap_tpu_torch.tracker import params as P
from vhap_tpu_torch.util.profiling import span

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8   # torch.optim.Adam's defaults


def leaf_learning_rates(cfg: BaseTrackingConfig) -> Dict[str, float]:
    """Leaf name -> lr (group table at vhap/model/tracker.py:171-202)."""
    lr = cfg.lr
    return {
        "shape": lr.base,
        "rotation": lr.base,
        "neck_pose": lr.base,
        "jaw_pose": lr.base,
        "eyes_pose": lr.base,
        "tex_pca": lr.base,
        "tex_extra": lr.base,
        "translation": lr.translation,
        "expr": lr.expr,
        "lights": lr.light,
        "focal_length": lr.camera,
        "static_offset": lr.static_offset,
        "dynamic_offset": lr.dynamic_offset,
    }


def stage_optimizable_leaves(cfg: BaseTrackingConfig, stage_name: str,
                             params: P.Params) -> FrozenSet[str]:
    """optimizable_params groups -> parameter leaves
    (get_train_parameters, vhap/model/tracker.py:1465-1513)."""
    opt = set(cfg.pipeline[stage_name].optimizable_params)
    leaves = set()
    if "cam" in opt and not cfg.data.calibrated and "focal_length" in params:
        leaves.add("focal_length")
    if "shape" in opt:
        leaves.add("shape")
    if "texture" in opt:
        if not cfg.model.tex_painted and "tex_pca" in params:
            leaves.add("tex_pca")
        if cfg.model.tex_extra and "tex_extra" in params:
            leaves.add("tex_extra")
    if "static_offset" in opt and "static_offset" in params:
        leaves.add("static_offset")
    if "lights" in opt and "lights" in params:
        leaves.add("lights")
    if "pose" in opt:
        leaves.update(("translation", "rotation"))
    if "joints" in opt:
        leaves.update(("eyes_pose", "neck_pose", "jaw_pose"))
    if "expr" in opt:
        leaves.add("expr")
    if "dynamic_offset" in opt and "dynamic_offset" in params:
        leaves.add("dynamic_offset")
    return frozenset(leaves)


def loss_and_grads(energy_fn: Callable, params: P.Params,
                   opt_leaves: FrozenSet[str], batch: Dict,
                   generator: torch.Generator):
    """(E, log, grads): the energy and the gradients of the optimizable
    leaves only; the frozen leaves enter as constants, and a leaf the
    energy does not reach has gradient 0 (as in JAX). Under a process
    group E and log are this rank's shares of the batch's (their sum over
    ranks) and the gradients are summed over ranks (one all-reduce), so
    they are the batch's on every rank."""
    opt_keys = sorted(opt_leaves)
    opt_params = {k: params[k].detach().requires_grad_(True) for k in opt_keys}
    frozen = {k: v for k, v in params.items() if k not in opt_leaves}
    with span("step.forward"):
        E, (log, _aux) = energy_fn({**frozen, **opt_params}, batch, generator)
    with span("step.backward"):
        grads = torch.autograd.grad(E, [opt_params[k] for k in opt_keys],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(opt_params[k]) if g is None else g
                 for k, g in zip(opt_keys, grads)}
        grads = sharding.all_reduce_grads(grads)
    log = {k: v.detach() for k, v in log.items()}
    return E.detach(), log, grads


@functools.lru_cache(maxsize=None)
def bias_corrections(device) -> torch.Tensor:
    """(n, 2) float32 on `device`, built once per device: row c holds Adam's
    bias corrections (1 - BETA1**c, 1 - BETA2**c) at count c, formed in
    float32 as optax forms them (1 - 0.999 in float32 is 1.3e-5 off its
    exact value, which moves the first steps' update by 6e-6 relative), in
    the form in which the device divides a tensor by a host scalar: CUDA
    multiplies by the scalar's float32 reciprocal, so there the rows hold
    the reciprocals (count 0's, never read, is inf); the CPU divides. The
    step then gives the bits of one that divides by the corrections as
    Python floats, as the plain version does. The rows end where both
    reach 1, which they keep at every larger count."""
    one, b1, b2 = np.float32(1.0), np.float32(BETA1), np.float32(BETA2)
    rows, count = [], 0
    while not rows or rows[-1] != (one, one):
        rows.append((one - b1 ** np.float32(count), one - b2 ** np.float32(count)))
        count += 1
    table = np.asarray(rows, np.float32)
    if torch.device(device).type == "cuda":
        with np.errstate(divide="ignore"):
            table = one / table
    return torch.tensor(table, device=device)


def adam_update(grads: Dict[str, torch.Tensor], state: Dict, out: Optional[Dict] = None):
    """One bias-corrected Adam direction per leaf (optax.scale_by_adam,
    betas (0.9, 0.999), eps 1e-8, eps_root 0) -> (updates, new state).
    state["count"] is an int64 scalar on the leaves' device, and the bias
    corrections are read by it from `bias_corrections` on the device, so a
    step reads nothing from the host and copies nothing to the device (a
    CUDA graph can capture it). out: {"count", "mu", "nu"} tensors of the
    new state's shapes to write the new state into (None: new tensors)."""
    o = out or {}
    count = torch.add(state["count"], 1, out=o.get("count"))
    table = bias_corrections(count.device)
    row = torch.clamp(count, max=table.shape[0] - 1).reshape(1)
    c1, c2 = table.index_select(0, row)[0].unbind()
    divide = torch.mul if table.is_cuda else torch.div     # bias_corrections' form
    mu = {k: torch.add((1 - BETA1) * g, BETA1 * state["mu"][k],
                       out=o["mu"][k] if out else None) for k, g in grads.items()}
    nu = {k: torch.add((1 - BETA2) * (g * g), BETA2 * state["nu"][k],
                       out=o["nu"][k] if out else None) for k, g in grads.items()}
    updates = {k: divide(mu[k], c1) / (torch.sqrt(divide(nu[k], c2)) + EPS)
               for k in grads}
    return updates, {"count": count, "mu": mu, "nu": nu}


def make_train_step(
    energy_fn: Callable,
    opt_leaves: FrozenSet[str],
    lr_map: Dict[str, float],
    lr_scale: float = 1.0,
) -> Tuple[Callable, Callable]:
    """Returns (init_opt_state(params), step(params, opt_state, batch,
    generator, lr_factor=1.0) -> (params, opt_state, E, log)).

    Adam is plain tensor code on an explicit state dict (step count, first
    and second moments per optimizable leaf, as optax.scale_by_adam's; see
    `adam_update`), on whole (T, ...) leaves, so it equals the JAX
    package's optax.scale_by_adam + lr map step for step:
    p <- p + ((-lr_map[k] * lr_scale) * lr_factor) * update, the factor
    formed on the host and held as a float32 scalar on the device
    (`step.learning_rates`). The step returns a new params dict: optimizable
    leaves are new tensors, frozen leaves are the caller's tensors,
    untouched. With spans on (util/profiling.py) a step is the span `step`,
    holding `step.forward` (the energy), `step.backward` (its gradients)
    and `step.adam`.

    `step.body(params, opt_state, batch, generator, lr, out=None)` is the
    step's work without the `step` span, on the learning rates `lr` of
    `step.learning_rates`: -> (the optimizable leaves' new values, the new
    opt_state, E, log); out {"params", "count", "mu", "nu"} holds tensors
    to write the new values and state into. tracker/step_graph.py captures
    it as CUDA graphs. Its collectives are counted as one step's
    (sharding.step_collectives).
    """
    keys = sorted(opt_leaves)
    lr_base = {k: -lr_map[k] * lr_scale for k in keys}
    held: Dict[torch.device, list] = {}    # device -> [lr_factor, {leaf: lr}]

    def init_opt_state(params: P.Params) -> Dict:
        dev = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int64, device=dev),
                "mu": {k: torch.zeros_like(params[k]) for k in keys},
                "nu": {k: torch.zeros_like(params[k]) for k in keys}}

    def learning_rates(lr_factor: float, device) -> Dict[str, torch.Tensor]:
        """Each leaf's (-lr_map[k] * lr_scale) * lr_factor as a float32
        scalar on `device`: the same tensors at every call, filled again
        (a fill, no copy from the host) when lr_factor changes."""
        device = torch.device(device)
        if device not in held:
            held[device] = [None, {k: torch.empty((), dtype=torch.float32, device=device)
                                   for k in keys}]
        if held[device][0] != lr_factor:
            for k in keys:
                held[device][1][k].fill_(lr_base[k] * lr_factor)
            held[device][0] = lr_factor
        return held[device][1]

    def body(params: P.Params, opt_state: Dict, batch: Dict,
             generator: torch.Generator, lr: Dict[str, torch.Tensor],
             out: Optional[Dict] = None):
        with sharding.step_tally():
            E, log, grads = loss_and_grads(energy_fn, params, opt_leaves, batch,
                                           generator)
        with span("step.adam"), torch.no_grad():
            updates, opt_state = adam_update(grads, opt_state, out)
            new = {k: torch.add(params[k], lr[k] * updates[k],
                                out=out["params"][k] if out else None)
                   for k in updates}
        return new, opt_state, E, log

    def step(params: P.Params, opt_state: Dict, batch: Dict,
             generator: torch.Generator, lr_factor: float = 1.0):
        lr = learning_rates(lr_factor, opt_state["count"].device)
        with span("step"):
            new, opt_state, E, log = body(params, opt_state, batch, generator, lr)
        return {**params, **new}, opt_state, E, log

    step.body, step.learning_rates = body, learning_rates
    return init_opt_state, step
