"""make_train_step's Adam on device scalars against the same step on host
scalars, on any device: tests/test_torch_train.py runs it on the CPU,
tests/test_torch_kernels_cuda.py on the card."""

import numpy as np
import torch

from vhap_tpu_torch.config.base import BaseTrackingConfig
from vhap_tpu_torch.tracker import optim as TO


def check_adam_on_device(device, lr_scale: float):
    """make_train_step (the count on the device, the bias corrections read
    by it from optim.bias_corrections, each leaf's lr a float32 device
    scalar) against the step written on host scalars, as the plain version
    writes it (optax's float32 1 - beta**count and the lr
    (-lr_map[k] * lr_scale) * lr_factor as Python floats): the parameters
    bit-identical after each step, the moments every 100 steps and across
    the table's end, over counts 1-3,000 and 20 counts across the end
    (where both corrections reach 1), the lr factor running through
    float32(0.9 ** e), e = 0-39."""
    steps, shapes = 3000, {"expr": (4, 10), "translation": (4, 3)}
    lr_map = TO.leaf_learning_rates(BaseTrackingConfig())
    leaves = frozenset(shapes)
    rng = np.random.default_rng(0)
    params = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32), device=device)
              for k, s in shapes.items()}
    # gradients of mixed scales, some exactly 0 (the energy's gradient is G)
    Gs = [{k: torch.as_tensor((rng.normal(size=s) * 10.0 ** rng.uniform(-6, 2, s)
                               * (rng.uniform(size=s) > 0.1)).astype(np.float32),
                              device=device)
           for k, s in shapes.items()} for _ in range(50)]

    def energy(p, G, gen):
        E = sum(torch.sum(p[k] * G[k]) for k in leaves)
        return E, ({"total": E}, {})

    init, step = TO.make_train_step(energy, leaves, lr_map, lr_scale)
    got, state = params, init(params)
    ref = dict(params)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    one, b1, b2 = np.float32(1), np.float32(TO.BETA1), np.float32(TO.BETA2)
    # counts 1-3,000, then 20 across the table's end (where both reach 1)
    end = TO.bias_corrections(torch.device(device)).shape[0]
    counts = list(range(1, steps + 1)) + list(range(end - 10, end + 10))
    for i, count in enumerate(counts):
        if count == end - 10:
            state["count"].fill_(count - 1)
        factor = float(np.float32(0.9 ** (min(i, steps - 1) * 40 // steps)))
        G = Gs[i % len(Gs)]
        got, state, _, _ = step(got, state, G, None, factor)
        c1 = float(one - b1 ** np.float32(count))
        c2 = float(one - b2 ** np.float32(count))
        for k, g in G.items():
            mu[k] = (1 - TO.BETA1) * g + TO.BETA1 * mu[k]
            nu[k] = (1 - TO.BETA2) * (g * g) + TO.BETA2 * nu[k]
            update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + TO.EPS)
            ref[k] = ref[k] + (-lr_map[k] * lr_scale) * factor * update
            assert torch.equal(got[k], ref[k]), (count, k)
            if count % 100 == 0 or count >= end - 10:
                assert torch.equal(state["mu"][k], mu[k]), (count, k)
                assert torch.equal(state["nu"][k], nu[k]), (count, k)
    assert state["count"].dtype == torch.int64 and int(state["count"]) == end + 9
