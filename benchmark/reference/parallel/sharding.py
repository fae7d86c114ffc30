"""One process: the reference computes the whole batch itself, so every
collective the copied energy names is the identity."""

from __future__ import annotations

from typing import Dict

import torch


def is_distributed() -> bool:
    return False


def world() -> int:
    return 1


def rank() -> int:
    return 0


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    return x


def all_reduce_grads(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return grads
