"""Device selection for the port's entry points, and constants on a device."""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point computes on.

    None means the CUDA card. Without one this raises instead of carrying on
    on the CPU: a CPU run must be asked for with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, built once per
    (values, dtype, device) and shared: callers read it and never write it.
    values: a number or (nested) sequence of numbers. A step that takes its
    fixed tensors from here copies nothing from the host after its first
    call, so it has no host sync and a CUDA graph can capture it."""
    return _constant(_frozen(values), dtype, torch.device(device))


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return float(values)


@functools.lru_cache(maxsize=None)
def _constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)
