"""Device selection for the port's entry points."""

from __future__ import annotations

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
