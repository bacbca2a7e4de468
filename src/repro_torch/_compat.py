"""Device and shape helpers shared by the port's modules (the twin of
``repro/kernels/pltpu_compat.py``'s ``ceil_to``; the Pallas shims have no
counterpart on the GPU)."""
from __future__ import annotations

from typing import Optional, Union

import torch


def ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when CUDA is asked for (explicitly or by default) and there is
    none, so a missing card is never silently replaced by the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def is_hopper() -> bool:
    """True when the current CUDA device is a Hopper part (sm_90)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0))
