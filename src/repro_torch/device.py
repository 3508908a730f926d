"""Device resolution for the port's entry points.

``None`` means the CUDA card. A call that did not ask for the CPU on a host
without a CUDA device raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch entry points run on the card; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
