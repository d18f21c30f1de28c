"""Which device an entry point runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; raises when CUDA
    is asked for (or left as the default) and no card is present, rather
    than carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on "
                           "the CPU")
    return dev
