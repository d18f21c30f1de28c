"""Synthetic random batches for smoke runs, the counterpart of
``random_pair_batch`` in ``tpureg/data/synth.py`` and of the volume batches
of ``tpureg/cli/train_affine.py::synthetic_volumes``."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["random_pair_batch", "random_volume_batch"]


def random_pair_batch(batch_size: int = 8, size: int = 256,
                      generator: Optional[torch.Generator] = None,
                      device=None):
    """[B, H, W, 2] fixed/moving pair batch, U(0, 1), drawn from
    ``generator`` (on its device) or on ``device``."""
    if generator is not None:
        device = generator.device
    return torch.rand((batch_size, size, size, 2), device=device,
                      generator=generator)


def random_volume_batch(batch_size: int = 2, size=(176, 256, 256),
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """[B, D, H, W, 2] fixed/moving volume batch, U(0, 1), drawn from
    ``generator`` (on its device) or on ``device``."""
    if generator is not None:
        device = generator.device
    return torch.rand((batch_size, *size, 2), device=device, generator=generator)
