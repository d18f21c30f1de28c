"""Seeding, the port's copy of ``tpureg/utils/seeding.py``.

``seed_everything`` seeds the host generators (Python's and numpy's, which
the data split and shuffles use) and torch's default generators. Device
randomness takes explicit ``torch.Generator``s seeded with ``derive_seed``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["seed_everything", "derive_seed"]


def seed_everything(seed: int = 1) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def derive_seed(*entropy: int) -> int:
    """A 63-bit seed mixed from integers (root seed, split, epoch, batch),
    the port's stand-in for ``jax.random.fold_in``."""
    return int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
