"""Seeding, the port's copy of ``tpureg/utils/seeding.py``.

``seed_everything`` seeds the host generators (Python's and numpy's, which
the data split and shuffles use) and torch's default generators. Device
randomness takes explicit ``torch.Generator``s seeded with ``derive_seed``.
"""

from __future__ import annotations

import itertools
import random
from typing import Iterator

import numpy as np
import torch

__all__ = ["seed_everything", "derive_seed", "key_seq"]


def seed_everything(seed: int = 1) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def derive_seed(*entropy: int) -> int:
    """A 63-bit seed mixed from integers (root seed, split, epoch, batch),
    the port's stand-in for ``jax.random.fold_in``."""
    return int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def key_seq(seed: int) -> Iterator[int]:
    """Infinite iterator of fresh seeds from a root seed (``derive_seed`` of
    the root and a counter), the port's counterpart of tpureg's iterator of
    split PRNG keys."""
    for i in itertools.count():
        yield derive_seed(seed, i)
