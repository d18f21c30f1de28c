"""Running-average meters for host-side metric accumulation, copied from
``tpureg/utils/meters.py`` (reference utils.py:130-153): tracks
val/sum/count/avg and optionally keeps every sample.
"""

from __future__ import annotations


class AverageMeter:
    """Tracks the latest value, running sum, count and mean.

    Mirrors reference utils.py:130-153, including the optional ``data`` list of
    all updates (used by inference.py:84 for per-step "single" scalars).
    """

    def __init__(self, keep_all: bool = True):
        self.data = [] if keep_all else None
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1) -> None:
        value = float(value)
        if self.data is not None:
            self.data.append(value)
        self.val = value
        self.sum += value * n
        self.count += n
        self.avg = self.sum / self.count

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"AverageMeter(val={self.val:.4g}, avg={self.avg:.4g}, n={self.count})"
