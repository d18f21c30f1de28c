"""Learning-rate schedules, the counterpart of ``tpureg/train/schedule.py``.

The reference defines ``StepLR(step_size=40, gamma=0.8)`` (train.py:131-133)
but never calls ``scheduler.step()``, so its effective schedule is a constant
lr, which is the default here too.
"""

from __future__ import annotations

__all__ = ["step_decay_schedule"]


def step_decay_schedule(base_lr: float, step_size: int = 40,
                        gamma: float = 0.8, enabled: bool = False):
    """The constant ``base_lr`` unless ``enabled``; then the staircase
    ``step -> base_lr · gamma ** (step // step_size)`` over optimizer steps
    (optax's ``exponential_decay(..., staircase=True)``). The train state
    evaluates it at the count before the update, as optax does: the first
    update sees ``schedule(0)``."""
    if not enabled or step_size <= 0:
        return base_lr

    def schedule(step: int) -> float:
        return base_lr * gamma ** (step // step_size)

    return schedule
