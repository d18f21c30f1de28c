"""Train state: the model, its Adam optimizer, the learning-rate schedule and
the step count. Counterpart of ``create_train_state`` in
``tpureg/train/state.py:84-118``.

Adam's hyperparameters are the reference's, including the quirk that ``eps``
is wired to the ``--lrMin`` flag (default 1e-4, train.py:129) rather than
torch's 1e-8. tpureg's ``flat_adam`` is not ported: it was measured as a loss
there (state.py:95-101).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
from torch import nn

__all__ = ["TrainState", "create_train_state"]

Schedule = Union[float, Callable[[int], float]]


@dataclass
class TrainState:
    """``model`` holds the parameters and the BatchNorm statistics,
    ``optimizer`` Adam's moments; ``step`` counts the updates taken.
    ``shards``: None, or the FSDP layout (``parallel.ShardedParams``) after
    ``parallel.shard_train_state``: the sharded parameters and their moments
    are then this rank's slices between steps."""

    model: nn.Module
    optimizer: torch.optim.Adam
    learning_rate: Schedule
    step: int = 0
    shards: Optional[object] = None

    def lr(self, step: int = None) -> float:
        """The learning rate the schedule gives at ``step`` (default: the
        next update's)."""
        step = self.step if step is None else step
        lr = self.learning_rate
        return float(lr(step) if callable(lr) else lr)

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' ``.grad`` at the schedule's
        value for the count before the update (optax's convention)."""
        lr = self.lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, learning_rate: Schedule = 1e-4,
                       adam_eps: float = 1e-4, b1: float = 0.9,
                       b2: float = 0.999) -> TrainState:
    """A ``TrainState`` around an initialised ``model`` (its parameters are
    the fp32 master weights) with ``torch.optim.Adam(betas=(b1, b2),
    eps=adam_eps)``. ``learning_rate`` is a float or a schedule of the step
    count (``train/schedule.py``)."""
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = torch.optim.Adam(model.parameters(), lr=lr0, betas=(b1, b2),
                           eps=adam_eps)
    return TrainState(model, opt, learning_rate)
