"""Two-tier checkpoints as ``torch.save`` files, in the workdir layout of
``tpureg/train/checkpoint.py`` (reference train.py:183-201):

- ``<root>/Checkpoints/Unsupervised/<Predictor>/training_state.pt``: every
  epoch, the resumable state ``{epoch, best_loss, model, optimizer, step}``
  (model and optimizer as their state dicts); resume picks it up when
  present and starts at the epoch after the saved one;
- ``<root>/model_weight/Unsupervised/<Predictor>/best_weight.pt``: the
  weights and their metrics whenever validation improves,
  ``{"state_dict": model.state_dict(), "metrics": {...}}``; inference loads
  this file.

Under FSDP (``TrainState.shards``) ``save_training_state`` gathers the full
parameters and moments on every rank and rank 0 alone writes them, in the
single-process format, and ``restore_training_state`` loads a file into the
full tensors and keeps each rank's slices: a file written under FSDP
restores without it, and the other way round.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Tuple

import torch

__all__ = ["best_weight_path", "save_best_weights", "load_best_weights",
           "training_state_path", "save_training_state",
           "restore_training_state"]


def best_weight_path(root: str, predictor_name: str) -> str:
    return os.path.abspath(os.path.join(
        root, "model_weight", "Unsupervised", predictor_name, "best_weight.pt"))


def training_state_path(root: str, predictor_name: str) -> str:
    return os.path.abspath(os.path.join(
        root, "Checkpoints", "Unsupervised", predictor_name,
        "training_state.pt"))


def _save(path: str, payload) -> None:
    """Write through a temporary file, so a reader never sees half a file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def save_best_weights(root: str, predictor_name: str, model,
                      metrics: Dict[str, float]) -> str:
    path = best_weight_path(root, predictor_name)
    _save(path, {"state_dict": model.state_dict(),
                 "metrics": {k: float(v) for k, v in metrics.items()}})
    return path


def load_best_weights(root: str, predictor_name: str, model) -> Dict[str, float]:
    """Load the best weights into ``model`` (strictly); return their metrics."""
    payload = torch.load(best_weight_path(root, predictor_name),
                         map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"], strict=True)
    return payload["metrics"]


def _whole(state):
    """The full parameters and moments of ``state`` for the duration (every
    rank gathers under FSDP)."""
    if state.shards is None:
        return contextlib.nullcontext()
    return state.shards.gathered(state.optimizer)


def save_training_state(root: str, predictor_name: str, state, epoch: int,
                        best_loss: float) -> str:
    path = training_state_path(root, predictor_name)
    with _whole(state):
        if state.shards is None or state.shards.rank == 0:
            _save(path, {"epoch": epoch, "best_loss": float(best_loss),
                         "model": state.model.state_dict(),
                         "optimizer": state.optimizer.state_dict(),
                         "step": int(state.step)})
    return path


def restore_training_state(root: str, predictor_name: str, state
                           ) -> Optional[Tuple[object, int, float]]:
    """Load the saved training state into ``state`` (model, optimizer and
    step count); return ``(state, starting_epoch, best_loss)`` with
    ``starting_epoch`` = saved epoch + 1 (train.py:155), or None when no
    checkpoint exists."""
    path = training_state_path(root, predictor_name)
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    with _whole(state):
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]) + 1, float(payload["best_loss"])
