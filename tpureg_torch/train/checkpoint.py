"""Best-validation weights as a ``torch.save`` file, in the workdir layout of
``tpureg/train/checkpoint.py`` (reference train.py:193-201):
``<root>/model_weight/Unsupervised/<Predictor>/best_weight.pt`` holding
``{"state_dict": model.state_dict(), "metrics": {...}}``. The per-epoch
training state comes with the training slice.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

__all__ = ["best_weight_path", "save_best_weights", "load_best_weights"]


def best_weight_path(root: str, predictor_name: str) -> str:
    return os.path.abspath(os.path.join(
        root, "model_weight", "Unsupervised", predictor_name, "best_weight.pt"))


def save_best_weights(root: str, predictor_name: str, model,
                      metrics: Dict[str, float]) -> str:
    path = best_weight_path(root, predictor_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": model.state_dict(),
                "metrics": {k: float(v) for k, v in metrics.items()}}, path)
    return path


def load_best_weights(root: str, predictor_name: str, model) -> Dict[str, float]:
    """Load the best weights into ``model`` (strictly); return their metrics."""
    payload = torch.load(best_weight_path(root, predictor_name),
                         map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"], strict=True)
    return payload["metrics"]
