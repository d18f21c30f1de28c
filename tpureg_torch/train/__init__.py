from .checkpoint import best_weight_path, load_best_weights, save_best_weights
from .steps import (
    cast_floats,
    default_loss_kwargs,
    loss_from_outputs,
    make_eval_step,
    set_fp32_numerics,
)

__all__ = [
    "best_weight_path",
    "load_best_weights",
    "save_best_weights",
    "cast_floats",
    "default_loss_kwargs",
    "loss_from_outputs",
    "make_eval_step",
    "set_fp32_numerics",
]
