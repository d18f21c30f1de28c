from .checkpoint import (
    best_weight_path,
    load_best_weights,
    restore_training_state,
    save_best_weights,
    save_training_state,
    training_state_path,
)
from .schedule import step_decay_schedule
from .state import TrainState, create_train_state
from .steps import (
    cast_params,
    default_loss_kwargs,
    loss_from_outputs,
    make_affine_train_step,
    make_deform3d_train_step,
    make_eval_step,
    make_flow_supervised_step,
    make_train_step,
    set_fp32_numerics,
    stn_inverse_target,
)

__all__ = [
    "best_weight_path",
    "load_best_weights",
    "restore_training_state",
    "save_best_weights",
    "save_training_state",
    "training_state_path",
    "step_decay_schedule",
    "TrainState",
    "create_train_state",
    "cast_params",
    "default_loss_kwargs",
    "loss_from_outputs",
    "make_affine_train_step",
    "make_deform3d_train_step",
    "make_eval_step",
    "make_flow_supervised_step",
    "make_train_step",
    "set_fp32_numerics",
    "stn_inverse_target",
]
