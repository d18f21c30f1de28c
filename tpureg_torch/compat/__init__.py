from .from_jax import (
    load_adam_state_from_jax,
    state_dict_from_jax,
    state_dict_from_jax_3d,
)

__all__ = ["load_adam_state_from_jax", "state_dict_from_jax",
           "state_dict_from_jax_3d"]
