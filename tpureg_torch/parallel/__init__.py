"""Data-parallel training across processes, the counterpart of
``tpureg/parallel/``: process groups, tpureg's sharding rules and the
differentiable all-reduce (``mesh.py``); tpureg's FSDP layout of a train
state, held by hand at the step's granularity (``fsdp.py``)."""

from .fsdp import ShardedParams, shard_train_state
from .mesh import (
    all_sum,
    flax_dims,
    fsdp_param_dim,
    init_from_env,
    local_rows,
    rank_and_world,
    spans_ranks,
)

__all__ = ["ShardedParams", "shard_train_state", "all_sum", "flax_dims",
           "fsdp_param_dim", "init_from_env", "local_rows", "rank_and_world",
           "spans_ranks"]
