"""Training across processes, the counterpart of ``tpureg/parallel/``: on
the ``'data'`` axis, process groups, tpureg's sharding rules and the
differentiable all-reduce (``mesh.py``) and tpureg's FSDP layout of a train
state, held by hand at the step's granularity (``fsdp.py``); on the
``'spatial'`` axis (``--spatial_shards``), the ('data', 'spatial') grid of
ranks (``mesh.make_grid``) and the volume's H split over a data index's
spatial ranks: slabs, gathers, halos and slab convolutions
(``spatial.py``)."""

from .fsdp import ShardedParams, shard_train_state
from .mesh import (
    Grid,
    all_sum,
    flax_dims,
    fsdp_param_dim,
    grid_position,
    init_from_env,
    local_rows,
    make_grid,
    rank_and_world,
    spans_ranks,
    spatial_ranks,
)
from .spatial import HSplit

__all__ = ["ShardedParams", "shard_train_state", "Grid", "HSplit", "all_sum",
           "flax_dims", "fsdp_param_dim", "grid_position", "init_from_env",
           "local_rows", "make_grid", "rank_and_world", "spans_ranks", "spatial_ranks"]
