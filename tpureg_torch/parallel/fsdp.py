"""tpureg's FSDP layout of a train state (``fsdp_state_sharding``,
``tpureg/parallel/mesh.py:75-104``), held by hand at the step's granularity.

Each parameter of 2^16 elements or more is held on each rank as a 1/W slice
along the port's counterpart of the dimension tpureg's rule picks in its
flax layout (``mesh.fsdp_param_dim``, ``mesh.flax_dims``), and so are its
two Adam moments; every other parameter, the BatchNorm statistics and
Adam's step counts are replicated. A step gathers the full parameters
(``gathered``: all-gather, the slices joined along their dimension) for its
forward and backward, sums the gradients over the ranks and keeps each
rank's slice (``shard_grad``), and Adam then updates only the slices:
Adam is elementwise, so the numbers are the unsharded Adam's. Between steps
each rank holds only its slices.

Why not ``torch.distributed.fsdp.fully_shard``: the bf16 step casts every
parameter once a call, for ``torch.func.functional_call``, before any
module's forward hook could gather it; ``fully_shard`` averages the
gradients over the ranks, where the data-parallel step's rank losses are
shares whose gradients are summed; and placing shards on other dimensions
than the first (``shard_placement_fn``) is recent API. The gather at the
step's granularity needs ``all_gather`` and ``all_reduce`` only, which NCCL
and gloo both have.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import flax_dims, fsdp_param_dim, rank_and_world

__all__ = ["ShardedParams", "shard_train_state"]


class ShardedParams:
    """The sharded parameters of ``model`` over ``group`` (None: the default
    group, or this process alone where no group is initialised): ``dims``
    maps each sharded parameter to its dimension."""

    def __init__(self, model: nn.Module, group=None):
        self.collective = dist.is_available() and dist.is_initialized()
        self.group = group if group is not None or not self.collective \
            else dist.group.WORLD
        self.rank, self.world = rank_and_world(self.group)
        self.dims: Dict[nn.Parameter, int] = {}
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                flax = flax_dims(module, name)
                d = fsdp_param_dim([p.shape[t] for t in flax], self.world)
                if d is not None:
                    self.dims[p] = flax[d]

    def _slice(self, full, dim):
        k = full.shape[dim] // self.world
        return full.narrow(dim, self.rank * k, k).clone()

    def _gather(self, part, dim):
        if not self.collective:
            return part
        parts = [torch.empty_like(part) for _ in range(self.world)]
        dist.all_gather(parts, part.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    @staticmethod
    def _moments(optimizer, p, shape):
        """The keys of ``optimizer``'s state tensors of ``p`` shaped ``shape``
        (Adam's moments; its 0-d step count is replicated)."""
        if optimizer is None:
            return []
        state = optimizer.state.get(p, {})
        return [k for k, v in state.items()
                if torch.is_tensor(v) and v.dim() and v.shape == shape]

    def shard_(self, optimizer: Optional[torch.optim.Optimizer] = None) -> None:
        """Replace each sharded parameter held whole, and its moments in
        ``optimizer``, by this rank's slice."""
        for p, dim in self.dims.items():
            for k in self._moments(optimizer, p, p.shape):
                optimizer.state[p][k] = self._slice(optimizer.state[p][k], dim)
            p.data = self._slice(p.data, dim)

    @contextlib.contextmanager
    def gathered(self, optimizer: Optional[torch.optim.Optimizer] = None):
        """The full parameters (and, with ``optimizer``, their moments) for
        the duration, on every rank; afterwards each rank keeps its slice of
        what they hold then, so a load inside the block is sharded on exit.
        Gradients of the sharded parameters are dropped on entry."""
        for p, dim in self.dims.items():
            for k in self._moments(optimizer, p, p.shape):
                optimizer.state[p][k] = self._gather(optimizer.state[p][k], dim)
            p.grad = None
            p.data = self._gather(p.data, dim)
        try:
            yield
        finally:
            self.shard_(optimizer)

    def shard_grad(self, p: nn.Parameter, grad: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full gradient ``grad`` of ``p`` (already
        summed over the ranks); ``grad`` itself for a replicated ``p``."""
        dim = self.dims.get(p)
        return grad if dim is None else self._slice(grad, dim)


def shard_train_state(state, group=None):
    """Shard ``state`` (``train/state.py``'s ``TrainState``) by tpureg's rule
    over ``group``: its parameters and Adam's moments, held whole until now,
    become this rank's slices, and ``state.shards`` the layout the steps and
    checkpoints follow. Returns ``state``."""
    if state.shards is not None:
        raise ValueError("the train state is already sharded")
    shards = ShardedParams(state.model, group)
    shards.shard_(state.optimizer)
    state.shards = shards
    return state
