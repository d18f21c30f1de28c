"""Process groups and tpureg's sharding rules, the counterpart of
``tpureg/parallel/mesh.py``.

tpureg builds a ``('data', 'spatial')`` mesh and lets XLA insert the
collectives: its train step over batches sharded on ``'data'`` is one
program over the global batch, so every reduction in it (the loss's sums
and Pearson, BatchNorm's statistics, the gradient) is over the global
batch, whichever device holds the rows. The port runs one process a card
(``torchrun``), each holding its rows of the global batch; the steps reduce
across the processes with the pieces here:

- ``rank_and_world(group)``: this process's rank and the group's size, 0 and
  1 without a process group; ``spans_ranks(group)``: whether the group holds
  more than one process;
- ``init_from_env(device, backend=None)``: joins the process group that
  ``torchrun``'s environment describes, NCCL for a CUDA device and gloo for
  the CPU unless ``backend`` names another (``chip_smoke.py`` names gloo for
  two ranks on one card, which NCCL refuses);
- ``fsdp_param_dim(shape, n)``: tpureg's FSDP rule (``fsdp_param_sharding``)
  on a shape, which shards parameters of ``FSDP_MIN_SIZE`` elements or more;
  ``flax_dims(module, name)``: where a port parameter's dimensions sit in
  tpureg's flax layout, so that the rule, whose ties go to the lower flax
  dimension, picks the same dimension of the same weight;
- ``local_rows(n, world, rank, accum_steps)``: the rows of a global batch
  that a rank holds, in tpureg's microbatch order;
- ``all_sum(x, group)``: an all-reduce of sums that autograd
  differentiates: its backward is the all-reduce of the cotangents.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["rank_and_world", "spans_ranks", "init_from_env", "FSDP_MIN_SIZE",
           "fsdp_param_dim", "flax_dims", "local_rows", "all_sum"]

# tpureg's FSDP threshold (mesh.py:75-104): smaller parameters are replicated
FSDP_MIN_SIZE = 2**16


def rank_and_world(group=None) -> Tuple[int, int]:
    """(rank, size) of ``group`` (the default group when None), or (0, 1)
    when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def spans_ranks(group) -> bool:
    """True when ``group`` is given and holds more than one process: the
    reductions over the batch then cross processes."""
    return group is not None and dist.get_world_size(group) > 1


def init_from_env(device, backend: Optional[str] = None) -> torch.device:
    """Join the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return the device this rank runs on: the card
    ``LOCAL_RANK`` for a CUDA ``device``, else ``device``. The backend is
    NCCL for a CUDA device and gloo for the CPU; another is used only where
    ``backend`` names it. Raises when the environment names no group."""
    device = torch.device(device)
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"no process group to join: {', '.join(missing)} not "
                           "set (launch with torchrun)")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://")
    return device


def fsdp_param_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """tpureg's FSDP rule (``fsdp_param_sharding``, mesh.py:75-104) on a
    shape in tpureg's layout: a parameter of ``FSDP_MIN_SIZE`` elements or more
    is sharded on its largest dimension that ``n`` divides, the dimensions
    taken by size with a stable sort (on a tie the lower index wins); None
    (replicated) for every other parameter."""
    size = 1
    for s in shape:
        size *= int(s)
    if size < FSDP_MIN_SIZE:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0:
            return d
    return None


def flax_dims(module: nn.Module, name: str) -> Tuple[int, ...]:
    """The port dimension of each dimension of parameter ``name`` of
    ``module`` in tpureg's flax layout (the 2-D weight bridge's,
    ``compat/from_jax.py``): convolution kernels HWIO → OIHW,
    transposed-convolution kernels (kh, kw, in, out) → (in, out, kh, kw);
    every other parameter as it is."""
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return (2, 3, 0, 1)
    if name == "weight" and isinstance(module, nn.Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(getattr(module, name).dim()))


def local_rows(n: int, world: int, rank: int, accum_steps: int = 1) -> torch.Tensor:
    """The rows of a global batch of ``n`` that ``rank`` of ``world`` holds,
    in tpureg's microbatch order: microbatch k is the global rows
    k·n/A … (k+1)·n/A − 1 (tpureg steps.py:186), and the rank holds the
    r-th of ``world`` equal parts of each, so that the rank's own
    ``accum_steps`` split gives it its part of every global microbatch.
    Raises unless ``world`` divides a microbatch."""
    if n % accum_steps or (n // accum_steps) % world:
        raise ValueError(f"a batch of {n} in {accum_steps} microbatches does not "
                         f"split over {world} ranks")
    m = n // accum_steps
    part = m // world
    rows = torch.arange(n).reshape(accum_steps, world, part)
    return rows[:, rank].reshape(-1)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank. Autograd
    differentiates it: each rank's cotangents are summed over the ranks in
    the backward, so with each rank's loss a share of the global one, the
    gradient each rank finds is its share of the global gradient."""
    return _AllSum.apply(x, group)
