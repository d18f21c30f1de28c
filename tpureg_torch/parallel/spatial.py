"""The volume's H split across ranks, the counterpart of what GSPMD inserts
for tpureg's 3-D step over a batch placed with
``spatial_sharding(mesh, 5, axis=2)`` (``tpureg/parallel/mesh.py:59-68``):
halo exchanges for the convolutions, gathers for the warps and the Dense
layer, and reductions for the loss, so that the step's results are the
unsharded step's on the whole volume.

``HSplit(group, index, shards)``: rank ``index`` of the ``shards`` ranks of
``group`` (a data index's spatial group, ``mesh.make_grid``) holds rows
[index·H/S, (index+1)·H/S) of the H of every NCDHW tensor it is given.
Every collective here is ``all_sum``, an all-reduce (gloo on CUDA tensors
does broadcast and all-reduce only), and autograd differentiates it:

- ``gather(x)``: the whole H, as ``all_sum`` of the slab zero-padded to it;
  adding zeros is exact, so the result is the unsharded tensor bit for bit.
  Its backward sums the cotangents over the ranks and slices each rank's
  rows: the reduce-scatter that a warp's volume cotangent needs.
- ``halo(x, above, below)``: the slab with ``above`` rows of the rank above
  and ``below`` rows of the rank below, zeros beyond the volume's edges, in
  one ``all_sum`` of a [S, ..., above + below, W] buffer; its backward adds
  the halos' cotangents to their owners' rows.
- ``conv3d(conv, x, split)``: ``conv`` (an ``nn.Conv3d`` of kernel k, stride
  s and padding p along H) on the slab: local input rows [a, a + h), s
  dividing a and h, give output rows [a/s, (a + h)/s), which need p rows
  above and k − p − s below; ``F.conv3d`` runs on the haloed slab with no H
  padding and the module's own weights. Where the rows stop splitting
  evenly (S not dividing H, s not dividing the slab, or a halo taller than
  the slab) the layer takes the gathered input and runs whole on every
  rank, and every later layer with it. That is decided from global shapes
  only, so every rank calls the same collectives in the same order; each
  rank's cotangent there comes from its own loss share, so summing the
  gradients over the ranks stays right.

Which layers run whole: none of VoxelMorph3D's and AffineNet3D's at the
full width, 176 x 256 x 256, over 2 or 4 ranks (H = 256 halves through
every stride-2 layer to AffineNet3D's 8-row conv6 input, 4 or 2 rows a
rank); AffineNet3D's conv6 (and the Dense layer after it) at H = 64 over 2
ranks, where its input has 2 rows in all (1 a rank, stride 2); VoxelMorph3D
needs S·2^len(enc_features) to divide H to split every level.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import all_sum

__all__ = ["HSplit"]

H_DIM = 3  # H of an NCDHW tensor


class HSplit:
    """The H of NCDHW tensors split over the ``shards`` ranks of ``group``,
    this rank being ``index`` (the module docstring)."""

    def __init__(self, group, index: int, shards: int):
        self.group, self.index, self.shards = group, int(index), int(shards)

    def start(self, local_h: int) -> int:
        """The first global row of a slab of ``local_h`` rows."""
        return self.index * local_h

    def splits(self, h: int, stride: int = 1, above: int = 0, below: int = 0) -> bool:
        """Whether a layer of H stride ``stride`` over an input of ``h``
        global rows, needing ``above`` and ``below`` halo rows, runs on the
        slab."""
        if h % self.shards:
            return False
        n = h // self.shards
        return n % stride == 0 and 0 <= below and max(above, below) <= n

    def slab(self, x, dim: int = H_DIM):
        """This rank's rows of ``x``, whole along ``dim``; raises unless the
        ranks divide it."""
        if x.shape[dim] % self.shards:
            raise ValueError(f"{x.shape[dim]} rows do not split over {self.shards} ranks")
        n = x.shape[dim] // self.shards
        return x.narrow(dim, self.start(n), n)

    def gather(self, x, dim: int = H_DIM):
        """The whole ``dim`` from each rank's slab ``x`` (the module
        docstring)."""
        n = x.shape[dim]
        pad = [0, 0] * (x.dim() - 1 - dim) + [self.start(n),
                                               (self.shards - 1 - self.index) * n]
        return all_sum(F.pad(x, pad), self.group)

    def halo(self, x, above: int, below: int, dim: int = H_DIM):
        """``x`` with ``above`` rows of the rank above and ``below`` rows of
        the rank below along ``dim``, zeros beyond the volume's edges."""
        if above == 0 and below == 0:
            return x
        n = x.shape[dim]
        # what this rank lends: its last rows to the rank below (as that
        # rank's rows above), its first rows to the rank above
        mine = torch.cat([x.narrow(dim, n - above, above), x.narrow(dim, 0, below)], dim)
        zero = torch.zeros_like(mine)
        lent = all_sum(torch.stack([mine if r == self.index else zero
                                    for r in range(self.shards)]), self.group)
        # slot r + 1 holds rank r's rows, slots 0 and S + 1 the zeros beyond
        # the volume's edges; every rank reads the reduced buffer, so every
        # rank's backward reduces its cotangent too
        lent = torch.cat([zero[None], lent, zero[None]])
        parts = []
        if above:
            parts.append(lent[self.index].narrow(dim, 0, above))
        parts.append(x)
        if below:
            parts.append(lent[self.index + 2].narrow(dim, above, below))
        return torch.cat(parts, dim)

    def conv3d(self, conv: nn.Conv3d, x, split: bool):
        """(``conv`` of ``x``, whether the result is a slab): ``x`` is this
        rank's slab when ``split``, else whole (the module docstring)."""
        k, s, p = conv.kernel_size[1], conv.stride[1], conv.padding[1]
        if split:
            above, below = p, k - p - s
            if self.splits(x.shape[H_DIM] * self.shards, s, above, below):
                y = F.conv3d(self.halo(x, above, below), conv.weight, conv.bias,
                             conv.stride, (conv.padding[0], 0, conv.padding[2]),
                             conv.dilation, conv.groups)
                return y, True
            x = self.gather(x)
        return conv(x), False
