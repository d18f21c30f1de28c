"""3-D volumetric training CLI with the flags of
``tpureg/cli/train_affine.py`` (:43-128), run as
``python -m tpureg_torch.cli.train_affine``.

``--stage affine`` (the default) trains ``AffineNet3D`` with ``Affloss`` on
whole-volume pairs from ``volume_dataset`` (each moving volume a random rigid
transform of its fixed one, synthesised on the device); ``--stage deform``
trains ``VoxelMorph3D`` with ``DEFloss3D``. ``--synthetic N`` trains on N
batches of U(0, 1) volumes an epoch instead. One line of average metrics is
printed per epoch, as tpureg prints it, and each average is written under
``--logdir`` as the TensorBoard scalar ``affine_<metric>`` or
``deform_<metric>``. Adam takes optax's default eps, 1e-8. Runs on the card
unless ``device="cpu"`` is passed.

The volumes are resized to ``--volume_size`` on real data too (tpureg's
dataset always takes the default 176,256,256).

``--spatial_shards S > 1`` runs the step over a ('data', 'spatial') grid of
the process group (``torchrun``; joined through ``parallel.init_from_env``
unless a group is already initialised): world / S data indices of S ranks
each, in tpureg's ``make_mesh`` order, each rank training on its rows of
the global batch and its slab of their H (tpureg's
``spatial_sharding(mesh, 5, axis=2)``). Every rank builds the same global
batch from the same seed and cuts its part; the metrics are the global
batch's, and rank 0 alone prints and writes TensorBoard. A world that S
does not divide, a batch that the data indices do not divide, and S > 1
without a process group are refused.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from ..data import random_volume_batch, volume_dataset
from ..models import AffineNet3D, VoxelMorph3D
from ..parallel import Grid, init_from_env, local_rows, make_grid
from ..train import (
    create_train_state,
    make_affine_train_step,
    make_deform3d_train_step,
)
from ..utils import AverageMeter, derive_seed, resolve_device, seed_everything
from ..utils.tb import MetricWriter


def synthetic_volumes(seed: int, n_batches: int, batch_size: int, size, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(n_batches):
        yield {"image_c": random_volume_batch(batch_size, size, generator=gen)}


def build_argparser():
    p = argparse.ArgumentParser(description="3-D volumetric registration")
    p.add_argument("--stage", default="affine", choices=("affine", "deform"),
                   help="affine pre-registration or learned deformable (SVF)")
    p.add_argument("--img_dir", default="OASIS1/masked")
    p.add_argument("--epochs", default=4, type=int)
    p.add_argument("--batch_size", default=2, type=int)
    p.add_argument("--lrIni", default=1e-4, type=float)
    p.add_argument("--synthetic", default=0, type=int,
                   help="train on N random volume batches/epoch")
    p.add_argument("--volume_size", default="176,256,256",
                   help="D,H,W (reference: 176 slices of 256²)")
    p.add_argument("--spatial_shards", default=1, type=int,
                   help="shard volume H over this many ranks of the process "
                        "group (torchrun)")
    p.add_argument("--logdir", default="./log_affine")
    p.add_argument("--seed", default=6, type=int)
    return p


def main(argv=None, device=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    # one process whatever the group for S = 1, as tpureg builds no mesh
    grid, rank = Grid(None, 1, 0, None), 0
    if args.spatial_shards > 1:
        if not dist.is_initialized():
            dev = init_from_env(dev)
        grid = make_grid(args.spatial_shards)
        # refuse a batch that does not split over the data indices
        local_rows(args.batch_size, grid.n_data, grid.data_index)
        rank = dist.get_rank()
    seed_everything(args.seed)
    size = tuple(int(x) for x in args.volume_size.split(","))

    deform = args.stage == "deform"
    gen = torch.Generator().manual_seed(args.seed)
    model = VoxelMorph3D(generator=gen) if deform else AffineNet3D(size, gen)
    state = create_train_state(model.to(dev), learning_rate=args.lrIni,
                               adam_eps=1e-8)
    make_step = make_deform3d_train_step if deform else make_affine_train_step
    train_step = make_step(state, group=grid.group, split=grid.split)
    meter_keys = ("loss", "photo_loss", "corr_loss") + (
        ("smooth_loss",) if deform else ())
    writer = MetricWriter(args.logdir, flush_secs=30) if rank == 0 else None
    meters = {k: AverageMeter() for k in meter_keys}

    for e in range(args.epochs):
        if args.synthetic:
            loader = synthetic_volumes(derive_seed(args.seed, e), args.synthetic,
                                       args.batch_size, size, dev)
        else:
            train_ds, _, _, _, _ = volume_dataset(
                args.img_dir, args.batch_size, dev, seed=args.seed, size=size)
            loader = iter(train_ds)
        for m in meters.values():
            m.reset()
        for batch in loader:
            metrics = train_step(grid.local(batch["image_c"]))
            for k, m in meters.items():
                m.update(float(metrics[k]))
        if writer is None:
            continue
        tag = "DEFORM" if deform else "AFFINE"
        print(f"[{tag} epoch {e + 1}/{args.epochs}] loss {meters['loss'].avg:.4f} "
              f"photo {meters['photo_loss'].avg:.4f} "
              f"corr {meters['corr_loss'].avg:.4f}", flush=True)
        for k, m in meters.items():
            writer.add_scalar(f"{tag.lower()}_{k}", m.avg, e + 1)
    if writer is not None:
        writer.close()
    return state


if __name__ == "__main__":
    main()
