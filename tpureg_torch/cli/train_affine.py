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
dataset always takes the default 176,256,256). Not ported:
``--spatial_shards > 1`` (spatial sharding over several cards, ROADMAP.md
item A.7) raises.
"""

from __future__ import annotations

import argparse

import torch

from ..data import random_volume_batch, volume_dataset
from ..models import AffineNet3D, VoxelMorph3D
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
                   help="shard volume H over this many devices (not ported: "
                        "only 1)")
    p.add_argument("--logdir", default="./log_affine")
    p.add_argument("--seed", default=6, type=int)
    return p


def main(argv=None, device=None):
    args = build_argparser().parse_args(argv)
    if args.spatial_shards > 1:
        raise NotImplementedError("--spatial_shards > 1 (spatial sharding over "
                                  "several cards) is not ported yet")
    dev = resolve_device(device)
    seed_everything(args.seed)
    size = tuple(int(x) for x in args.volume_size.split(","))

    deform = args.stage == "deform"
    gen = torch.Generator().manual_seed(args.seed)
    model = VoxelMorph3D(generator=gen) if deform else AffineNet3D(size, gen)
    state = create_train_state(model.to(dev), learning_rate=args.lrIni,
                               adam_eps=1e-8)
    if deform:
        train_step = make_deform3d_train_step(state)
        meter_keys = ("loss", "photo_loss", "corr_loss", "smooth_loss")
    else:
        train_step = make_affine_train_step(state)
        meter_keys = ("loss", "photo_loss", "corr_loss")
    writer = MetricWriter(args.logdir, flush_secs=30)
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
            metrics = train_step(batch["image_c"])
            for k, m in meters.items():
                m.update(float(metrics[k]))
        tag = "DEFORM" if deform else "AFFINE"
        print(f"[{tag} epoch {e + 1}/{args.epochs}] loss {meters['loss'].avg:.4f} "
              f"photo {meters['photo_loss'].avg:.4f} "
              f"corr {meters['corr_loss'].avg:.4f}", flush=True)
        for k, m in meters.items():
            writer.add_scalar(f"{tag.lower()}_{k}", m.avg, e + 1)
    writer.close()
    return state


if __name__ == "__main__":
    main()
