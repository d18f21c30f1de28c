"""Training CLI with the flags of ``tpureg/cli/train.py`` (reference
train.py:107-120), run as ``python -m tpureg_torch.cli.train``.

Per epoch: the TRAIN pass (loss meters printed every PRINT_INTERVAL batches,
train.py:75-84), the training-state checkpoint (train.py:183-188), the VAL
pass with a best-weight save on improvement (train.py:191-201) and the TEST
pass, then the TensorBoard scalars under ``--logdir``: ``lr`` and, for
each loss term, its train, val and test averages as one group
(train.py:209-212). ``--cp`` resumes from the training-state checkpoint and
skips the finished epochs; ``--pretrained PATH`` then imports a torch
checkpoint in the reference's key names into the predictor (strict=False;
``--surgery rgb|rgb_pair`` collapses the RGB input of the stem
convolutions, the keys ending in ``conv1.0.weight`` or ``conv1a.0.weight``)
and prints what it loaded. ``--synthetic N`` trains on N random batches an
epoch instead of OASIS. On OASIS the elastic synthesis runs inside the
train step (``make_train_step(synth=...)``). Runs on the card unless
``device="cpu"`` is passed.

``--fsdp`` (tpureg cli/train.py:251-270, :292-294) trains data-parallel over
the default process group, with the parameters and Adam's moments sharded
by tpureg's rule (``parallel.shard_train_state``): launched as ``torchrun
--nproc_per_node N -m tpureg_torch.cli.train --fsdp ...`` (one process a
card; ``parallel.init_from_env``), or as ``main(argv, device)`` inside an
initialised group; with no group it runs on one device ("over 1 devices").
As in tpureg the corpus is not split per process: every rank draws the
same global batch and keeps its rows (``parallel.local_rows``), and the
step's results are the global batch's; where a microbatch does not split
over the ranks every rank keeps the whole batch and the gradients are
averaged. The elastic synthesis stays outside the step. Rank 0 alone
prints the meters and writes checkpoints, best weights and TensorBoard.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from functools import partial

import torch
import torch.distributed as dist

from ..data import random_pair_batch, synth_image_batch, volume2slices_datasets
from ..parallel import init_from_env, local_rows, rank_and_world, shard_train_state
from ..reg import OpticalFlowReg
from ..train import (
    create_train_state,
    default_loss_kwargs,
    make_eval_step,
    make_train_step,
    restore_training_state,
    save_best_weights,
    save_training_state,
    step_decay_schedule,
)
from ..utils import AverageMeter, derive_seed, resolve_device, seed_everything
from ..utils.tb import MetricWriter

PRINT_INTERVAL = 2
TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")


def _quiet(*args, **kwargs):
    pass


def run_epoch(step_fn, loader, mode: str, n_batches_hint=None,
              train: bool = True, log=print):
    """One pass over ``loader``; returns the average metrics (and ``_n``,
    the number of batches averaged); ``log`` prints the meters.

    Metrics are read back lazily (at print intervals, only once the card has
    finished their step, and at the epoch's end), so that steps queue on the
    card. A non-finite TRAIN loss halts the run before it reaches the
    checkpoints; a non-finite VAL/TEST loss drops that batch from the
    averages.
    """
    meters = {k: AverageMeter() for k in TERMS}
    timer = AverageMeter()
    pending = []

    def flush(blocking: bool = True):
        while pending:
            metrics, done = pending[0]
            if not blocking and done is not None and not done.query():
                break
            pending.pop(0)
            loss = float(metrics["loss"])
            if loss != loss or loss in (float("inf"), float("-inf")):
                if train:
                    raise FloatingPointError(
                        f"non-finite loss {loss} in {mode} after "
                        f"{meters['loss'].count} finite batches — halting "
                        "before the divergence reaches the checkpoints "
                        "(lower the lr, check input scaling, or resume from "
                        "the last epoch)")
                log(f"[{mode}] WARNING: non-finite loss {loss} — batch "
                      "excluded from epoch averages", flush=True)
                continue
            for k, m in meters.items():
                m.update(float(metrics[k]))

    epoch_t0 = time.time()
    tic = epoch_t0
    for i, batch in enumerate(loader):
        imgs = batch["image_c"]
        metrics = step_fn(imgs) if train else step_fn(imgs, None)[1]
        done = None
        if metrics["loss"].is_cuda:
            done = torch.cuda.Event()
            done.record()
        pending.append((metrics, done))
        timer.update(time.time() - tic)
        tic = time.time()
        if i % PRINT_INTERVAL == 0:
            flush(blocking=False)
            total = f"/{n_batches_hint}" if n_batches_hint else ""
            stats = (
                f"loss {meters['loss'].val:.4f} ({meters['loss'].avg:.4f})  "
                f"smooth {meters['smooth_loss'].val:.4f}  "
                f"corr {meters['corr_loss'].val:.4f}  "
                f"photo {meters['photo_loss'].val:.4f}"
                if meters["loss"].count else "loss (pending)")
            log(f"[{mode} batch {i + 1:03d}{total}] "
                  f"time {timer.val:.3f}s ({timer.avg:.3f}s)  {stats}",
                  flush=True)
    flush()
    epoch_s = time.time() - epoch_t0
    log(f"===> {mode} done in {epoch_s:.1f}s | avg loss "
          f"{meters['loss'].avg:.4f} smooth {meters['smooth_loss'].avg:.4f} "
          f"corr {meters['corr_loss'].avg:.4f} photo "
          f"{meters['photo_loss'].avg:.4f}\n", flush=True)
    out = {k: m.avg for k, m in meters.items()}
    out["_n"] = meters["loss"].count
    return out


def synthetic_loader(seed: int, n_batches: int, batch_size: int, size: int,
                     device):
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(n_batches):
        yield {"image_c": random_pair_batch(batch_size, size, generator=gen)}


def build_argparser():
    p = argparse.ArgumentParser(description="tpureg_torch self-supervised training")
    p.add_argument("--img_dir", default="OASIS1/masked", metavar="DIR_Img")
    p.add_argument("--seg_dir", default="OASIS1/seg", metavar="DIR_Seg")
    p.add_argument("--model", default="flownet2",
                   help="flownets (FlowNetS, also built for any name the registry "
                        "does not know), flownets-full, flownetc, flownetsd, "
                        "flownet2, flownet2-c, flownet2-s, flownet2-sd, "
                        "flownet2-cs, flownet2-css, pwc, pwc-bilinear, pwc-reg, "
                        "raft or raft-reg (pwc-old and flownetc-pinard take a "
                        "6-channel pair and do not run through the head)")
    p.add_argument("--epochs", default=4, type=int)
    p.add_argument("--batch_size", default=24, type=int)
    p.add_argument("--lrIni", default=1e-4, type=float)
    p.add_argument("--lrMin", default=1e-4, type=float,
                   help="adam eps (reference quirk: eps := lrMin)")
    p.add_argument("--cp", default=True, type=lambda s: s not in ("0", "False"),
                   help="resume from training_state checkpoint when present")
    p.add_argument("--synthetic", default=0, type=int, metavar="N",
                   help="train on N random batches/epoch instead of OASIS")
    p.add_argument("--image_size", default=256, type=int)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--pretrained", default=None,
                   help="torch checkpoint to import (strict=False)")
    p.add_argument("--surgery", default=None, choices=(None, "rgb", "rgb_pair"),
                   help="input-channel surgery applied to the stem conv")
    p.add_argument("--workdir", default=".")
    p.add_argument("--logdir", default="./log")
    p.add_argument("--seed", default=6, type=int)
    p.add_argument("--limit_volumes", default=10, type=int)
    p.add_argument("--precision", default="fp32", choices=("fp32", "bf16"),
                   help="bf16 = mixed precision (fp32 master params/BN)")
    p.add_argument("--aug_magnitude", default=(0.0, 0.5), nargs=2,
                   type=float, metavar=("LO", "HI"),
                   help="elastic control-point offset range (px) for the "
                        "moving-image synthesis; the reference hard-codes "
                        "(0, 0.5) (dataset.py:75)")
    p.add_argument("--accum_steps", default=1, type=int,
                   help="gradient-accumulation microbatches per step "
                        "(batch_size must divide)")
    p.add_argument("--lr_step", default=0, type=int,
                   help="StepLR period in steps (reference defines "
                        "StepLR(40, 0.8) but never steps it; 0 = constant)")
    p.add_argument("--lr_gamma", default=0.8, type=float)
    p.add_argument("--fsdp", action="store_true",
                   help="data-parallel over the process group (torchrun), "
                        "params and Adam's moments sharded by tpureg's rule")
    return p


def _rows(batches, rows):
    """Each batch's ``image_c`` cut to ``rows``."""
    for b in batches:
        yield {"image_c": b["image_c"].index_select(0, rows)}


def main(argv=None, device=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    group = None
    if args.fsdp:
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            dev = init_from_env(dev)
        group = dist.group.WORLD if dist.is_initialized() else None
    rank, world = rank_and_world(group)
    log = print if rank == 0 else _quiet
    seed_everything(args.seed)
    lr = step_decay_schedule(args.lrIni, step_size=args.lr_step,
                             gamma=args.lr_gamma, enabled=args.lr_step > 0)
    model = OpticalFlowReg(conv_predictor=args.model,
                           generator=torch.Generator().manual_seed(args.seed))
    model.to(dev)
    state = create_train_state(model, learning_rate=lr, adam_eps=args.lrMin)
    # checkpoint paths are keyed by predictor class name (train.py:127)
    predictor_name = type(model.predictor).__name__

    starting_epoch, best_loss = 0, float(1e5)
    if args.cp:
        restored = restore_training_state(args.workdir, predictor_name, state)
        if restored is not None:
            log("----------loading checkpoint state----------", flush=True)
            state, starting_epoch, best_loss = restored

    if args.pretrained:
        from ..compat import import_torch_state_dict, load_torch_checkpoint

        sd = load_torch_checkpoint(args.pretrained)
        # stem conv of each package: conv1.0 / conv1a.0 (+ cascade prefix)
        surgery = ({k: args.surgery for k in sd
                    if k.endswith(("conv1.0.weight", "conv1a.0.weight"))}
                   if args.surgery else {})
        report = import_torch_state_dict(sd, model, surgery=surgery,
                                         prefix="predictor.")
        log(f"imported {len(report['loaded'])} tensors "
            f"({len(report['missing'])} unmatched, "
            f"{len(report['shape_mismatch'])} shape-mismatched)", flush=True)

    rows = eval_rows = None
    if args.fsdp:
        shard_train_state(state, group)
        log(f"FSDP: params/opt-state sharded over {world} devices", flush=True)
        if args.batch_size % world:
            log(f"FSDP: batch {args.batch_size} not divisible by {world} "
                "devices — batches stay replicated", flush=True)
        elif args.batch_size % (world * args.accum_steps):
            log(f"FSDP: microbatch {args.batch_size // args.accum_steps} not "
                f"divisible by {world} devices — batches stay replicated",
                flush=True)
        else:
            rows = local_rows(args.batch_size, world, rank,
                              args.accum_steps).to(dev)
            eval_rows = local_rows(args.batch_size, world, rank).to(dev)
    parallel = dict(group=group, replicated=rows is None) if args.fsdp else {}

    compute_dtype = torch.bfloat16 if args.precision == "bf16" else None
    loss_kwargs = default_loss_kwargs(args.model)
    train_step = make_train_step(state, loss_kwargs=loss_kwargs,
                                 compute_dtype=compute_dtype,
                                 accum_steps=args.accum_steps, **parallel)
    eval_step = make_eval_step(model, loss_kwargs=loss_kwargs,
                               compute_dtype=compute_dtype, shards=state.shards,
                               **parallel)

    oasis, fused_synth = None, False
    if not args.synthetic:
        oasis = volume2slices_datasets(
            args.img_dir, args.seg_dir, args.batch_size, dev, seed=args.seed,
            limit=args.limit_volumes, shuffle_train=args.shuffle,
            # the training loop never reads seg_c (reference train.py:41-44)
            with_seg=False, magnitude=tuple(args.aug_magnitude),
            # tpureg's CLI never splits its corpus per process
            process_index=0, process_count=1)
        if oasis[0].supports_fused_step and not args.fsdp:
            # the elastic synthesis runs inside the train step
            train_step = make_train_step(
                state, loss_kwargs=loss_kwargs, compute_dtype=compute_dtype,
                accum_steps=args.accum_steps,
                synth=partial(synth_image_batch, size=oasis[0].size,
                              magnitude=oasis[0].magnitude))
            fused_synth = True

    def make_loaders(epoch_idx):
        if args.synthetic:
            n_val = max(1, args.synthetic // 8)
            mk = lambda split, n: synthetic_loader(
                derive_seed(args.seed, epoch_idx, split), n, args.batch_size,
                args.image_size, dev)
            loaders = (mk(0, args.synthetic), mk(1, n_val), mk(2, n_val))
            train_len = args.synthetic * args.batch_size
        else:
            train_ds, val_ds, test_ds, train_len, _ = oasis
            train_ds.set_epoch(epoch_idx + 1)
            train_iter = (({"image_c": s} for s in train_ds.batch_specs())
                          if fused_synth else iter(train_ds))
            loaders = (train_iter, iter(val_ds), iter(test_ds))
        if rows is not None:  # every rank drew the global batch: keep its rows
            loaders = tuple(_rows(loader, r) for loader, r
                            in zip(loaders, (rows, eval_rows, eval_rows)))
        return (*loaders, train_len)

    writer = MetricWriter(args.logdir, flush_secs=30) if rank == 0 else None
    for e in range(starting_epoch, args.epochs):
        log(f"=================\n EPOCH {e + 1}/{args.epochs}\n"
            f"=================", flush=True)
        train_loader, val_loader, test_loader, train_len = make_loaders(e)
        if writer is not None:
            # the rate scheduled at the current step, not the initial one
            writer.add_scalar("lr", state.lr(), e + 1)
        train_m = run_epoch(train_step, train_loader, "TRAIN",
                            train_len // args.batch_size, log=log)
        save_training_state(args.workdir, predictor_name, state, e, best_loss)

        val_m = run_epoch(eval_step, val_loader, "VAL", train=False, log=log)
        if val_m["_n"] and val_m["loss"] < best_loss:
            log("---------saving new best weights----------", flush=True)
            best_loss = val_m["loss"]
            with (state.shards.gathered() if state.shards is not None
                  else contextlib.nullcontext()):
                if rank == 0:
                    save_best_weights(
                        args.workdir, predictor_name, model,
                        {f"{k}_val": v for k, v in val_m.items() if k != "_n"})

        test_m = run_epoch(eval_step, test_loader, "TEST", train=False, log=log)
        if writer is not None:
            for tag in TERMS:
                writer.add_scalars(tag, {"train": train_m[tag], "val": val_m[tag],
                                         "test": test_m[tag]}, e + 1)
    if writer is not None:
        writer.close()
    log("---------Train complete---------", flush=True)
    return state


if __name__ == "__main__":
    main()
