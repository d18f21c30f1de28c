"""Evaluation CLI, with the flags of ``tpureg/cli/inference.py`` (reference
inference.py).

Loads the best-validation weights (``train/checkpoint.py``), runs the
registration head and its loss over real inter-subject pairs
(``--mode real``) or elastic pairs of evaluation strength made from
``--img_dir``/``--seg_dir`` (``--mode synthetic``) and computes the
per-sample metric suite: Dice, MSE, PSNR,
SSIM (image and seg), modified Hausdorff, MI, Pearson correlation, the flow
magnitude and the Jacobian statistics. It prints tpureg's per-batch line and
``EVAL summary``. Runs on the card unless ``device="cpu"`` is passed.

Not yet ported: the TensorBoard panels; ``--logdir`` is accepted for flag
compatibility and nothing is written there yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data import eval_random_dataset, real_pairs_dataset
from ..metrics import (
    CORR,
    MI,
    MSE,
    PSNR,
    dice_average,
    dist_hausdorff,
    flow_mag_sum,
    log_jacobian_std,
    neg_jacobian_fraction,
    ssim,
)
from ..reg import OpticalFlowReg
from ..train import default_loss_kwargs, load_best_weights, make_eval_step
from ..utils import AverageMeter, resolve_device

PRINT_INTERVAL = 2

METRICS = ("dice", "mse", "psnr", "hausdorff", "ssim_img", "ssim_seg", "mi",
           "corr", "mag", "neg_jac", "log_jac_std")


def evaluate(eval_step, loader, length: int, batch_size: int,
             max_samples: int = 0):
    meters = {k: AverageMeter() for k in METRICS}
    loss_meters = {k: AverageMeter() for k in
                   ("loss", "photo_loss", "corr_loss", "smooth_loss")}
    timer = AverageMeter()
    tic = time.time()
    for i, batch in enumerate(loader):
        imgs, segs = batch["image_c"], batch.get("seg_c")
        outputs, metrics = eval_step(imgs, segs)
        flows, warped_imgs, warped_segs, _ = outputs
        for k, m in loss_meters.items():
            m.update(float(metrics[k]))  # waits for the step
        timer.update(time.time() - tic)
        tic = time.time()

        imgs_np = imgs.float().cpu().numpy()
        fixed = imgs_np[..., 0:1]
        warped = warped_imgs[0].float().cpu().numpy()
        segs_np = None if segs is None else segs.cpu().numpy()
        wsegs = None if warped_segs is None else warped_segs.cpu().numpy()

        for j in range(fixed.shape[0]):
            f2d, w2d = fixed[j, ..., 0], warped[j, ..., 0]
            meters["mse"].update(MSE(f2d, w2d))
            meters["psnr"].update(PSNR(f2d, w2d))
            meters["ssim_img"].update(ssim(f2d, w2d, data_range=1.0))
            meters["mi"].update(MI(f2d, w2d))
            meters["corr"].update(CORR(f2d, w2d))
            if segs_np is not None:
                fs, ws = segs_np[j, ..., 0], wsegs[j, ..., 0]
                meters["dice"].update(dice_average(fs, ws))
                meters["ssim_seg"].update(
                    ssim(fs, ws, data_range=max(1.0, float(fs.max())))
                )
                meters["hausdorff"].update(dist_hausdorff(fs, ws))

        flow0 = flows[0].float().cpu().numpy()
        meters["mag"].update(flow_mag_sum(flow0[:1]))
        for j in range(flow0.shape[0]):
            meters["neg_jac"].update(neg_jacobian_fraction(flow0[j]))
            meters["log_jac_std"].update(log_jacobian_std(flow0[j]))

        step = i + 1
        if i % PRINT_INTERVAL == 0:
            print(
                f"[EVAL batch {step:03d}/{length // batch_size:03d}] "
                f"time {timer.val:.3f}s  loss {loss_meters['loss'].val:.4f} "
                f"({loss_meters['loss'].avg:.4f})  "
                f"dice {meters['dice'].avg:.4f}  "
                f"psnr {meters['psnr'].avg:.2f}",
                flush=True,
            )
        if max_samples and meters["mse"].count >= max_samples:
            break

    print("\n===> EVAL summary")
    for k, m in {**loss_meters, **meters}.items():
        if m.count:
            print(f"  {k:12s}: {m.avg:.5f}")
    return {k: m.avg for k, m in {**loss_meters, **meters}.items() if m.count}


def build_argparser():
    p = argparse.ArgumentParser(description="tpureg_torch evaluation")
    p.add_argument("--img_dir", default="OASIS1/masked")
    p.add_argument("--seg_dir", default="OASIS1/seg")
    p.add_argument("--fiximg_dir", default="OASIS1/fiximg")
    p.add_argument("--fixseg_dir", default="OASIS1/fixseg")
    p.add_argument("--movimg_dir", default="OASIS1/movimg")
    p.add_argument("--movseg_dir", default="OASIS1/movseg")
    p.add_argument("--mode", default="real", choices=("real", "synthetic"))
    p.add_argument("--model", default="flownet2",
                   help="flownet2, pwc, pwc-bilinear, pwc-reg, raft or "
                        "raft-reg (the registry names ported so far)")
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--workdir", default=".")
    p.add_argument("--logdir", default="./log_eval")
    p.add_argument("--seed", default=8, type=int)
    p.add_argument("--max_samples", default=0, type=int,
                   help="stop after N samples (0 = all)")
    p.add_argument("--precision", default="fp32", choices=("fp32", "bf16"),
                   help="bf16 = mixed-precision eval (fp32 weights cast)")
    return p


def main(argv=None, device=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    torch.manual_seed(args.seed)
    np.random.seed(args.seed)

    model = OpticalFlowReg(conv_predictor=args.model)
    predictor_name = type(model.predictor).__name__
    best_metrics = load_best_weights(args.workdir, predictor_name, model)
    model.to(dev)
    print(f"loaded best weights ({best_metrics})", flush=True)

    if args.mode == "real":
        loader, length = real_pairs_dataset(
            args.fiximg_dir, args.fixseg_dir, args.movimg_dir, args.movseg_dir,
            args.batch_size, device=dev,
        )
    else:
        loader, length = eval_random_dataset(
            args.img_dir, args.seg_dir, args.batch_size, dev, seed=args.seed)
    if length == 0:
        raise SystemExit(
            "no image/seg pairs found (checked "
            f"{args.fiximg_dir if args.mode == 'real' else args.img_dir!r})")

    eval_step = make_eval_step(
        model,
        loss_kwargs=default_loss_kwargs(args.model),
        compute_dtype=torch.bfloat16 if args.precision == "bf16" else None,
    )
    print("=================\n EVAL start\n=================", flush=True)
    return evaluate(eval_step, iter(loader), length, args.batch_size,
                    args.max_samples)


if __name__ == "__main__":
    main()
