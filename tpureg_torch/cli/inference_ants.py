"""Classical-registration comparator CLI, with the flags of
``tpureg/cli/inference_ants.py`` (reference inference_ants.py).

Registers the same evaluation pairs as the deep models' CLI, real
inter-subject pairs (``--mode real``) or elastic pairs of evaluation
strength made from ``--img_dir``/``--seg_dir`` (``--mode synthetic``), with
the SVF registration of ``classical/syn.py`` (masked by ``fixed > 0``,
``--reg_iterations`` coarse to fine, (10, 0, 0) as the reference's ANTs
``SyNOnly`` call), warps the moving segmentation by the nearest sample and
computes the same eight metrics: Dice, MSE, PSNR, modified Hausdorff, SSIM
of the image and the segmentation, MI and Pearson correlation. It prints
tpureg's per-batch line and ``CLASSICAL summary`` and returns the averages;
under ``--logdir`` each batch writes every metric's running average and
latest value as the TensorBoard scalars ``<metric>_avg`` and
``<metric>_single``. Runs on the card unless ``device="cpu"`` is passed.

``--backend`` takes ``auto`` and ``torch`` (the same thing): ANTs is not
part of the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..classical import apply_flow, register_syn
from ..data import eval_random_dataset, real_pairs_dataset
from ..metrics import CORR, MI, MSE, PSNR, dice_average, dist_hausdorff, ssim
from ..utils import AverageMeter, resolve_device
from ..utils.tb import MetricWriter

PRINT_INTERVAL = 2

METRICS = ("dice", "mse", "psnr", "hausdorff", "ssim_img", "ssim_seg", "mi",
           "corr")


def _register_torch(fixed, moving, moving_seg, iters):
    """SyN of one [H, W] pair on its device, masked by ``fixed > 0``:
    (warped image, warped segmentation), each [H, W] in numpy."""
    fb, mb = fixed[None, None].float(), moving[None, None].float()
    flow, warped = register_syn(fb, mb, mask=(fb > 0).float(),
                                reg_iterations=iters)
    warped_seg = apply_flow(moving_seg[None, None].float(), flow, mode="nearest")
    return warped[0, 0].cpu().numpy(), warped_seg[0, 0].cpu().numpy()


def build_argparser():
    p = argparse.ArgumentParser(description="classical registration comparator")
    p.add_argument("--img_dir", default="OASIS1/masked")
    p.add_argument("--seg_dir", default="OASIS1/seg")
    p.add_argument("--fiximg_dir", default="OASIS1/fiximg")
    p.add_argument("--fixseg_dir", default="OASIS1/fixseg")
    p.add_argument("--movimg_dir", default="OASIS1/movimg")
    p.add_argument("--movseg_dir", default="OASIS1/movseg")
    p.add_argument("--mode", default="synthetic", choices=("real", "synthetic"))
    p.add_argument("--backend", default="auto", choices=("auto", "torch"))
    p.add_argument("--reg_iterations", default="10,0,0",
                   help="coarse-to-fine iterations (reference: 10,0,0)")
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--logdir", default="./log_ants")
    p.add_argument("--seed", default=8, type=int)
    p.add_argument("--max_samples", default=0, type=int,
                   help="stop after N samples (0 = all)")
    return p


def main(argv=None, device=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    torch.manual_seed(args.seed)
    np.random.seed(args.seed)
    iters = tuple(int(x) for x in args.reg_iterations.split(","))
    print("classical backend: torch", flush=True)

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

    writer = MetricWriter(args.logdir, flush_secs=30)
    meters = {k: AverageMeter() for k in METRICS}
    timer = AverageMeter()
    tic = time.time()
    n_done = 0
    for i, batch in enumerate(loader):
        imgs, segs = batch["image_c"], batch["seg_c"]
        for j in range(imgs.shape[0]):
            warped, warped_seg = _register_torch(imgs[j, ..., 0], imgs[j, ..., 1],
                                                 segs[j, ..., 1], iters)
            fixed = imgs[j, ..., 0].float().cpu().numpy()
            fseg = segs[j, ..., 0].float().cpu().numpy()
            meters["dice"].update(dice_average(fseg, warped_seg))
            meters["mse"].update(MSE(fixed, warped))
            meters["psnr"].update(PSNR(fixed, warped))
            meters["ssim_img"].update(ssim(fixed, warped, data_range=1.0))
            meters["ssim_seg"].update(
                ssim(fseg, warped_seg, data_range=max(1.0, float(fseg.max())))
            )
            meters["hausdorff"].update(dist_hausdorff(fseg, warped_seg))
            meters["mi"].update(MI(fixed, warped))
            meters["corr"].update(CORR(fixed, warped))
            n_done += 1
        timer.update(time.time() - tic)
        tic = time.time()
        step = i + 1
        for k, m in meters.items():
            writer.add_scalar(f"{k}_avg", m.avg, step)
            writer.add_scalar(f"{k}_single", m.data[-1], step)
        if i % PRINT_INTERVAL == 0:
            print(
                f"[CLASSICAL {step:03d}/{length:03d}] time {timer.val:.2f}s "
                f"dice {meters['dice'].avg:.4f} psnr {meters['psnr'].avg:.2f} "
                f"mse {meters['mse'].avg:.5f}",
                flush=True,
            )
        if args.max_samples and n_done >= args.max_samples:
            break

    print("\n===> CLASSICAL summary")
    for k, m in meters.items():
        if m.count:
            print(f"  {k:12s}: {m.avg:.5f}")
    writer.close()
    return {k: m.avg for k, m in meters.items() if m.count}


if __name__ == "__main__":
    main()
