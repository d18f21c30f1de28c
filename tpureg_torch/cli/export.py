"""Export a trained registration model as a serving artifact, the
counterpart of ``tpureg/cli/export.py``: it loads the best-validation
weights that the training CLI wrote, and writes one ``torch.export`` file
that serves without model code or checkpoints (tpureg_torch/serving/export.py).

    python -m tpureg_torch.cli.export --model flownets --workdir runs/x \\
        --out model.pt2 --batch_size 1 --image_size 256 --with_segs \\
        [--platforms cuda cpu] [--check]

Runs on the card unless ``main(argv, device="cpu")`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..reg import OpticalFlowReg
from ..serving import (compare_outputs, deterministic_cudnn, export_registration,
                       load_artifact, save_artifact)
from ..train import load_best_weights
from ..train.steps import set_fp32_numerics
from ..utils import resolve_device

__all__ = ["main", "build_argparser"]


def build_argparser():
    p = argparse.ArgumentParser(description="tpureg_torch serving export")
    p.add_argument("--model", default="flownets")
    p.add_argument("--workdir", default=".",
                   help="training workdir holding model_weight/.../best_weight.pt")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--image_size", default=256, type=int)
    p.add_argument("--with_segs", action="store_true",
                   help="artifact signature f(imgs, segs) incl. warped labels")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="devices the artifact is for, e.g. --platforms cuda cpu "
                        "(every artifact serves on both)")
    p.add_argument("--random_weights", action="store_true",
                   help="skip checkpoint loading (smoke/testing)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify vs the live head")
    return p


def main(argv=None, device=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    set_fp32_numerics()

    model = OpticalFlowReg(conv_predictor=args.model,
                           generator=torch.Generator().manual_seed(0))
    if not args.random_weights:
        metrics = load_best_weights(args.workdir, type(model.predictor).__name__,
                                    model)
        print(f"loaded best weights ({metrics})", flush=True)
    model.to(dev).eval()

    exported = export_registration(model, args.batch_size, args.image_size,
                                   with_segs=args.with_segs,
                                   platforms=args.platforms)
    save_artifact(args.out, exported)
    print(f"wrote {args.out} ({os.path.getsize(args.out)/1e6:.1f} MB, "
          f"platforms={args.platforms or [dev.type]})", flush=True)

    if args.check:
        f = load_artifact(args.out, dev)
        imgs = torch.from_numpy(np.random.default_rng(0).random(
            (args.batch_size, args.image_size, args.image_size, 2),
        ).astype(np.float32)).to(dev)
        inputs = (imgs, imgs) if args.with_segs else (imgs,)
        # the same ops on one device: with cuDNN's deterministic algorithms
        # equal; tpureg's 1e-5 on the flows, scaled
        with torch.no_grad(), deterministic_cudnn():
            live = model(*inputs)
            art = f(*inputs)
        diffs = compare_outputs(art, live)
        print(f"artifact check OK (matches the live head: flows within 1e-5 "
              f"of their scale, largest differences {diffs})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
