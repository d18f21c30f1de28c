"""Registration-quality gate of tpureg_torch on 2-D phantoms, the counterpart
of ``tools/quality_check.py``: the deep model against the classical
comparator and the identity, by Dice.

Smooth random anatomy (uniform noise on a grid 16 times coarser, upsampled
with ``cubic_resize``, JAX's Keys cubic) with tercile segmentations (labels
1-3), and moving images made from it by ``elastic_displacement_2d`` (the
bilinear ``sample2d``, kernel K3, for the image, nearest for the labels).
The model (FlowNetS in the Pinard style by default) trains self-supervised
through ``make_train_step`` in bf16 at batch 16, 256², on pairs of elastic
magnitude (0, 0.5) px, fresh every step (the PWC names' loss reads their
finest two flows); with ``bootstrap_steps`` it first takes that many
``make_flow_supervised_step``s (bf16, "resolution" units, Adam at 1e-4) on
pairs of magnitude (0, 1.5) and their ground-truth displacements, the
stand-in for the reference's FlyingChairs weights, then trains on (with
fresh Adam moments at ``learning_rate`` when that is not 1e-4). It is scored on 8 held-out pairs
of magnitude (0.5, 1.0), the reference's evaluation family:

- identity          (no registration, the floor)
- syn(10,0,0)       (``register_syn``, the reference comparator's settings)
- syn(30,20,10)     (the multi-resolution setting)
- deep(<model>)     (the eval step's rounded warp of the moving labels)

Dice of the nearest-warped moving segmentation against the fixed one. The
draws come from ``torch.Generator``s on the card seeded 0 (weights and
training pairs) and 777 (evaluation pairs), so the phantoms are not
tpureg's (``jax.random``). Prints the table and PASS (deep >= syn(10,0,0),
exit 0) or FAIL (exit 1). Needs one CUDA card.

    python torch_quality_phantom.py [train_steps=400] [model=flownets]
                                    [bootstrap_steps=0] [learning_rate=1e-4]
"""

import subprocess
import sys
import time

import numpy as np
import torch

from tpureg_torch.classical import apply_flow, register_syn
from tpureg_torch.metrics import dice_average
from tpureg_torch.ops.elastic import elastic_displacement_2d
from tpureg_torch.ops.resize import cubic_resize
from tpureg_torch.ops.warp import base_grid, sample2d, sample2d_nearest
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (create_train_state, default_loss_kwargs,
                                make_eval_step, make_flow_supervised_step,
                                make_train_step)

SIZE = 256
EVAL_B = 8
TRAIN_B = 16


def phantom(gen, batch, size):
    """[B, 1, H, W] smooth random anatomy in [0, 1] and its tercile labels
    0..3 (as fp32)."""
    coarse = torch.rand((batch, 1, size // 16, size // 16), generator=gen,
                        device=gen.device)
    img = cubic_resize(coarse, (size, size)).clamp(0.0, 1.0)
    q = torch.quantile(img.reshape(batch, -1),
                       torch.tensor([0.25, 0.5, 0.75], device=img.device), dim=1).T
    seg = sum((img > q[:, i, None, None, None]).float() for i in range(3))
    return img, seg


def make_pairs(gen, batch, size, magnitude=(0.5, 1.0)):
    """Channels-last pairs (fixed, moving) [B, H, W, 2], their labels and
    the displacement [B, H, W, 2] that made the moving ones:
    ``moving(x) = fixed(x + d(x))``."""
    fixed, fixed_seg = phantom(gen, batch, size)
    disp = elastic_displacement_2d(batch, (size, size), magnitude_range=magnitude,
                                   generator=gen)
    grid = base_grid(size, size, fixed.device)
    px, py = grid[..., 0] + disp[:, 0], grid[..., 1] + disp[:, 1]
    moving = sample2d(fixed, px, py)
    moving_seg = sample2d_nearest(fixed_seg, px, py)
    nhwc = lambda a, b: torch.cat([a, b], 1).permute(0, 2, 3, 1).contiguous()
    return (nhwc(fixed, moving), nhwc(fixed_seg, moving_seg),
            disp.permute(0, 2, 3, 1).contiguous())


def dice_batch(warped_seg, fixed_seg):
    """Mean Dice (labels 1-3) of [B, H, W] label maps."""
    w, f = warped_seg.float().cpu().numpy(), fixed_seg.float().cpu().numpy()
    return float(np.mean([dice_average(f[i], w[i]) for i in range(f.shape[0])]))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(train_steps: int = 400, model_name: str = "flownets",
         bootstrap_steps: int = 0, learning_rate: float = 1e-4):
    if not torch.cuda.is_available():
        sys.exit("torch_quality_phantom.py: no CUDA card found")
    print(f"card: {card_line()}", flush=True)
    return run(torch.device("cuda"), train_steps, model_name, bootstrap_steps,
               learning_rate)


def run(dev, train_steps, model_name, bootstrap_steps, learning_rate):
    gen = torch.Generator(device=dev).manual_seed(0)
    model = OpticalFlowReg(model_name,
                           generator=torch.Generator().manual_seed(0)).to(dev)
    loss_kwargs = default_loss_kwargs(model_name)
    eval_step = make_eval_step(model, loss_kwargs, compute_dtype=torch.bfloat16)
    state = create_train_state(
        model, learning_rate=1e-4 if bootstrap_steps else learning_rate)

    if bootstrap_steps:
        boot_step = make_flow_supervised_step(state, compute_dtype=torch.bfloat16)
        print(f"bootstrap ({model_name}): {bootstrap_steps} supervised "
              f"synthetic-flow steps, magnitude (0, 1.5)", flush=True)
        t0 = time.time()
        for _ in range(bootstrap_steps):
            imgs, _, disp = make_pairs(gen, TRAIN_B, SIZE, (0.0, 1.5))
            bm = boot_step(imgs, disp)
        print(f"bootstrapped in {time.time() - t0:.0f}s (final EPE "
              f"{float(bm['epe']):.4f}, finest {float(bm['epe0']):.4f} px)",
              flush=True)
        bimgs, bsegs, _ = make_pairs(torch.Generator(device=dev).manual_seed(777),
                                     EVAL_B, SIZE)
        (_, _, bsegs_int, _), _ = eval_step(bimgs, bsegs)
        print(f"bootstrap-only deep Dice: "
              f"{dice_batch(bsegs_int[..., 0], bsegs[..., 0]):.4f}", flush=True)
        if learning_rate != 1e-4:
            # fresh Adam moments for the self-supervised phase at the
            # requested rate (the bootstrap always runs at 1e-4)
            state = create_train_state(model, learning_rate=learning_rate)
    train_step = make_train_step(state, loss_kwargs, compute_dtype=torch.bfloat16)
    if train_steps:
        print(f"training {model_name} on phantoms: {train_steps} steps (batch "
              f"{TRAIN_B}, {SIZE}², bf16, lr {learning_rate:g})", flush=True)
        t0 = time.time()
        for _ in range(train_steps):
            imgs, _, _ = make_pairs(gen, TRAIN_B, SIZE, (0.0, 0.5))
            m = train_step(imgs)
        print(f"trained in {time.time() - t0:.0f}s (final loss "
              f"{float(m['loss']):.1f})", flush=True)

    imgs, segs, _ = make_pairs(torch.Generator(device=dev).manual_seed(777),
                               EVAL_B, SIZE)
    fixed, moving = imgs[..., 0][:, None], imgs[..., 1][:, None]
    fixed_seg, moving_seg = segs[..., 0], segs[..., 1][:, None]
    results = {"identity": dice_batch(moving_seg[:, 0], fixed_seg)}
    for name, iters in (("syn(10,0,0)", (10, 0, 0)), ("syn(30,20,10)", (30, 20, 10))):
        t0 = time.time()
        flow, _ = register_syn(fixed, moving, reg_iterations=iters)
        results[name] = dice_batch(apply_flow(moving_seg, flow, "nearest")[:, 0],
                                   fixed_seg)
        print(f"{name}: {time.time() - t0:.1f}s", flush=True)
    deep = f"deep({model_name})"
    (_, _, warped_segs, _), _ = eval_step(imgs, segs)
    results[deep] = dice_batch(warped_segs[..., 0], fixed_seg)

    print("\nDice (labels 1-3) vs fixed seg, elastic eval magnitude (0.5, 1.0):")
    for name, v in results.items():
        print(f"  {name:15s} {v:.4f}")
    ok = results[deep] >= results["syn(10,0,0)"]
    print("QUALITY CHECK:", "PASS (deep >= classical comparator)" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 400,
                          sys.argv[2] if len(sys.argv) > 2 else "flownets",
                          int(sys.argv[3]) if len(sys.argv) > 3 else 0,
                          float(sys.argv[4]) if len(sys.argv) > 4 else 1e-4))
