"""3-D registration-quality gate of tpureg_torch: the learned deformable
model against the classical comparator by Dice, the counterpart of
``tools/quality_check3d.py``.

Synthetic smooth-anatomy phantom volumes with tercile segmentations (labels
1-3), moved by smooth random ground-truth deformations of magnitude 2
voxels, fresh every step. VoxelMorph3D trains through
``make_deform3d_train_step`` (Adam at 1e-3, optax's eps of 1e-8) and is
scored on held-out pairs against ``register_syn3d(..., (10, 0, 0))``: Dice
of the nearest-warped moving segmentation against the fixed one, and the
negative-Jacobian fraction of each method's flow. The draws come from
``torch.Generator``s seeded 0 (training) and 777 (evaluation), so the
volumes are not the reference's (``jax.random``). Prints the table and PASS
(deep >= SyN, exit 0) or FAIL (exit 1). Needs one CUDA card; about a
minute on an H100.

    python torch_quality3d.py [train_steps=300] [DxHxW=32x64x64]
"""

import subprocess
import sys
import time

import numpy as np
import torch

from tpureg_torch.classical import apply_flow3d, register_syn3d
from tpureg_torch.metrics import dice_average, neg_jacobian_fraction
from tpureg_torch.models import VoxelMorph3D
from tpureg_torch.ops import resize_nd, warp3d
from tpureg_torch.train import create_train_state, make_deform3d_train_step

SHAPE = (32, 64, 64)  # divisible by 2^4 (the UNet's depth)
TRAIN_B = 4
EVAL_B = 4


def phantom3d(gen, batch, shape):
    """[B, 1, D, H, W] smooth volumes in [0, 1] (uniform noise on a grid 8
    times coarser, trilinear upsampling) and their tercile labels 1-3 (0
    below the first quartile)."""
    d, h, w = shape
    coarse = torch.rand((batch, 1, d // 8, h // 8, w // 8), device=gen.device,
                        generator=gen)
    img = resize_nd(coarse, shape, "linear").clamp(0.0, 1.0)
    q = torch.quantile(img.reshape(batch, -1),
                       torch.tensor([0.25, 0.5, 0.75], device=img.device), dim=1).T
    q = q[:, :, None, None, None, None]
    seg = (img > q[:, 0]).float() + (img > q[:, 1]).float() + (img > q[:, 2]).float()
    return img, seg


def make_pairs(gen, batch, shape, magnitude):
    """(vols [B, D, H, W, 2], (fixed_seg, moving_seg) each [B, 1, D, H, W]):
    the moving volume and labels are the fixed ones warped by a smooth
    random flow (trilinear and nearest)."""
    d, h, w = shape
    fixed, fixed_seg = phantom3d(gen, batch, shape)
    coarse = torch.randn((batch, 3, d // 8, h // 8, w // 8), device=gen.device,
                         generator=gen)
    flow_gt = resize_nd(coarse, shape, "linear") * magnitude
    moving = warp3d(fixed, flow_gt)
    moving_seg = apply_flow3d(fixed_seg, flow_gt, "nearest")
    vols = torch.cat([fixed, moving], 1).permute(0, 2, 3, 4, 1).contiguous()
    return vols, (fixed_seg, moving_seg)


def dice_batch(warped_seg, fixed_seg):
    w, f = warped_seg.cpu().numpy(), fixed_seg.cpu().numpy()
    return float(np.mean([dice_average(f[i, 0], w[i, 0]) for i in range(f.shape[0])]))


def neg_jac(flow):
    """Negative-Jacobian fraction of the first sample's [3, D, H, W] flow."""
    return neg_jacobian_fraction(flow[0].permute(1, 2, 3, 0).float().cpu().numpy())


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(train_steps: int = 300, shape=SHAPE):
    if not torch.cuda.is_available():
        sys.exit("torch_quality3d.py: no CUDA card found")
    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    # larger volumes keep the voxels a batch about constant
    train_b = max(1, TRAIN_B * (32 * 64 * 64) // int(np.prod(shape)))
    eval_b = max(1, EVAL_B * (32 * 64 * 64) // int(np.prod(shape)))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = VoxelMorph3D(generator=torch.Generator().manual_seed(1)).to(dev)
    state = create_train_state(model, learning_rate=1e-3, adam_eps=1e-8)
    step = make_deform3d_train_step(state)

    print(f"training VoxelMorph3D: {train_steps} steps (batch {train_b}, {shape})",
          flush=True)
    t0 = time.time()
    for _ in range(train_steps):
        vols, _ = make_pairs(gen, train_b, shape, 2.0)
        m = step(vols)
    final_loss = float(m["loss"])  # waits for the last step
    print(f"trained in {time.time() - t0:.0f}s (final loss {final_loss:.2f})",
          flush=True)

    vols, (fixed_seg, moving_seg) = make_pairs(
        torch.Generator(device=dev).manual_seed(777), eval_b, shape, 2.0)
    x = vols.permute(0, 4, 1, 2, 3)
    fixed, moving = x[:, 0:1].contiguous(), x[:, 1:2].contiguous()
    results = {"identity": (dice_batch(moving_seg, fixed_seg), None)}

    torch.cuda.synchronize()
    t0 = time.time()
    flow_c, _ = register_syn3d(fixed, moving, reg_iterations=(10, 0, 0))
    warped_seg_c = apply_flow3d(moving_seg, flow_c, "nearest")
    torch.cuda.synchronize()
    results["syn3d(10,0,0)"] = (dice_batch(warped_seg_c, fixed_seg), neg_jac(flow_c))
    print(f"syn3d: {time.time() - t0:.2f}s for {eval_b} pairs", flush=True)

    model.eval()
    with torch.no_grad():
        flow_d, _, _ = model(x.contiguous())
    warped_seg_d = apply_flow3d(moving_seg, flow_d, "nearest")
    results["deep(voxelmorph3d)"] = (dice_batch(warped_seg_d, fixed_seg), neg_jac(flow_d))

    print("\n3-D Dice (labels 1-3) vs fixed seg, smooth flow magnitude 2.0 vox:")
    for name, (v, nj) in results.items():
        njs = "" if nj is None else f"   neg-Jac {nj:.2e}"
        print(f"  {name:20s} {v:.4f}{njs}")
    ok = results["deep(voxelmorph3d)"][0] >= results["syn3d(10,0,0)"][0]
    print("QUALITY CHECK 3D:", "PASS (deep >= classical comparator)" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    shape = (tuple(int(v) for v in sys.argv[2].split("x"))
             if len(sys.argv) > 2 else SHAPE)
    raise SystemExit(main(steps, shape))
