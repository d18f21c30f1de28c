"""Registration-quality gate of tpureg_torch on real-format fixture pairs,
the counterpart of ``tools/quality_check_real.py``.

Writes the numpy fixture corpus of ``tools/make_fixtures.py`` (8 OASIS-format
Analyze subjects, a shared template anatomy with per-subject smooth
deformations) to a temporary directory, trains FlowNet2 self-supervised on
its slices through ``make_train_step`` (bf16, batch 16, 256², elastic
synthesis of magnitude (0, aug_hi) px), and scores on the same real
inter-subject pairs (the inference CLI's ``real_pairs_dataset``), by Dice
over labels 1-3:

- identity        (no registration: the inter-subject misalignment floor)
- classical SyN   (``register_syn(..., (10, 0, 0))``, the reference's
                   comparator configuration)
- deep model      (the trained FlowNet2's eval step in bf16)

The defaults are the recipe that passed on the reference's accelerator:
2000 steps at aug_hi 3.0. Prints the Dice table and PASS (deep >= SyN,
exit 0) or FAIL (exit 1). Needs one CUDA card; about 6 minutes on an H100.

    python torch_quality_real.py [train_steps=2000] [aug_hi=3.0]
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpureg_torch.classical import apply_flow, register_syn
from tpureg_torch.data import real_pairs_dataset, volume2slices_datasets
from tpureg_torch.metrics import dice_average
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (create_train_state, default_loss_kwargs,
                                make_eval_step, make_train_step)

ROOT = os.path.dirname(os.path.abspath(__file__))
EVAL_BATCHES = 4
EVAL_B = 8
MODEL = "flownet2"


def dice_batch(warped_seg, fixed_seg):
    """Dice of each [H, W] label map of NCHW ``warped_seg`` against
    ``fixed_seg``."""
    w, f = warped_seg.float().cpu().numpy(), fixed_seg.float().cpu().numpy()
    return [dice_average(f[i, 0], w[i, 0]) for i in range(f.shape[0])]


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(train_steps: int = 2000, aug_hi: float = 3.0):
    if not torch.cuda.is_available():
        sys.exit("torch_quality_real.py: no CUDA card found")
    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    with tempfile.TemporaryDirectory() as fix:
        t0 = time.time()
        subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_fixtures.py"),
                        fix, "8"], check=True, stdout=subprocess.DEVNULL)
        print(f"fixtures written in {time.time() - t0:.0f}s", flush=True)
        return run(fix, dev, train_steps, aug_hi)


def run(fix, dev, train_steps, aug_hi):
    train_ds, _, _, n_train, _ = volume2slices_datasets(
        os.path.join(fix, "img"), os.path.join(fix, "seg"), batch_size=16,
        device=dev, with_seg=False, magnitude=(0.0, aug_hi))
    model = OpticalFlowReg(MODEL, generator=torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, learning_rate=1e-4)
    loss_kwargs = default_loss_kwargs(MODEL)
    train_step = make_train_step(state, loss_kwargs, compute_dtype=torch.bfloat16)
    eval_step = make_eval_step(model, loss_kwargs, compute_dtype=torch.bfloat16)

    print(f"training {MODEL} on the fixture corpus ({n_train} slices an epoch): "
          f"{train_steps} steps (batch 16, 256², bf16, elastic magnitude "
          f"(0, {aug_hi}) px)", flush=True)
    t0 = time.time()
    done, epoch = 0, 0
    while done < train_steps:
        train_ds.set_epoch(epoch)
        for batch in train_ds:
            m = train_step(batch["image_c"])
            done += 1
            if done >= train_steps:
                break
        epoch += 1
    final_loss = float(m["loss"])  # waits for the last step
    print(f"trained in {time.time() - t0:.0f}s over {epoch} epochs (final loss "
          f"{final_loss:.1f})", flush=True)

    eval_ds, n_pairs = real_pairs_dataset(
        os.path.join(fix, "fiximg"), os.path.join(fix, "fixseg"),
        os.path.join(fix, "movimg"), os.path.join(fix, "movseg"),
        batch_size=EVAL_B, device=dev)
    print(f"evaluating on {EVAL_BATCHES}x{EVAL_B} of {n_pairs} real inter-subject "
          f"pairs", flush=True)
    deep = f"deep({MODEL})"
    scores = {"identity": [], "syn(10,0,0)": [], deep: []}
    seconds = {"syn(10,0,0)": 0.0, deep: 0.0}
    for bi, batch in enumerate(eval_ds):
        if bi >= EVAL_BATCHES:
            break
        imgs, segs = batch["image_c"], batch["seg_c"]
        fixed, moving = imgs[..., 0][:, None], imgs[..., 1][:, None]
        fixed_seg, moving_seg = segs[..., 0][:, None], segs[..., 1][:, None]
        scores["identity"] += dice_batch(moving_seg, fixed_seg)

        torch.cuda.synchronize()
        t0 = time.time()
        flow, _ = register_syn(fixed, moving, reg_iterations=(10, 0, 0))
        warped_seg = apply_flow(moving_seg, flow, "nearest")
        torch.cuda.synchronize()
        seconds["syn(10,0,0)"] += time.time() - t0
        scores["syn(10,0,0)"] += dice_batch(warped_seg, fixed_seg)

        t0 = time.time()
        (_, _, warped_segs, _), _ = eval_step(imgs, segs)
        torch.cuda.synchronize()
        seconds[deep] += time.time() - t0
        scores[deep] += dice_batch(warped_segs.permute(0, 3, 1, 2), fixed_seg)
        print(f"  batch {bi}: done", flush=True)

    print("\nDice (labels 1-3), real inter-subject fixture pairs:")
    for name, v in scores.items():
        t = f"  ({seconds[name]:.2f} s for all batches)" if name in seconds else ""
        print(f"  {name:18s} {np.mean(v):.4f}  (n={len(v)}){t}")
    ok = np.mean(scores[deep]) >= np.mean(scores["syn(10,0,0)"])
    print("REAL-PAIR QUALITY CHECK:",
          "PASS (deep >= classical comparator)" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 2000,
                          float(sys.argv[2]) if len(sys.argv) > 2 else 3.0))
