"""Drive tpureg_torch on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

1. the card (nvidia-smi name and power limit), versions and TF32 flags;
2. build the CUDA kernels from ``tpureg_torch/csrc`` and show ptxas's report;
3. K1 (correlation) and K2 (its backward) against their plain versions at
   FlowNetC's shape, fp32 and bf16, at PWC's five (md 4, s2 1) levels at
   256², batch 8, at a window wider than K1's widest tile, at s2 not
   dividing md and at ragged shapes;
4. K3 (bilinear warp), K4 (the warp's positions' cotangent Σ_c g·∂out/∂p)
   and K5 (the warp's image cotangent) against their plain versions at
   256², B=8, on smooth and scattered positions, fp32 and bf16, and with
   C > 1, each cotangent on a seeded N(0, 1) cotangent; K3 also where its
   rows cannot take vector loads (odd P, positions at an odd storage
   offset), equal to the plain gather; K5 also at SyN's compose
   (1 x 2 x 256²) and PWC's level 2 (8 x 32 x 64²) on smooth fields, at
   permuted positions and at P != H * W;
4c. K6a (trilinear 3-D warp), K6b (the positions' cotangent Σ_c g·∂out/∂p)
   and K6c (the volume's cotangent) against their plain versions at the 3-D
   path's shapes (the final warp, 2 x 1 x 176 x 256 x 256; a composition's
   3-channel field, 2 x 3 x 88 x 128 x 128) and at fault C1's (d = 32,
   dz = ±8.5), fp32 and bf16;
4d. K3, K4 and K5 at PWC's four feature warps at 256², batch 8 ((C, h) =
   (128, 8), (96, 16), (64, 32), (32, 64)), at the "pwc" positions of a
   smooth flow, fp32 and bf16, and the warp's validity mask (K3 on a
   1-channel ones image) at both thresholds, equal to the CPU's;
4e. K3, K4 and K5 at 65,536 and 65,537 batch rows (one-channel 4 x 4 maps
   at RAFT's 81 lookup positions), more than one launch's grid holds, and
   K6a-c at 65,536 2 x 2 x 2 volumes, fp32 and bf16, against their plain
   versions; K3's last rows also equal to a launch of them alone;
5. the eval path: a seeded, full-width FlowNet2 registration head runs the
   eval step at 256², batch 8, with segmentations, in fp32 and bf16; the
   launch counters must show 1 K1 and 7 K3 launches per step; batch 1 is
   held against the same weights on the CPU through the plain versions;
6. the inference CLI (``--mode real``) on phantom Analyze volumes;
7. the train path: the FlowNet2 train step at 256², batch 8, in fp32 (no
   TF32) and bf16; the counters must show 1 K1, 1 K2, 6 K3 and 5 K4
   launches per step and no K5; the loss falls over 5 steps on one batch; at batch
   1 the card's fp32 gradients are held against the CPU's plain path,
   both measured against the CPU's fp64 gradient;
8. the training CLI on 10 phantom volumes: one epoch, a resume with
   ``--cp 1`` that skips it, and the inference CLI in ``--mode synthetic``
   on the best weights it saved;
8b. the 3-D affine path at 176 x 256 x 256, batch 2, fp32 (no TF32): the
   data synthesis of two phantom heads (one K6a launch) and one AffineNet3D
   train step (K6a forward, K6b backward, no K6c); the loss falls over 5
   steps; at batch 1, on a small volume, the card's gradients are held
   against the CPU's plain path, both measured against the CPU's fp64
   gradient;
8c. the 3-D deform path: the VoxelMorph3D train step at full width,
   176 x 256 x 256, batch 2, fp32: 8 K6a and 8 K6b launches (7 compositions
   and the final warp) and 7 K6c launches (the compositions' warped fields);
   the same loss and gradient checks;
8d. the 3-D CLI: ``--stage affine`` on 10 phantom Analyze volumes (two K6a
   launches a batch, one in the synthesis) and ``--stage deform
   --synthetic 2``;
8e. the 2-D classical comparator: ``register_syn`` at 256², batch 1,
   (10, 0, 0), masked by fixed > 0, on a phantom and its elastic
   deformation: 77 K3, 70 K4 and 60 K5 launches; the local NCC rises; the
   card's flow and warped image held against the CPU's plain path;
8f. the comparator CLI (``tpureg_torch.cli.inference_ants``) in ``--mode
   real`` and ``--mode synthetic`` on phase 6's phantom volumes: finite
   metrics, the SyN launches once a pair, mean Dice above identity's on
   the same pairs, pairs per second;
8g. the 3-D comparator: ``register_syn3d`` at 176 x 256 x 256, batch 1,
   (30, 20, 10), on two phantom heads: 427 K6a, 420 K6b and 360 K6c
   launches; the first call's time, the negative-Jacobian fraction; at
   32 x 64 x 64 and (10, 0, 0) the card held against the CPU's plain path;
8h. the PWC family: a seeded pwc-reg head at its published widths runs the
   eval step (with segmentations) and the train step at 256², batch 8, in
   fp32 and bf16: 5 K1 and 17 K3 launches an eval step; 5 K1, 5 K2, 16 K3,
   6 K4 and 4 K5 a train step; the loss falls over 5 steps; at
   batch 1 the eval flows and losses and the fp32 gradient are held against
   the CPU's plain path, and so are the forwards of pwc, pwc-bilinear and
   pwc-old (its module alone, on a 6-channel pair, in both modes); the
   training CLI trains pwc-reg on phase 8's volumes, resumes and saves best
   weights, which the inference CLI loads in ``--mode real`` (phase 6's
   volumes) and ``--mode synthetic``;
8i. RAFT: a seeded raft-reg head (1/4 resolution, the warped moving
   features fed to the motion encoder; 1,760,610 parameters) runs the eval
   step (with segmentations) and the train step at 256², batch 8, in fp32
   and bf16: 32 K3 launches an eval step (20 lookups, 5 feature warps, the
   head's 5 image warps, the segmentation and the grid); 31 K3, 25 K4 and
   25 K5 a train step; the loss falls over 5 steps; at batch 1 the eval
   flows and losses and the fp32 gradient are held against the CPU's plain
   path, and so is raft's (1/8) eval; raft's eval and train steps at batch
   8 launch 27 K3, and 26 K3, 21 K4 and 20 K5; the training CLI trains
   raft-reg on phase 8's volumes, resumes and saves best weights under
   RAFT, which the inference CLI loads in ``--mode real`` and ``--mode
   synthetic``;
8j. FlowNetS in the Pinard style, tpureg's default predictor (38,667,792
   parameters with BatchNorm): a seeded head runs the eval step (with
   segmentations) and the train step at 256², batch 8, in fp32 and bf16: 4
   K3 launches an eval step (the image at flow0 and flow2, the segmentation,
   the grid); 7 K3 and 6 K4 a train step; the loss falls over 5 steps; at
   batch 1 the eval flows and losses and the fp32 gradient (with cuDNN; the
   distance without it printed beside) are held against the CPU's plain
   path; the flow-supervised step on the phantom gate's pairs in both
   units (7 K3, no K4): the EPE falls over 5 steps, and at batch 1 its
   metrics against the CPU's and its fp32 gradient against the CPU's fp64
   one (1e-2 over the model, 3e-2 a tensor); the rest of the 2-D zoo
   (flownets-full, flownetc, flownetsd and the cascade's sub-variants)
   through the head in eval mode at batch 1 against the CPU, with their
   launches, and FlowNetCPinard alone on a 6-channel pair in both modes;
   the training CLI trains flownets on phase 8's volumes, resumes and saves
   best weights under FlowNetS, which the inference CLI loads in ``--mode
   real`` and ``--mode synthetic``;
8k. what slices 1-3 left out (ROADMAP A.6): FlowNet2's train step at 256²,
   batch 8, in fp32 and bf16, and pwc-reg's in fp32, with ``remat="full"``
   and ``remat="dots"`` beside the base step, from the same weights on the
   same batch: every K1 and K3 launch of the forward runs again in the
   backward (FlowNet2 2 K1, 1 K2, 12 K3, 5 K4; pwc-reg 10 K1, 5 K2, 32 K3,
   6 K4, 4 K5); the loss within 1e-5 relative and the BatchNorm running
   statistics within 1e-6 of each tensor's largest value (at least 1) of
   the base step's; the fp32 gradient at batch 1 no further from the
   CPU's fp64 gradient than twice the further of the card's base step and
   the CPU's fp32 step, and its distance from the base step's at batch 8
   beside a second base step's; each step's time and peak memory;
   the training CLI with ``--pretrained`` and ``--surgery rgb_pair`` on
   phase 8's volumes (FlowNetS's weights, written by the port with the stem
   widened to a 6-channel pair) and the inference CLI on phase 6's, both
   reading their volumes through the native Analyze decoder, built here,
   which equals the numpy path on every volume; the TensorBoard writer's
   one warning where no backend imports; ``profiling.trace`` around one
   FlowNet2 eval step, whose trace names K1's and K3's kernels;
8l. the serving export (ROADMAP A.8): FlowNetS (tpureg's export default)
   and FlowNet2 at 256², batch 8, fp32 with TF32 off, with and without
   segmentations, exported with ``export_registration`` (the kernels are
   the ops ``tpureg::*``, nodes of the graph), saved, loaded back and
   called: each artifact call launches exactly the live eval head's
   kernels; with cuDNN's deterministic algorithms (its default transposed
   convolutions add with atomics) its flows are within 1e-5 of their scale
   of the live head's, its warped images and grid within what that moves
   a sample (``compare_outputs``) and its warped segmentation equal; the
   same files loaded on the CPU (``move_to_device_pass``) against the
   CPU's plain path by phase 8e's registration rule (flows within 0.1 px
   anywhere and 2e-3 px on average); ``python -m tpureg_torch.cli.export
   ... --check`` on the card; the artifact call and the live head timed
   (median of 10 after 2);
8m. data parallel and ``--fsdp`` (ROADMAP A.7a-b): (i) over an NCCL group of
   one on cuda:0, joined from torchrun's environment
   (``parallel.init_from_env``), FlowNet2's data-parallel train step at
   256², batch 8, fp32 and bf16, against the single-process step from the
   same weights on the same batch (cuDNN deterministic): the metrics and
   running statistics equal to the bit, the update within twice the
   single-process step's distance from itself (atomics in the resizes'
   backward), with the train step's launches (K1 1, K2 1, K3 6, K4 5); both
   timed, single, DP, DP, single (the collectives' cost on one card); the
   ``--fsdp`` training CLI for one epoch on phase 8's volumes, its
   checkpoint restored without it; (ii) two
   ranks of this script (``--dp-rank``) on the one card over gloo, named
   explicitly to ``init_from_env`` (NCCL refuses two ranks on one device):
   the fp32 DP step, 4 rows a rank, against (i)'s single-process step on
   the 8 (metrics and running statistics within 1e-4; the gradients summed
   over the ranks within 0.5 in relative L2 and 1 ± 0.25 in their
   projection on the single-process gradient, where one W = 2 times too
   large reads 1 and 2 and a change of rounding alone moves FlowNet2's fp32
   gradient here by about 0.1; the update within twice the single-process
   step's own distance under a change of rounding), each rank's launches as
   (i)'s; the FSDP step over the two ranks against the
   DP step (metrics and statistics equal to the bit, the update as close as
   the single-process step is to itself), each sharded parameter halved;
   the ``--fsdp`` CLI over the two ranks on two synthetic batches, rank 0
   alone writing;
9. timings with CUDA events: each kernel and its plain version, the
   library yardsticks (``grid_sample`` for K3 and K6a,
   ``grid_sampler_2d_backward`` for K4 (d/dgrid) and K5 (d/dinput),
   ``grid_sampler_3d_backward``
   for K6b and K6c; K6a also at a composition's shape, K6b also at the
   deform step's own first-composition positions, K6c at its first and last;
   K1's and K2's bounds on the tensor-core pipe they use beside their
   fp32-pipe bounds; K1 also at PWC's 8 x 64 x 32², md 4, s2 1; K5 also at
   SyN's and PWC's shapes; K3, K4, K5 and K6a-c at the comparators' own
   compositions; K1 and K2 at PWC's level-2 and level-6 shapes; K3, K4
   and K5 at PWC's four feature warps, and K3, K4 and K5 as one number
   against ``grid_sample`` and ``grid_sampler_2d_backward``; K3 on PWC's
   mask; the 2-D node's forward and positions' backward, K3 + K4, against
   ``grid_sample`` + d/dgrid at six shapes: PWC's four feature warps,
   FlowNet2's stn positions and SyN's composition; K3, K4 and K5 at
   raft-reg's lookups (levels 0 and 3 at batch 8, level 0 at batch 16) and
   its feature warp, fp32 and bf16),
   the eval and train steps of FlowNet2, pwc-reg, raft-reg and FlowNetS at batch 8 and the 3-D
   train steps at batch 2, whole 2-D and 3-D registrations, peak memory;
   the train steps of FlowNet2 (fp32, bf16) and pwc-reg (fp32) beside
   their medians when the kernels were ctypes calls (commit bf75122), the
   steps' cost of calling the kernels as ops;
10. a torch.profiler breakdown of one eval, one train and one step of each
    3-D stage, of pwc-reg's, raft-reg's and FlowNetS's eval and train steps, and of one
    2-D and one 3-D registration, by kernel group, with the device's idle
    share.

The line before the last is the kernel table as JSON, the one before it the
card; the last line is ``{"ok": true, "device": {...}}``. Any failed phase
ends the run with a traceback and a non-zero exit, and prints no result.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import io
import json
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpureg_torch.cli import inference as cli_inference
from tpureg_torch.cli import train as cli_train
from tpureg_torch.cli import inference_ants as cli_ants
from tpureg_torch.cli import train_affine as cli_train_affine
from tpureg_torch.classical import exp_velocity3d, register_syn, register_syn3d
from tpureg_torch.classical.syn import exp_velocity, local_ncc
from tpureg_torch.classical.syn3d import local_ncc3d
from tpureg_torch.data import VOLUME_SIZE, eval_random_dataset, real_pairs_dataset
from tpureg_torch.data import analyze
from tpureg_torch.data.pipeline import _minmax_scale_volume, _process_volume
from tpureg_torch.metrics import dice_average, neg_jacobian_fraction
from tpureg_torch.models import AffineNet3D, VoxelMorph3D, build_predictor
from tpureg_torch.ops import cuda_lib, resize2d, resize_nd
from tpureg_torch.ops.elastic import rand_elastic_2d
from tpureg_torch.ops.correlation import (
    correlation_bwd_cuda,
    correlation_bwd_reference,
    correlation_cuda,
    correlation_reference,
    displacement_count,
)
from tpureg_torch.ops.warp import (
    sample2d_cuda,
    sample2d_dimg_cuda,
    sample2d_dimg_reference,
    sample2d_dpos_cuda,
    sample2d_dpos_reference,
    sample2d_gather,
    sample2d_taps_reference,
    sample3d_cuda,
    sample3d_dpos_cuda,
    sample3d_dpos_reference,
    sample3d_dvol_cuda,
    sample3d_dvol_reference,
    sample3d_gather,
    voxel_grid,
    warp2d,
)
from tpureg_torch.nn import BatchNorm2d
from tpureg_torch.parallel import init_from_env, local_rows, shard_train_state
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.serving import (compare_outputs, deterministic_cudnn, export_registration,
                                  load_artifact, save_artifact)
from tpureg_torch.train import (
    best_weight_path,
    create_train_state,
    default_loss_kwargs,
    make_affine_train_step,
    make_deform3d_train_step,
    make_eval_step,
    make_flow_supervised_step,
    make_train_step,
    save_best_weights,
    set_fp32_numerics,
)
from tpureg_torch.train import checkpoint as checkpoint_module
from tpureg_torch.utils import trace
from torch_quality_phantom import make_pairs as phantom_pairs

DEV = torch.device("cuda")
SIZE, BATCH = 256, 8
VOL_BATCH = 2                      # the 3-D CLI's default batch
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,     # fp32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores, dense
TF32_FLOPS = 495e12                     # TF32 tensor cores, dense
# each kernel's wrapper and its name in the launch counts
COUNTERS = {"correlation": correlation_cuda,
            "correlation_bwd": correlation_bwd_cuda,
            "warp2d": sample2d_cuda,
            "warp2d_dpos": sample2d_dpos_cuda,
            "warp2d_dimg": sample2d_dimg_cuda,
            "warp3d": sample3d_cuda,
            "warp3d_dpos": sample3d_dpos_cuda,
            "warp3d_dvol": sample3d_dvol_cuda}


def launches_of(**nonzero):
    """Expected counts: ``nonzero`` and 0 for every other kernel."""
    return {name: nonzero.get(name, 0) for name in COUNTERS}


EVAL_LAUNCHES = launches_of(correlation=1, warp2d=7)
# FlowNetC's correlation and its backward; every 2-D sample runs K3
# forward: the four warps of the cascade and the head's image and grid
# warps; K4 runs in the backward of each node the loss reaches, the
# cascade's four and the head's image warp (the warped grid is not in the
# loss); every warped image is an input, so no K5
TRAIN_LAUNCHES = launches_of(correlation=1, correlation_bwd=1, warp2d=6, warp2d_dpos=5)
# every 3-D sample runs K6a forward: the data synthesis's warp of each
# moving volume (no gradient) and the step's affine warp, whose backward
# differentiates the positions only (K6b)
AFFINE_LAUNCHES = launches_of(warp3d=2, warp3d_dpos=1)
# VoxelMorph3D: 7 scaling-and-squaring compositions and the final warp
# sample (K6a) and differentiate their positions (K6b); the compositions'
# warped fields need a gradient too (K6c); the final warp's volume is an
# input
DEFORM_LAUNCHES = launches_of(warp3d=8, warp3d_dpos=8, warp3d_dvol=7)
# register_syn, (10, 0, 0): each of the 10 iterations at 64² runs 6
# compositions whose field and positions need a gradient (K3 forward, K4
# and K5 backward) and the moving image's warp, whose positions do (K3; K4);
# the final exponential and warp at 256² run under no_grad (6 + 1 K3)
SYN_LAUNCHES = launches_of(warp2d=10 * 7 + 7, warp2d_dpos=70, warp2d_dimg=60)
# pwc-reg's eval step: K1 at the 5 pyramid levels; K3 for the 4 feature
# warps (no gradient under inference_mode), their 4 validity masks, the
# head's 7 image warps (one a flow), the segmentation and the grid
PWC_EVAL_LAUNCHES = launches_of(correlation=5, warp2d=17)
# pwc-reg's train step: K1 and K2 at the 5 levels; K3 for every sample:
# the 4 feature warps, their 4 masks, the head's 7 image warps and the grid
# (16); K4 where the backward reaches a node whose positions need a
# gradient: the 4 feature warps and the head's warps of the finest 2 flows,
# the ones the loss reads (6; the 5 coarser image warps and the grid are
# not in the loss, and the masks' positions are detached); the warped
# moving features need their cotangent (K5); the moving image and the grid
# are inputs
PWC_TRAIN_LAUNCHES = launches_of(correlation=5, correlation_bwd=5, warp2d=16,
                                 warp2d_dpos=6, warp2d_dimg=4)
# raft-reg's eval step (5 iterations at 1/4 resolution, with segs): K3 for
# each iteration's lookups at the 4 pyramid levels (20) and its feature
# warp (5), the head's 5 image warps (one a flow), the segmentation and the
# grid
RAFT_REG_EVAL_LAUNCHES = launches_of(warp2d=32)
# raft-reg's train step: K3 for every sample but the segmentation's (31);
# K4 where the backward reaches positions that need a gradient: the 16
# lookups and 4 feature warps of iterations 2-5 (the first iteration's flow
# is a constant zero) and the head's 5 image warps, which the loss reads
# (25; the grid is not in the loss); K5 for the 20 lookups' correlation
# maps and the 5 warped moving features (25); the moving image and the
# grid are inputs
RAFT_REG_TRAIN_LAUNCHES = launches_of(warp2d=31, warp2d_dpos=25, warp2d_dimg=25)
# raft (1/8 resolution, no feature warps): 20 lookups, 5 head warps, the
# segmentation (eval only) and the grid; K4 for iterations 2-5's 16
# lookups and the 5 head warps; K5 for the 20 lookups
RAFT_EVAL_LAUNCHES = launches_of(warp2d=27)
RAFT_TRAIN_LAUNCHES = launches_of(warp2d=26, warp2d_dpos=21, warp2d_dimg=20)
# FlowNetS (pinard), tpureg's default predictor: its eval step (with segs)
# warps the moving image at flow0 and flow2, the segmentation and the grid
FLOWNETS_EVAL_LAUNCHES = launches_of(warp2d=4)
# its train step: K3 for the 6 flows' image warps and the grid; K4 for the
# 6 image warps the loss reads (the grid is not in the loss); the moving
# image and the grid are inputs, so no K5
FLOWNETS_TRAIN_LAUNCHES = launches_of(warp2d=7, warp2d_dpos=6)
# the flow-supervised step samples as the train step does, but its loss
# reads only the flows, so no warp is differentiated
SUPERVISED_LAUNCHES = launches_of(warp2d=7)
# the rest of the 2-D zoo through the head, eval mode with segs: K1 once in
# each FlowNetC; K3 for each of the head's flows' image warps, the
# segmentation and the grid, and for the cascade prefix's "pixel" warps
# (one an S block)
ZOO_EVAL_LAUNCHES = {
    "flownets-full": launches_of(warp2d=9),
    "flownetc": launches_of(correlation=1, warp2d=3),
    "flownet2-c": launches_of(correlation=1, warp2d=3),
    "flownet2-s": launches_of(warp2d=3),
    "flownet2-sd": launches_of(warp2d=3),
    "flownetsd": launches_of(warp2d=3),
    "flownet2-cs": launches_of(correlation=1, warp2d=4),
    "flownet2-css": launches_of(correlation=1, warp2d=5),
}
# remat="full" and "dots" run the head's forward again in the backward, up
# to the last tensor it saved, the grid warp's: so every K1 and K3 launch of
# the forward once more (ctypes calls, which the selective policy never
# keeps); the backward launches as the base step's
REMAT_TRAIN_LAUNCHES = launches_of(correlation=2, correlation_bwd=1, warp2d=12,
                                   warp2d_dpos=5)
PWC_REMAT_TRAIN_LAUNCHES = launches_of(correlation=10, correlation_bwd=5, warp2d=32,
                                       warp2d_dpos=6, warp2d_dimg=4)
# register_syn3d, (30, 20, 10): each of the 60 iterations runs 6
# compositions (K6a; K6b and K6c backward) and the moving volume's warp
# (K6a; K6b); the final exponential and warp run K6a only (6 + 1)
SYN3D_LAUNCHES = launches_of(warp3d=60 * 7 + 7, warp3d_dpos=60 * 7,
                             warp3d_dvol=60 * 6)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(title):
    print(f"\n=== {title}", flush=True)


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


# ---------------------------------------------------------------------------
# timing

def time_ms(fn, reps, head_start_ms=20.0):
    """Mean device time of ``fn`` over ``reps`` back-to-back launches between
    two CUDA events, after a warm-up. The card first spins for
    ``head_start_ms`` so that the host queues every launch before the start
    event runs: a short kernel is then timed on the card, not by the host's
    launch overhead. The inputs stay in the 50 MB L2, as they are in the eval
    step, where each input's producer runs just before."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(head_start_ms * 2e6))  # ~2e6 cycles a ms at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    starved = start.query()  # the card reached the start before the host was done
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    if starved:
        print(f"  (timer: the host queued {reps} calls slower than the card ran "
              f"them; {ms * 1e3:.2f} us a call includes launch gaps)")
    return ms


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def correlation_work(shape, md, s2, dtype):
    """(bytes, flops) that the correlation needs on these inputs: each input
    read once, the output written once, one multiply-add per in-image tap."""
    b, c, h, w = shape
    k = displacement_count(md, s2)
    es = torch.finfo(dtype).bits // 8
    taps_y = sum(max(0, min(h, h - (iy * s2 - md)) - max(0, -(iy * s2 - md)))
                 for iy in range(k))
    taps_x = sum(max(0, min(w, w - (ix * s2 - md)) - max(0, -(ix * s2 - md)))
                 for ix in range(k))
    nbytes = 2 * b * c * h * w * es + b * k * k * h * w * es
    return nbytes, 2 * b * c * taps_y * taps_x


def warp_work(img, p):
    """(bytes, flops) of one bilinear sample of ``img`` at p positions per
    image: image, positions and fp32 output once each; 8 FLOP of weights per
    position and 7 per channel."""
    b, c, h, w = img.shape
    nbytes = img.numel() * img.element_size() + 2 * b * p * 4 + b * c * p * 4
    return nbytes, b * p * (8 + 7 * c)


def correlation_bwd_work(shape, md, s2, dtype, gdtype):
    """(bytes, flops) of K2's function: f1, f2 and g read once, df1 and df2
    written once; one multiply-add per in-image tap for each cotangent."""
    b, c, h, w = shape
    k = displacement_count(md, s2)
    _, fwd_flops = correlation_work(shape, md, s2, dtype)
    es, gs = torch.finfo(dtype).bits // 8, torch.finfo(gdtype).bits // 8
    nbytes = 4 * b * c * h * w * es + b * k * k * h * w * gs
    return nbytes, 2 * fwd_flops


def warp_dpos_work(img, p):
    """(bytes, flops) of K4's function, the positions' cotangent: the image,
    the two position arrays and the fp32 cotangent [B, C, P] read once, dpx
    and dpy [B, P] written once in fp32; 4 FLOP of fractions per position,
    10 for the two bases and 4 for the contraction per channel."""
    b, c = img.shape[:2]
    nbytes = (img.numel() * img.element_size() + 2 * b * p * 4 + b * c * p * 4
              + 2 * b * p * 4)
    return nbytes, b * p * (4 + 14 * c)


def warp_dimg_work(shape, p, dtype):
    """(bytes, flops) of K5's function: positions and the fp32 cotangent
    read once, the image cotangent written once in ``dtype``; 8 FLOP of
    weights per position and 4 products and 4 sums per channel."""
    b, c, h, w = shape
    es = torch.finfo(dtype).bits // 8
    nbytes = 2 * b * p * 4 + b * c * p * 4 + b * c * h * w * es
    return nbytes, b * p * (8 + 8 * c)


def warp3d_work(vol, p):
    """(bytes, flops) of K6a's function: the volume, three position arrays
    and the fp32 sample once each; 22 FLOP of corner weights per position
    and 15 per channel."""
    b, c = vol.shape[:2]
    nbytes = vol.numel() * vol.element_size() + 3 * b * p * 4 + b * c * p * 4
    return nbytes, b * p * (22 + 15 * c)


def warp3d_taps_work(vol, p):
    """(bytes, flops) of K6b's earlier function, the sample and its three
    bases per channel: as K6a's, with the bases written too; 79 FLOP per
    channel (15 for the sample, 64 for the bases)."""
    b, c = vol.shape[:2]
    nbytes = vol.numel() * vol.element_size() + 3 * b * p * 4 + 4 * b * c * p * 4
    return nbytes, b * p * (22 + 79 * c)


def warp3d_dpos_work(vol, p):
    """(bytes, flops) of K6b's function, the positions' cotangent: the
    volume, three position arrays and the fp32 cotangent [B, C, P] read
    once, three fp32 outputs [B, P] written once; 22 FLOP of corner weights
    per position, 64 for the bases and 6 for the contraction per channel."""
    b, c = vol.shape[:2]
    nbytes = (vol.numel() * vol.element_size() + 3 * b * p * 4 + b * c * p * 4
              + 3 * b * p * 4)
    return nbytes, b * p * (22 + 70 * c)


def warp3d_dvol_work(shape, p, dtype):
    """(bytes, flops) of K6c's function: positions and the fp32 cotangent
    read once, the volume cotangent written once in ``dtype``; 22 FLOP of
    weights per position and 8 products and 8 sums per channel."""
    b, c = shape[:2]
    es = torch.finfo(dtype).bits // 8
    vox = shape[2] * shape[3] * shape[4]
    nbytes = 3 * b * p * 4 + b * c * p * 4 + b * c * vox * es
    return nbytes, b * p * (22 + 16 * c)


# ---------------------------------------------------------------------------
# data

def phantom_batch(b, size, seed):
    """Fixed/moving 'slices': nested ellipses with 4 labels, intensity
    label/3 plus noise, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    segs = np.empty((b, size, size, 2), np.float32)
    for i in range(b):
        for ch in range(2):
            cx, cy = rng.uniform(0.4, 0.6, 2)
            rx, ry = rng.uniform(0.25, 0.35, 2)
            r = np.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
            segs[i, ..., ch] = np.select([r < 0.4, r < 0.7, r < 1.0], [3, 2, 1], 0)
    imgs = segs / 3 + rng.normal(0, 0.02, segs.shape)
    return (torch.from_numpy(np.clip(imgs, 0, 1).astype(np.float32)),
            torch.from_numpy(segs))


def write_analyze(path_base, vol):
    """A little-endian int16 Analyze 7.5 pair (.hdr/.img)."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = (len(vol.shape),) + vol.shape + (1,) * (7 - len(vol.shape))
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 4)
    struct.pack_into("<h", hdr, 72, 16)
    struct.pack_into("<8f", hdr, 76, 0, 1, 1, 1, 1, 0, 0, 0)
    with open(path_base + ".hdr", "wb") as f:
        f.write(hdr)
    vol.astype(np.int16).ravel(order="F").tofile(path_base + ".img")


def phantom_volume(rng, shape=(176, 208, 176)):
    """An OASIS-sized ellipsoid 'head' with 3 nested tissue labels, long in
    z so that every slice of the pipeline's crop holds all three."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n, dtype=np.float32)
                            for n in shape), indexing="ij")
    c = rng.uniform(-0.1, 0.1, 2).astype(np.float32)
    r = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z / 2.5) ** 2)
    seg = np.select([r < 0.35, r < 0.6, r < 0.85], [3, 2, 1], 0)
    img = seg * 250 + rng.normal(0, 15, shape)
    return img, seg


def head_volumes(seed, n=VOL_BATCH):
    """[n, 208, 176, 176] phantom heads on the card, as the volume dataset
    reads an OASIS volume: (X, Y, Z) → (Y, X, Z)."""
    rng = np.random.default_rng(seed)
    raw = np.stack([np.transpose(phantom_volume(rng)[0], (1, 0, 2)) for _ in range(n)])
    return torch.from_numpy(raw.astype(np.float32)).to(DEV)


def blob_volumes(b, size, seed):
    """Fixed/moving volumes [B, D, H, W, 2]: Gaussian blobs, the fixed one
    1.5 above the moving one, so that the photometric Charbonnier (whose
    gradient is singular where the two agree) is smooth."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in size), indexing="ij")
    vols = np.empty((b, *size, 2), np.float32)
    for i in range(b):
        for c in range(2):
            cx, cy, cz = rng.uniform(-0.2, 0.2, 3)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2) / 0.3)
            vols[i, ..., c] = 0.5 * blob + (1.5 if c == 0 else 0.0)
    return torch.from_numpy(vols)


def warp3d_inputs(shape, scale, seed, dtype=torch.float32, dz=0.0):
    """A random volume and positions [B, P] at the voxel grid plus
    N(0, scale²) displacements and a uniform z shift ``dz``."""
    b, c, d, h, w = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    vol = torch.rand(shape, device=DEV, generator=g).to(dtype)
    flow = torch.randn((b, 3, d, h, w), device=DEV, generator=g) * scale
    zz, yy, xx = voxel_grid(d, h, w, DEV)
    pos = (xx + flow[:, 0], yy + flow[:, 1], zz + flow[:, 2] + dz)
    return vol, [t.reshape(b, -1).contiguous() for t in pos]


# ---------------------------------------------------------------------------
# phases

def card():
    phase("1. card and settings")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    set_fp32_numerics()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    return smi


def build():
    phase("2. build")
    t0 = time.time()
    path = cuda_lib.build()
    cuda_lib.load()
    print(f"built {path.name} in {time.time() - t0:.1f} s")
    print(cuda_lib.ptxas_report())


# K1's card shapes: FlowNetC; PWC's five levels at 256² (md 4, s2 1); a
# window wider than the widest tile; s2 not dividing md (no parity
# classes); H not a multiple of a block's rows and C = 40, not a multiple
# of 16; more channels than shared memory holds (staged in chunks)
K1_CASES = (((BATCH, 256, 32, 32), 20, 2),
            ((BATCH, 64, 32, 32), 4, 1),
            ((BATCH, 196, 4, 4), 4, 1),
            ((BATCH, 128, 8, 8), 4, 1),
            ((BATCH, 96, 16, 16), 4, 1),
            ((2, 32, 64, 64), 4, 1),
            ((1, 32, 16, 80), 20, 2),
            ((2, 24, 13, 29), 3, 2),
            ((1, 40, 9, 37), 20, 2),
            ((1, 1280, 4, 40), 4, 1))


def check_correlation():
    phase("3. K1 correlation against its plain version")
    errs = {}
    g = torch.Generator(device=DEV).manual_seed(0)
    for shape, md, s2 in K1_CASES:
        f1 = torch.randn(shape, device=DEV, generator=g)
        f2 = torch.randn(shape, device=DEV, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            a, b = f1.to(dtype), f2.to(dtype)
            got = correlation_cuda(a, b, md, s2).float()
            want = correlation_reference(a, b, md, s2).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if dtype == torch.float32:
                # fp32 sums of C products in another order
                tol = "1e-5 abs"
                ok = err <= 1e-5
            else:
                # both round the same fp32 sum to bf16: one bf16 step apart
                tol = "2^-7 rel + 1e-6"
                ok = bool(((got - want).abs()
                           <= 2.0**-7 * want.abs() + 1e-6).all())
            print(f"  {tuple(shape)} md {md} s2 {s2} {str(dtype)[6:]}: "
                  f"max |kernel - plain| = {err:.3g} (tolerance {tol})")
            require(ok, f"K1 disagrees with its plain version ({dtype}, md {md})")
            if shape == K1_CASES[0][0]:
                errs[dtype] = err
    return errs


def check_correlation_bwd():
    phase("3b. K2 correlation backward against its plain version")
    errs = {}
    g = torch.Generator(device=DEV).manual_seed(6)
    cases = (((BATCH, 256, 32, 32), 20, 2),   # FlowNetC at 256²
             ((BATCH, 64, 32, 32), 4, 1),     # PWC's level 3 at 256²
             ((BATCH, 196, 4, 4), 4, 1),      # PWC's levels 6, 5, 4 and 2
             ((BATCH, 128, 8, 8), 4, 1),
             ((BATCH, 96, 16, 16), 4, 1),
             ((BATCH, 32, 64, 64), 4, 1),
             ((1, 40, 9, 37), 20, 2))         # ragged column tile and channels
    for shape, md, s2 in cases:
        k = displacement_count(md, s2)
        f1 = torch.randn(shape, device=DEV, generator=g)
        f2 = torch.randn(shape, device=DEV, generator=g)
        grad = torch.randn((shape[0], k * k, *shape[2:]), device=DEV, generator=g)
        for dtype, gdtype in ((torch.float32, torch.float32),
                              (torch.bfloat16, torch.bfloat16),
                              (torch.bfloat16, torch.float32)):
            a, b, gr = f1.to(dtype), f2.to(dtype), grad.to(gdtype)
            got = correlation_bwd_cuda(a, b, gr, md, s2)
            want = correlation_bwd_reference(a, b, gr, md, s2)
            torch.cuda.synchronize()
            err, ok = 0.0, True
            for x, y in zip(got, want):
                x, y = x.float(), y.float()
                err = max(err, float((x - y).abs().max()))
                if dtype == torch.float32:
                    # fp32 sums of up to K² products, over C, in another order
                    tol = "1e-5 abs + 1e-5 rel"
                    ok &= bool(((x - y).abs() <= 1e-5 + 1e-5 * y.abs()).all())
                else:
                    # one bf16 rounding of fp32 sums taken in another order
                    tol = "2^-7 rel + 1e-5"
                    ok &= bool(((x - y).abs() <= 2.0**-7 * y.abs() + 1e-5).all())
            print(f"  {tuple(shape)} md {md} s2 {s2} operands {str(dtype)[6:]}, "
                  f"g {str(gdtype)[6:]}: max |kernel - plain| = {err:.3g} "
                  f"(tolerance {tol})")
            require(ok, f"K2 disagrees with its plain version ({dtype}, md {md})")
            if shape == cases[0][0] and dtype == gdtype:
                errs[dtype] = err
    return errs


def warp_inputs(dtype, seed=1, scale=60.0, shape=(BATCH, 1, SIZE, SIZE)):
    """A random image and positions at the pixel grid plus N(0, scale²)
    displacements: scattered (and often out of the image) at 60 px, smooth
    at 0.7 px."""
    b, c, h, w = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    img = torch.rand(shape, device=DEV, generator=g).to(dtype)
    flow = torch.randn((b, 2, h, w), device=DEV, generator=g) * scale
    px = (torch.arange(w, device=DEV, dtype=torch.float32) + flow[:, 0])
    py = (torch.arange(h, device=DEV, dtype=torch.float32)[:, None] + flow[:, 1])
    return img, px.reshape(b, -1).contiguous(), py.reshape(b, -1).contiguous()


def smooth_flow(b, h, w, amp, seed):
    """A smooth flow [B, 2, h, w] of about ``amp`` px: bicubic upsampling of
    N(0, amp²) noise on a grid 16 times coarser."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    coarse = torch.randn((b, 2, max(h // 16, 2), max(w // 16, 2)), device=DEV,
                         generator=g) * amp
    return F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=True)


def smooth_positions(b, h, w, amp, seed):
    """Positions [B, P] at the pixel grid plus ``smooth_flow`` (SyN's
    compositions and K5's shapes)."""
    flow = smooth_flow(b, h, w, amp, seed)
    px = torch.arange(w, device=DEV, dtype=torch.float32) + flow[:, 0]
    py = torch.arange(h, device=DEV, dtype=torch.float32)[:, None] + flow[:, 1]
    return px.reshape(b, -1).contiguous(), py.reshape(b, -1).contiguous()


def offset_view(t):
    """A contiguous copy of ``t`` that starts one element into its storage:
    4 bytes past an 8-byte boundary, where K3 cannot load a float2."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_warp():
    phase("4. K3 bilinear warp against its plain version")
    errs = {}
    # (label, shape, displacement std, positions at storage offset 1): the
    # eval path's shape at scattered positions, often out of the image; a
    # 3-channel image with odd W and odd P; rows 4 bytes off alignment
    cases = (("scattered", (BATCH, 1, SIZE, SIZE), 60.0, False),
             ("C=3, odd W, odd P", (2, 3, 37, 53), 20.0, False),
             ("storage offset 1", (BATCH, 1, SIZE, SIZE), 0.7, True))
    for label, shape, scale, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            img, px, py = warp_inputs(dtype, scale=scale, shape=shape)
            if offset:
                px, py = offset_view(px), offset_view(py)
                require(px.storage_offset() == 1 and px.is_contiguous(),
                        "the offset case needs contiguous views at offset 1")
            if label == "scattered":
                require(float(px.min()) < 0 and float(py.max()) > SIZE,
                        "the warp check needs out-of-image taps")
            got = sample2d_cuda(img, px, py)
            want = sample2d_gather(img.float(), px, py).reshape(got.shape)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            exact = bool(torch.equal(got, want))
            print(f"  {shape} P={px.shape[1]} {label} {str(dtype)[6:]}: max |kernel - "
                  f"plain| = {err:.3g}; equal to the plain gather: {exact} "
                  f"(tolerance 0: same roundings)")
            require(exact, f"K3 disagrees with its plain version ({label}, {dtype})")
            if label == "scattered":
                errs[dtype] = err
    return errs


def check_warp_grads():
    phase("4b. K4 (positions' cotangent) and K5 (image cotangent) against their "
          "plain versions")
    errs = {"dpos": {}, "dimg": {}}
    cases = (("scattered", 60.0, (BATCH, 1, SIZE, SIZE)),
             ("smooth", 0.7, (BATCH, 1, SIZE, SIZE)),
             ("C=3", 20.0, (2, 3, 37, 53)))
    for label, scale, shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            img, px, py = warp_inputs(dtype, seed=7, scale=scale, shape=shape)
            pos_err = check_dpos(f"{shape} {label}", img, px, py)
            err = check_dimg(f"{shape} {label}", shape, px, py, dtype)
            if label == "smooth":
                errs["dpos"][dtype] = pos_err
                errs["dimg"][dtype] = err
    # K5 alone at the shapes of the 2-D paths to come: SyN's compose of a
    # smooth 2-channel field and PWC's level-2 feature warp; and positions
    # in any layout: permuted, and RAFT's gather lookups (P != H * W)
    for label, shape, amp, layout in (("SyN compose", (1, 2, SIZE, SIZE), 2.0, "grid"),
                                      ("PWC level 2", (BATCH, 32, 64, 64), 2.0, "grid"),
                                      ("permuted", (2, 3, 64, 64), 2.0, "permuted"),
                                      ("P != H*W", (512, 1, 16, 16), 4.0, "P=81")):
        b, c, h, w = shape
        px, py = smooth_positions(b, h, w, amp, seed=9)
        if layout == "permuted":
            perm = torch.randperm(h * w, device=DEV,
                                  generator=torch.Generator(device=DEV).manual_seed(10))
            px, py = px[:, perm].contiguous(), py[:, perm].contiguous()
        elif layout == "P=81":
            px, py = px[:, :81].contiguous(), py[:, :81].contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            check_dimg(f"{shape} {label}, P={px.shape[1]}", shape, px, py, dtype)
    return errs


def check_dpos(label, img, px, py, seed=8):
    """K4 against its plain version on a seeded N(0, 1) cotangent; returns
    the largest difference. Each channel's basis is the same differences of
    tap values, associated otherwise than autograd's chain: a few fp32
    roundings, within 1e-6 abs + 1e-5 rel of the basis (the tolerance the
    bases had as K4's outputs); the contraction weights channel c's by
    |g_c|, so at each position |K4 - plain| <= Σ_c |g_c| (1e-6 + 1e-5
    |basis_c|). A bf16 image's taps are exact in fp32, so both dtypes take
    the same tolerance."""
    b, c = img.shape[:2]
    grad = torch.randn((b, c, px.shape[1]), device=DEV,
                       generator=torch.Generator(device=DEV).manual_seed(seed))
    got = sample2d_dpos_cuda(grad, img, px, py)
    want = sample2d_dpos_reference(grad, img, px, py)
    _, *bases = sample2d_taps_reference(img, px, py)
    torch.cuda.synchronize()
    err = max(float((k - r).abs().max()) for k, r in zip(got, want))
    ok = all(bool(((k - r).abs() <= (grad.abs() * (1e-6 + 1e-5 * base.abs())).sum(1)
                   ).all()) for k, r, base in zip(got, want, bases))
    print(f"  K4 {label} {str(img.dtype)[6:]}: max |kernel - plain| = {err:.3g} "
          f"(tolerance Σ_c |g_c| (1e-6 + 1e-5 |basis_c|))")
    require(ok, f"K4 disagrees ({label}, {img.dtype})")
    return err


def check_dimg(label, shape, px, py, dtype):
    """K5 against its plain version on a seeded cotangent; returns the
    largest difference."""
    b, c, h, w = shape
    grad = torch.randn((b, c, px.shape[1]), device=DEV,
                       generator=torch.Generator(device=DEV).manual_seed(8))
    got = sample2d_dimg_cuda(grad, px, py, shape, dtype).float()
    ref = sample2d_dimg_reference(grad, px, py, shape, dtype).float()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        # fp32 sums of the same products, merged in registers and added by
        # atomics in an order that changes from run to run
        tol, ok = "1e-5 abs + 1e-5 rel", bool(
            ((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())
    else:
        tol, ok = "2^-7 rel + 1e-5", bool(
            ((got - ref).abs() <= 2.0**-7 * ref.abs() + 1e-5).all())
    print(f"  K5 {label} {str(dtype)[6:]}: max |kernel - plain| = {err:.3g} "
          f"(tolerance {tol})")
    require(ok, f"K5 disagrees ({label}, {dtype})")
    return err


# the 3-D path's shapes: the final warp of the moving volume and one
# scaling-and-squaring composition of the half-resolution 3-channel field;
# fault C1's configuration of the TPU kernel (ADVICE.md:3-4)
WARP3D_CASES = (("final warp", (VOL_BATCH, 1, *VOLUME_SIZE), 0.7, 0.0),
                ("composition", (VOL_BATCH, 3, 88, 128, 128), 0.5, 0.0),
                ("C1, dz -8.5", (1, 1, 32, 64, 64), 0.3, -8.5),
                ("C1, dz +8.5", (1, 1, 32, 64, 64), 0.3, 8.5))


def check_warp3d_case(label, vol, px, py, pz, dtype):
    """K6a, K6b and K6c against their plain versions on ``vol`` at ``px``,
    ``py``, ``pz`` [B, P], one line; returns their largest differences."""
    shape = tuple(vol.shape)
    got = sample3d_cuda(vol, px, py, pz)
    want = sample3d_gather(vol.float(), px, py, pz)
    torch.cuda.synchronize()
    # K6a: the plain version's roundings, in its order
    exact = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    del got, want
    b, c = shape[:2]
    grad = torch.randn((b, c, px.shape[1]), device=DEV,
                       generator=torch.Generator(device=DEV).manual_seed(31))
    dpos = sample3d_dpos_cuda(grad, vol, px, py, pz)
    ref = sample3d_dpos_reference(grad, vol, px, py, pz)
    torch.cuda.synchronize()
    # K6b: the bases are the same products of corner values summed as
    # tpureg's _gather_taps sums them, not as autograd's chain, and
    # contracted with g in channel order; the volume's bf16 values are exact
    # in fp32, so both dtypes take the same tolerance
    pos_err = max(float((k - r).abs().max()) for k, r in zip(dpos, ref))
    pos_ok = all(bool(((k - r).abs() <= 1e-6 + 1e-5 * r.abs()).all())
                 for k, r in zip(dpos, ref))
    del dpos, ref
    dvol = sample3d_dvol_cuda(grad, px, py, pz, shape, dtype).float()
    dref = sample3d_dvol_reference(grad, px, py, pz, shape, dtype).float()
    torch.cuda.synchronize()
    derr = float((dvol - dref).abs().max())
    if dtype == torch.float32:
        # the same products added by atomics in an order that changes from
        # run to run
        tol, dok = "1e-5 abs + 1e-5 rel", bool(
            ((dvol - dref).abs() <= 1e-5 + 1e-5 * dref.abs()).all())
    else:
        tol, dok = "2^-7 rel + 1e-5", bool(
            ((dvol - dref).abs() <= 2.0**-7 * dref.abs() + 1e-5).all())
    print(f"  {label} {shape} {str(dtype)[6:]}: K6a equal to the plain "
          f"sample: {exact}; K6b max |kernel - plain| = {pos_err:.3g} "
          f"(tolerance 1e-6 abs + 1e-5 rel); K6c max |kernel - plain| = "
          f"{derr:.3g} (tolerance {tol})")
    require(exact and pos_ok and dok, f"K6 disagrees ({label}, {dtype})")
    return err, pos_err, derr


def check_warp3d():
    phase("4c. K6a (trilinear warp), K6b (positions' cotangent) and K6c (volume "
          "cotangent) against their plain versions")
    errs = {"warp3d": {}, "warp3d_dpos": {}, "warp3d_dvol": {}}
    for label, shape, scale, dz in WARP3D_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            vol, (px, py, pz) = warp3d_inputs(shape, scale, 30, dtype, dz)
            found = check_warp3d_case(label, vol, px, py, pz, dtype)
            if dtype == torch.float32 and "C1" not in label:
                for key, err in zip(errs, found):
                    errs[key][label] = err
            del vol, px, py, pz
            torch.cuda.empty_cache()
    return errs


def lookup_positions(b, h, w, seed, radius=4):
    """RAFT's lookup positions [B, (2r+1)²] over B one-channel [h, w] maps:
    a centre a map, uniform over the map and 2 px past each border, plus the
    offsets -r..r in x and y, dy-major, so that many taps fall outside."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    cx = torch.rand((b, 1), device=DEV, generator=g) * (w + 3) - 2
    cy = torch.rand((b, 1), device=DEV, generator=g) * (h + 3) - 2
    d = torch.arange(-radius, radius + 1, device=DEV, dtype=torch.float32)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return ((cx + dx.reshape(1, -1)).contiguous(),
            (cy + dy.reshape(1, -1)).contiguous())


def check_any_batch():
    phase("4e. K3, K4, K5 and K6a-c over more batch rows than one launch's grid "
          "holds (65535)")
    # RAFT's lookup at batch 16, 256² (16 · 64², raft-reg's level 0 maps) and
    # one row more, on 4 x 4 maps at its 81 positions; the rows past 65535
    # run in a launch of their own
    for b in (65536, 65537):
        shape = (b, 1, 4, 4)
        for dtype in (torch.float32, torch.bfloat16):
            img = torch.rand(shape, device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(b)).to(dtype)
            px, py = lookup_positions(b, 4, 4, seed=b + 1)
            got = sample2d_cuda(img, px, py)
            exact = bool(torch.equal(got, sample2d_gather(img.float(), px, py)))
            tail = slice(65530, b)
            alone = sample2d_cuda(img[tail].contiguous(), px[tail].contiguous(),
                                  py[tail].contiguous())
            same = bool(torch.equal(got[tail], alone))
            print(f"  K3 {shape} P=81 {str(dtype)[6:]}: equal to the plain gather: "
                  f"{exact}; its last {b - 65530} rows equal to a launch of them "
                  f"alone: {same}")
            require(exact and same, f"K3 disagrees at batch {b} ({dtype})")
            check_dpos(f"{shape} P=81", img, px, py)
            check_dimg(f"{shape} P=81", shape, px, py, dtype)
    for dtype in (torch.float32, torch.bfloat16):
        vol, (px, py, pz) = warp3d_inputs((65536, 1, 2, 2, 2), 0.5, 32, dtype)
        check_warp3d_case("batch 65536", vol, px, py, pz, dtype)


# PWC's four feature warps at 256², batch 8: (level, C, h) for levels 5-2
PWC_WARPS = ((5, 128, 8), (4, 96, 16), (3, 64, 32), (2, 32, 64))


def pwc_positions(flow):
    """The "pwc" convention's positions [B, P] of ``flow``:
    (flow + xy) · size / (size - 1) - 0.5, as ``warp2d`` forms them."""
    b, _, h, w = flow.shape
    px = (torch.arange(w, device=DEV, dtype=torch.float32) + flow[:, 0]) * (w / (w - 1)) - 0.5
    py = ((torch.arange(h, device=DEV, dtype=torch.float32)[:, None] + flow[:, 1])
          * (h / (h - 1)) - 0.5)
    return px.reshape(b, -1).contiguous(), py.reshape(b, -1).contiguous()


def check_pwc_warps():
    phase("4d. K3, K4 and K5 at PWC's feature warps, and K3 on their validity masks")
    errs = {}
    for lvl, c, h in PWC_WARPS:
        shape = (BATCH, c, h, h)
        flow = smooth_flow(BATCH, h, h, 2.0, seed=40 + lvl)
        px, py = pwc_positions(flow)
        for dtype in (torch.float32, torch.bfloat16):
            img = torch.rand(shape, device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(lvl)
                             ).to(dtype)
            k3 = sample2d_cuda(img, px, py)
            want = sample2d_gather(img.float(), px, py)
            torch.cuda.synchronize()
            # as phase 4: the sample to the last bit
            exact = bool(torch.equal(k3, want))
            k3_err = float((k3 - want).abs().max())
            print(f"  K3 {shape} level {lvl} {str(dtype)[6:]}: equal to the plain "
                  f"sample: {exact} (tolerance 0: same roundings)")
            require(exact, f"K3 disagrees at PWC level {lvl} ({dtype})")
            perr = check_dpos(f"{shape} PWC level {lvl}", img, px, py)
            derr = check_dimg(f"{shape} PWC level {lvl}", shape, px, py, dtype)
            errs.setdefault(lvl, {})[dtype] = {"warp2d": k3_err, "warp2d_dpos": perr,
                                               "warp2d_dimg": derr}
            # the warp and its mask on the card (K3 twice: the features,
            # then a 1-channel ones image in the features' dtype) against
            # the CPU's plain path, at both thresholds
            for threshold in (0.9999, 0.999):
                before = sample2d_cuda.launches
                got, mask = warp2d(img, flow, "pwc", return_mask=True,
                                   mask_threshold=threshold)
                ran = sample2d_cuda.launches - before
                cpu, cmask = warp2d(img.cpu(), flow.cpu(), "pwc", return_mask=True,
                                    mask_threshold=threshold)
                # the mask equal; the output K3's sample of positions that
                # the card and the CPU may round apart by an ulp
                diff = (got.cpu().float() - cpu.float()).abs()
                same = bool(torch.equal(mask.cpu(), cmask)) and bool(
                    (diff <= 1e-6 + (2.0**-7 if dtype == torch.bfloat16 else 0.0)
                     * cpu.float().abs()).all())
                print(f"    mask at {threshold} {str(dtype)[6:]}: {float(mask.float().mean()):.4f} "
                      f"valid, K3 launches {ran}; mask equal to the CPU's and output "
                      f"within 1e-6 (+ one bf16 step): {same} (max {float(diff.max()):.3g})")
                require(same and ran == 2 and mask.shape == (BATCH, 1, h, h)
                        and mask.dtype == dtype,
                        f"the pwc warp or its mask disagrees at level {lvl} ({dtype})")
    return errs


def main_path(model):
    phase("5. eval path: FlowNet2 eval step at 256², batch 8, with segs")
    imgs, segs = phantom_batch(BATCH, SIZE, seed=2)
    imgs, segs = imgs.to(DEV), segs.to(DEV)
    launches, steps, results = {}, {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        step = make_eval_step(model, compute_dtype=dtype)
        torch.cuda.synchronize()
        reset_counts()
        (flows, warped, wsegs, grid), metrics = step(imgs, segs)
        torch.cuda.synchronize()
        launches[name] = counts()
        print(f"  {name}: launches {launches[name]}; loss "
              f"{float(metrics['loss']):.6g}, photo {float(metrics['photo_loss']):.6g}, "
              f"corr {float(metrics['corr_loss']):.6g}, "
              f"smooth {float(metrics['smooth_loss']):.6g}")
        require(launches[name] == EVAL_LAUNCHES,
                f"{name} step should launch K1 once and K3 7 times: {launches[name]}")
        require(flows[0].shape == (BATCH, SIZE, SIZE, 2) and len(flows) == 2,
                "flow shape")
        require(warped[0].shape == (BATCH, SIZE, SIZE, 1)
                and wsegs.shape == (BATCH, SIZE, SIZE, 1)
                and grid.shape == (BATCH, SIZE, SIZE, 1), "output shapes")
        for t in (*flows, *warped, wsegs, grid, *metrics.values()):
            require(bool(torch.isfinite(t.float()).all()), f"{name}: non-finite output")
        require(set(torch.unique(wsegs).tolist()) <= {0.0, 1.0, 2.0, 3.0},
                "warped labels outside 0..3")
        print(f"  {name}: |flow| max {float(flows[0].float().abs().max()):.4g} px, "
              f"warped image mean {float(warped[0].float().mean()):.4g}")
        steps[name] = step
        results[name] = (flows[0].float(), metrics)
    # fp32 and bf16 agree loosely (bf16 keeps 8 bits through ~60 layers)
    rel = abs(float(results["bf16"][1]["loss"]) / float(results["fp32"][1]["loss"]) - 1)
    print(f"  bf16 vs fp32 total loss: {rel:.3g} relative")

    # batch 1 against the same weights on the CPU, through the plain versions
    cpu_model = copy.deepcopy(model).cpu()
    (cflows, _, _, _), cmetrics = make_eval_step(cpu_model)(imgs[:1].cpu(),
                                                             segs[:1].cpu())
    (gflows, _, _, _), gmetrics = steps["fp32"](imgs[:1], segs[:1])
    scale = float(cflows[0].abs().max())
    ferr = float((gflows[0].cpu() - cflows[0]).abs().max())
    print(f"  batch 1, card vs CPU (fp32, no TF32): max |Δflow| = {ferr:.3g} "
          f"at |flow| ≤ {scale:.4g} (tolerance 1e-3 of the scale)")
    require(ferr <= 1e-3 * max(scale, 1.0), "card and CPU flows disagree")
    for k in cmetrics:
        r = abs(float(gmetrics[k]) / float(cmetrics[k]) - 1)
        print(f"    {k}: card {float(gmetrics[k]):.7g}, CPU {float(cmetrics[k]):.7g}, "
              f"{r:.3g} relative (tolerance 1e-4)")
        require(r <= 1e-4, f"card and CPU {k} disagree")
    return launches, steps, imgs, segs, results["fp32"][0]


def phantom_pair_dirs(tmp):
    """fiximg/fixseg (1 phantom volume) and movimg/movseg (2) under ``tmp``:
    the real-pairs layout of the inference CLIs."""
    rng = np.random.default_rng(3)
    dirs = {}
    for name in ("fiximg", "fixseg", "movimg", "movseg"):
        dirs[name] = os.path.join(tmp, name)
        os.mkdir(dirs[name])
    for kind, n in (("fix", 1), ("mov", 2)):
        for i in range(n):
            img, seg = phantom_volume(rng)
            write_analyze(os.path.join(dirs[f"{kind}img"], f"{kind}{i}_mpr"), img)
            write_analyze(os.path.join(dirs[f"{kind}seg"], f"{kind}{i}_seg"), seg)
    return dirs


def run_cli(model, dirs, tmp):
    phase("6. inference CLI on phantom volumes, on the card")
    save_best_weights(tmp, "FlowNet2", model, {"loss": 0.0})
    reset_counts()
    results = cli_inference.main([
        "--mode", "real", "--model", "flownet2", "--batch_size", "1",
        "--fiximg_dir", dirs["fiximg"], "--fixseg_dir", dirs["fixseg"],
        "--movimg_dir", dirs["movimg"], "--movseg_dir", dirs["movseg"],
        "--workdir", tmp, "--logdir", os.path.join(tmp, "log"),
        "--max_samples", "4",
    ], device="cuda")
    torch.cuda.synchronize()
    got = counts()
    print(f"  CLI launches over 4 batches: {got}")
    require(got == {k: 4 * n for k, n in EVAL_LAUNCHES.items()}, "CLI launch counts")
    for k, v in results.items():
        require(np.isfinite(v), f"CLI metric {k} is not finite")
    return results


def bn_fed_bias(name):
    """The biases of flownet2's i_conv blocks, whose conv feeds a BatchNorm:
    in train mode the batch mean takes them out again, so their exact
    gradient is zero and what is computed is rounding noise."""
    return ".inter_conv" in name and name.endswith(".0.bias")


def gradients(model, imgs):
    """(loss, {name: gradient}) of one train step of ``model`` on ``imgs``,
    through the public train step with a zero learning rate."""
    state = create_train_state(model, learning_rate=0.0)
    metrics = make_train_step(state)(imgs)
    return float(metrics["loss"]), {n: p.grad.detach().double().cpu()
                                    for n, p in model.named_parameters()}


def train_path():
    phase("7. train path: FlowNet2 train step at 256², batch 8")
    imgs, _ = phantom_batch(BATCH, SIZE, seed=6)
    imgs = imgs.to(DEV)
    launches, steps = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        model = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(1))
        state = create_train_state(model.to(DEV))
        step = make_train_step(state, compute_dtype=dtype)
        torch.cuda.synchronize()
        reset_counts()
        metrics = step(imgs)
        torch.cuda.synchronize()
        launches[name] = counts()
        print(f"  {name}: launches in one step {launches[name]}")
        require(launches[name] == TRAIN_LAUNCHES,
                f"{name} train step should launch {TRAIN_LAUNCHES}")
        losses = [float(metrics["loss"])]
        for _ in range(4):
            losses.append(float(step(imgs)["loss"]))
        print(f"  {name}: loss over 5 steps on one batch: "
              + ", ".join(f"{v:.6g}" for v in losses))
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"{name}: the loss is not finite or does not fall")
        require(state.step == 5 and all(bool(torch.isfinite(p).all())
                                         for p in model.parameters()),
                f"{name}: step count or non-finite weights")
        steps[name] = step

    # batch 1, fp32: the card's gradients against the CPU's plain path.
    # FlowNet2's gradient at a random initialisation amplifies rounding: on
    # the CPU at 256², the fp32 gradient lies ~0.08 in relative L2 from the
    # fp64 one. So both fp32 gradients are held against the CPU's fp64 one,
    # and the card's may be at most twice as far from it as the CPU's.
    cpu_model = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(2))
    card_model = copy.deepcopy(cpu_model).to(DEV)
    fp64_model = copy.deepcopy(cpu_model).double()
    t0 = time.time()
    closs, cgrads = gradients(cpu_model, imgs[:1].cpu())
    rloss, rgrads = gradients(fp64_model, imgs[:1].cpu().double())
    print(f"  CPU plain path, batch 1, fp32 and fp64: {time.time() - t0:.1f} s")
    gloss, ggrads = gradients(card_model, imgs[:1])
    del cpu_model, card_model, fp64_model
    rel = abs(gloss / closs - 1)
    print(f"  batch 1 loss: card {gloss:.7g}, CPU {closs:.7g}, {rel:.3g} relative "
          f"(tolerance 1e-4); CPU fp64 {rloss:.9g}")
    require(rel <= 1e-4, "card and CPU train losses disagree")
    keys = [k for k in rgrads if not bn_fed_bias(k)]

    def spread(grads, ref):
        """(whole-model relative L2, per-tensor median, worst 2) of grads
        against ref; a tensor whose gradient is exactly zero on both sides
        counts as 0."""
        errs = sorted((float((grads[k] - ref[k]).norm()
                             / max(float(ref[k].norm()), 1e-30)), k) for k in keys)
        diff2 = sum(float(((grads[k] - ref[k]) ** 2).sum()) for k in keys)
        ref2 = sum(float((ref[k] ** 2).sum()) for k in keys)
        return (diff2 / ref2) ** 0.5, errs[len(errs) // 2][0], errs[-2:]

    card, cpu = spread(ggrads, rgrads), spread(cgrads, rgrads)
    for label, (whole, median, worst) in (("card fp32", card), ("CPU fp32", cpu),
                                          ("card vs CPU", spread(ggrads, cgrads))):
        print(f"  batch 1 gradients, {label}{'' if 'vs' in label else ' vs CPU fp64'}"
              f", relative L2: whole model {whole:.3g}, per tensor median "
              f"{median:.3g}, worst {worst}")
    print("  (tolerance: the card's whole-model and median errors against fp64 "
          "at most twice the CPU's)")
    require(card[0] <= 2 * cpu[0] and card[1] <= 2 * cpu[1],
            "the card's fp32 gradients are further from fp64 than the CPU's allow")
    for k in rgrads:
        if bn_fed_bias(k):
            w = k.replace(".bias", ".weight")
            require(float(ggrads[k].norm()) <= 1e-5 * float(ggrads[w].norm()),
                    f"{k}: the gradient of a bias in front of a BatchNorm is not ~0")
    return launches, steps, imgs


def gradients3d(model, make_step, vols):
    """(loss, {name: gradient}) of one 3-D train step of ``model`` on
    ``vols``, through the public step with a zero learning rate."""
    state = create_train_state(model, learning_rate=0.0, adam_eps=1e-8)
    metrics = make_step(state)(vols)
    return float(metrics["loss"]), {n: p.grad.detach().double().cpu()
                                    for n, p in model.named_parameters()}


def cpu_gradients(cpu_model, make_step, vols):
    """The CPU's loss and gradients of one step of ``cpu_model`` on
    ``vols``, in fp32 and in fp64: ((loss, grads), (loss64, grads64))."""
    fp64_model = copy.deepcopy(cpu_model).double()
    t0 = time.time()
    fp32 = gradients3d(cpu_model, make_step, vols)
    fp64 = gradients3d(fp64_model, make_step, vols.double())
    print(f"  CPU plain path, batch 1 {tuple(vols.shape[1:4])}, fp32 and fp64: "
          f"{time.time() - t0:.1f} s")
    return fp32, fp64


def gradient_distance(grads, rgrads):
    """Relative L2 distance of ``grads`` from ``rgrads``: over the whole
    model, and the median and worst over its tensors."""
    errs = sorted(float((grads[k] - rgrads[k]).norm()
                        / max(float(rgrads[k].norm()), 1e-30)) for k in rgrads)
    diff2 = sum(float(((grads[k] - rgrads[k]) ** 2).sum()) for k in rgrads)
    ref2 = sum(float((rgrads[k] ** 2).sum()) for k in rgrads)
    return (diff2 / ref2) ** 0.5, errs[len(errs) // 2], errs[-1]


def card_against_cpu(label, cpu_model, make_step, vols, cpu=None):
    """Batch 1 at a size the CPU runs quickly: the card's loss against the
    CPU's (1e-4 relative), and the card's fp32 gradient no further from the
    CPU's fp64 gradient than twice the CPU's fp32 gradient is (or 1e-5,
    where fp32 rounding alone sets the distance). ``cpu``: the CPU's
    ``cpu_gradients``, computed here when not given."""
    card_model = copy.deepcopy(cpu_model).to(DEV)
    (closs, cgrads), (rloss, rgrads) = cpu or cpu_gradients(cpu_model, make_step, vols)
    gloss, ggrads = gradients3d(card_model, make_step, vols.to(DEV))
    rel = abs(gloss / closs - 1)
    print(f"  {label} batch 1 loss: card {gloss:.9g}, CPU {closs:.9g}, {rel:.3g} "
          f"relative (tolerance 1e-4); CPU fp64 {rloss:.12g}")
    require(rel <= 1e-4, f"{label}: card and CPU losses disagree")
    card, cpu = gradient_distance(ggrads, rgrads), gradient_distance(cgrads, rgrads)
    for name, (whole, median, worst) in (("card fp32", card), ("CPU fp32", cpu)):
        print(f"  {label} batch 1 gradients, {name} vs CPU fp64, relative L2: whole "
              f"model {whole:.3g}, per tensor median {median:.3g}, worst {worst:.3g}")
    require(card[0] <= max(2 * cpu[0], 1e-5) and card[1] <= max(2 * cpu[1], 1e-5),
            f"{label}: the card's fp32 gradients are further from fp64 than the "
            "CPU's allow")


def loss_falls(label, step, vols, first):
    losses = [first] + [float(step(vols)["loss"]) for _ in range(4)]
    print(f"  {label}: loss over 5 steps on one batch: "
          + ", ".join(f"{v:.8g}" for v in losses))
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"{label}: the loss is not finite or does not fall")


def affine_path():
    phase("8b. 3-D affine path: volume synthesis and AffineNet3D train step at "
          "176 x 256 x 256, batch 2, fp32")
    raw = head_volumes(10)
    model = AffineNet3D(VOLUME_SIZE, generator=torch.Generator().manual_seed(3))
    print(f"  AffineNet3D: {sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
          f"parameters, seeded random weights")
    state = create_train_state(model.to(DEV), learning_rate=1e-4, adam_eps=1e-8)
    step = make_affine_train_step(state)
    gen = torch.Generator(device=DEV).manual_seed(11)
    torch.cuda.synchronize()
    reset_counts()
    vols = _process_volume(raw, VOLUME_SIZE, gen)["image_c"]
    metrics = step(vols)
    torch.cuda.synchronize()
    launches = counts()
    print(f"  launches in the synthesis and one step: {launches}")
    require(launches == AFFINE_LAUNCHES, f"the affine path should launch {AFFINE_LAUNCHES}")
    require(tuple(vols.shape) == (VOL_BATCH, *VOLUME_SIZE, 2)
            and float(vols.min()) == 0.0 and float(vols.max()) == 1.0,
            "synthesised volumes: shape or scaling")
    print(f"  metrics: " + ", ".join(f"{k} {float(v):.8g}" for k, v in metrics.items()))
    loss_falls("affine", step, vols, float(metrics["loss"]))
    require(state.step == 5, "affine step count")

    cpu_model = AffineNet3D((16, 64, 64), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():  # θ off the identity, a gradient to every conv
        g = torch.Generator().manual_seed(5)
        cpu_model.fc.bias.add_(torch.randn(12, generator=g) * 0.05)
        cpu_model.fc.weight.copy_(torch.randn(cpu_model.fc.weight.shape, generator=g) * 1e-3)
    card_against_cpu("affine", cpu_model, make_affine_train_step,
                     blob_volumes(1, (16, 64, 64), 12))
    return launches, step, vols


def deform_path(vols):
    phase("8c. 3-D deform path: VoxelMorph3D train step at 176 x 256 x 256, "
          "batch 2, fp32")
    model = VoxelMorph3D(generator=torch.Generator().manual_seed(6))
    # the velocity head at N(0, 1e-2²) in place of N(0, 1e-5²): from flows of
    # 1e-5 voxel the smoothness Charbonnier sits on its |x|^1/2 cusp, and the
    # first Adam step (every weight moves by about lr) raises it more than
    # the data terms fall (on the CPU at 32 x 64 x 64: +908, then -200 a
    # step); from flows of ~1e-2 voxel the loss falls from the first step
    with torch.no_grad():
        model.flow_head.weight.mul_(1e3)
    print(f"  VoxelMorph3D at full width: "
          f"{sum(p.numel() for p in model.parameters()) / 1e3:.3f} k parameters, "
          f"seeded random weights, velocity head scaled by 1e3")
    state = create_train_state(model.to(DEV), learning_rate=1e-4, adam_eps=1e-8)
    step = make_deform3d_train_step(state)
    torch.cuda.synchronize()
    reset_counts()
    metrics = step(vols)
    torch.cuda.synchronize()
    launches = counts()
    print(f"  launches in one step: {launches}")
    require(launches == DEFORM_LAUNCHES, f"the deform step should launch {DEFORM_LAUNCHES}")
    print(f"  metrics: " + ", ".join(f"{k} {float(v):.8g}" for k, v in metrics.items()))
    loss_falls("deform", step, vols, float(metrics["loss"]))
    require(state.step == 5 and all(bool(torch.isfinite(p).all())
                                    for p in model.parameters()),
            "deform: step count or non-finite weights")
    with torch.no_grad():
        flow, warped, velocity = model(vols.permute(0, 4, 1, 2, 3).contiguous())
    require(tuple(flow.shape) == (VOL_BATCH, 3, *VOLUME_SIZE)
            and tuple(warped.shape) == (VOL_BATCH, 1, *VOLUME_SIZE)
            and bool(torch.isfinite(flow).all()) and bool(torch.isfinite(warped).all()),
            "deform: flow or warped volume shape, or non-finite")
    print(f"  after 5 steps: |flow| max {float(flow.abs().max()):.4g} voxels")

    cpu_model = VoxelMorph3D(generator=torch.Generator().manual_seed(7))
    with torch.no_grad():  # flows of about a voxel, off the voxel grid
        cpu_model.flow_head.weight.mul_(3e4)
    card_against_cpu("deform", cpu_model, make_deform3d_train_step,
                     blob_volumes(1, (32, 64, 64), 13))
    return launches, step, flow, velocity


def run_3d_cli():
    phase("8d. 3-D CLI: --stage affine on 10 phantom volumes, --stage deform "
          "--synthetic 2")
    rng = np.random.default_rng(14)
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(10):
            write_analyze(os.path.join(tmp, f"vol{i:02d}_mpr"), phantom_volume(rng)[0])
        runs = {}
        for stage, extra, want in (
                ("affine", ["--img_dir", tmp],
                 {k: 4 * n for k, n in AFFINE_LAUNCHES.items()}),
                ("deform", ["--synthetic", "2"],
                 {k: 2 * n for k, n in DEFORM_LAUNCHES.items()})):
            out = io.StringIO()
            reset_counts()
            t0 = time.time()
            with contextlib.redirect_stdout(out):
                state = cli_train_affine.main(["--stage", stage, "--epochs", "1",
                                               *extra], device="cuda")
            torch.cuda.synchronize()
            got = counts()
            runs[stage] = out.getvalue()
            print(f"  --stage {stage} {' '.join(extra[:1])}: {time.time() - t0:.1f} s, "
                  f"{state.step} steps, launches {got}")
            for line in runs[stage].splitlines():
                print(f"    {line}")
            # 8 training volumes of 10 make 4 batches of 2; 2 synthetic batches
            require(got == want and state.step == (4 if stage == "affine" else 2),
                    f"--stage {stage}: launches or steps")
            tag = stage.upper()
            require(f"[{tag} epoch 1/1] loss" in runs[stage], f"--stage {stage} output")


def card_against_cpu_registration(label, register, fixed, moving, mask, ncc):
    """One registration on the card and the same on the CPU's plain path,
    on the same inputs. Adam with eps 1e-8 steps each pixel by about lr
    whatever the size of its gradient, and K5 and K6c sum with atomics in an
    order that changes from run to run, so the two may part where a gradient
    is within rounding of zero: the flows must agree to 0.1 px anywhere and
    2e-3 px on average, the warped images to 1e-3 on average, and the local
    NCC each reaches to 1e-3. Returns the card's (flow, warped)."""
    flow, warped = register(fixed, moving, mask)
    cflow, cwarped = register(fixed.cpu(), moving.cpu(),
                              None if mask is None else mask.cpu())
    torch.cuda.synchronize()
    dflow = (flow.cpu() - cflow).abs()
    dwarp = (warped.cpu() - cwarped).abs()
    cpu_mask = None if mask is None else mask.cpu()
    n_card = float(ncc(fixed.cpu(), warped.cpu(), cpu_mask))
    n_cpu = float(ncc(fixed.cpu(), cwarped, cpu_mask))
    print(f"  {label} card vs CPU: |Δflow| max {float(dflow.max()):.3g} px, mean "
          f"{float(dflow.mean()):.3g} (|flow| ≤ {float(cflow.abs().max()):.4g}); "
          f"|Δwarped| max {float(dwarp.max()):.3g}, mean {float(dwarp.mean()):.3g}; "
          f"local NCC card {n_card:.6f}, CPU {n_cpu:.6f} (tolerances 0.1 and 2e-3 px, "
          f"1e-3, 1e-3)")
    require(float(dflow.max()) <= 0.1 and float(dflow.mean()) <= 2e-3
            and float(dwarp.mean()) <= 1e-3 and abs(n_card - n_cpu) <= 1e-3,
            f"{label}: the card's registration and the CPU's disagree")
    return flow, warped


def syn_pair():
    """A phantom slice [1, 1, 256, 256] and its elastic deformation (control
    offsets of 2 px every 16 px, made on the CPU), on the card, with the
    mask fixed > 0."""
    imgs, _ = phantom_batch(1, SIZE, seed=40)
    fixed = imgs[..., 0][:, None].contiguous()
    moving, _ = rand_elastic_2d(fixed, magnitude_range=(2.0, 2.0),
                                generator=torch.Generator().manual_seed(41))
    fixed, moving = fixed.to(DEV), moving.to(DEV)
    return fixed, moving, (fixed > 0).float()


def syn_path():
    phase("8e. 2-D SyN: register_syn at 256², batch 1, (10, 0, 0), masked")
    fixed, moving, mask = syn_pair()
    torch.cuda.synchronize()
    reset_counts()
    flow, warped = register_syn(fixed, moving, mask, (10, 0, 0))
    torch.cuda.synchronize()
    launches = counts()
    print(f"  launches in one registration: {launches}")
    require(launches == SYN_LAUNCHES, f"register_syn should launch {SYN_LAUNCHES}")
    require(tuple(flow.shape) == (1, 2, SIZE, SIZE) and tuple(warped.shape) == (1, 1, SIZE, SIZE)
            and bool(torch.isfinite(flow).all()) and bool(torch.isfinite(warped).all())
            and flow.grad_fn is None, "register_syn: shapes, finiteness or autograd history")
    before = float(local_ncc(fixed, moving, mask))
    after = float(local_ncc(fixed, warped, mask))
    print(f"  local NCC (masked): identity {before:.6f}, registered {after:.6f}; "
          f"|flow| max {float(flow.abs().max()):.4g} px")
    require(after > before, "register_syn did not raise the local NCC")
    card_against_cpu_registration(
        "register_syn 256²", lambda f, m, k: register_syn(f, m, k, (10, 0, 0)),
        fixed, moving, mask, local_ncc)
    return launches, (fixed, moving, mask), flow


def identity_dice(loader, n):
    """Mean Dice of the moving segmentation against the fixed one over the
    first ``n`` pairs of ``loader`` (batch 1)."""
    scores = []
    for batch in loader:
        segs = batch["seg_c"].cpu().numpy()
        scores.append(dice_average(segs[0, ..., 0], segs[0, ..., 1]))
        if len(scores) == n:
            break
    return float(np.mean(scores))


def run_ants_cli(dirs):
    phase("8f. comparator CLI (tpureg_torch.cli.inference_ants) on phase 6's "
          "phantom volumes, --mode real and --mode synthetic")
    n = 3
    for mode, args, loader in (
            ("real", ["--fiximg_dir", dirs["fiximg"], "--fixseg_dir", dirs["fixseg"],
                      "--movimg_dir", dirs["movimg"], "--movseg_dir", dirs["movseg"]],
             real_pairs_dataset(dirs["fiximg"], dirs["fixseg"], dirs["movimg"],
                                dirs["movseg"], 1, device=DEV)[0]),
            ("synthetic", ["--img_dir", dirs["movimg"], "--seg_dir", dirs["movseg"]],
             eval_random_dataset(dirs["movimg"], dirs["movseg"], 1, DEV, seed=8)[0])):
        out = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            results = cli_ants.main(["--mode", mode, "--max_samples", str(n), *args],
                                    device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        ident = identity_dice(loader, n)
        print(f"  --mode {mode}, {n} pairs: {wall:.2f} s, {n / wall:.3f} pairs/s "
              f"(registration and the host's metric suite); launches {got}")
        print("    " + ", ".join(f"{k} {v:.5f}" for k, v in results.items()))
        print(f"    identity's mean Dice on the same pairs: {ident:.5f}")
        # once a pair; --mode synthetic also makes each batch's moving image
        # by the elastic synthesis (one K3 a batch of 1)
        want = {k: n * c + (n if mode == "synthetic" and k == "warp2d" else 0)
                for k, c in SYN_LAUNCHES.items()}
        require(got == want, f"--mode {mode}: the CLI should launch {want}")
        require(all(np.isfinite(v) for v in results.values()) and len(results) == 8,
                f"--mode {mode}: metrics missing or not finite")
        require(results["dice"] > ident, f"--mode {mode}: SyN's Dice is not above identity's")


def syn3d_volumes(size, seed):
    """Two phantom heads resized (trilinear) to ``size`` and min-max scaled:
    fixed and moving, each [1, 1, D, H, W] on the card."""
    raw = head_volumes(seed)
    vols = _minmax_scale_volume(resize_nd(raw[:, None], size, "linear"))
    return vols[0:1].contiguous(), vols[1:2].contiguous()


def syn3d_path():
    phase("8g. 3-D SyN: register_syn3d at 176 x 256 x 256, batch 1, (30, 20, 10)")
    fixed, moving = syn3d_volumes(VOLUME_SIZE, 42)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    flow, warped = register_syn3d(fixed, moving)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    print(f"  launches in one registration: {launches}")
    require(launches == SYN3D_LAUNCHES, f"register_syn3d should launch {SYN3D_LAUNCHES}")
    require(tuple(flow.shape) == (1, 3, *VOLUME_SIZE) and bool(torch.isfinite(flow).all())
            and bool(torch.isfinite(warped).all()), "register_syn3d: shape or non-finite")
    neg = neg_jacobian_fraction(flow[0].permute(1, 2, 3, 0).cpu().numpy())
    before = float(local_ncc3d(fixed, moving))
    after = float(local_ncc3d(fixed, warped))
    print(f"  first call {wall:.3f} s (peak memory: phase 9); |flow| max "
          f"{float(flow.abs().max()):.4g} voxels; negative-Jacobian fraction {neg:.3g}; "
          f"local NCC identity {before:.6f}, registered {after:.6f}")
    require(after > before, "register_syn3d did not raise the local NCC")
    small = syn3d_volumes((32, 64, 64), 43)
    card_against_cpu_registration(
        "register_syn3d 32 x 64 x 64, (10, 0, 0)",
        lambda f, m, k: register_syn3d(f, m, k, (10, 0, 0)), *small, None, local_ncc3d)
    return launches, (fixed, moving), flow


def cli_summary(text):
    """The epoch, checkpoint and summary lines of a CLI's output."""
    keep = ("EPOCH", "===>", "saving", "loading", "complete", "summary")
    return [line for line in text.splitlines() if any(k in line for k in keep)]


def training_volume_dirs(tmp):
    """img/ and seg/ under ``tmp`` holding 10 phantom volumes: the training
    CLI's corpus (8 training volumes of 80 slices)."""
    rng = np.random.default_rng(9)
    dirs = {name: os.path.join(tmp, name) for name in ("img", "seg")}
    for d in dirs.values():
        os.mkdir(d)
    for i in range(10):
        img, seg = phantom_volume(rng)
        write_analyze(os.path.join(dirs["img"], f"vol{i:02d}_mpr"), img)
        write_analyze(os.path.join(dirs["seg"], f"vol{i:02d}_seg"), seg)
    return dirs


def train_cli_and_resume(model, dirs, workdir):
    """The training CLI on ``dirs``' volumes for one epoch, then ``--cp 1``
    to two epochs, which must skip the first; returns the final state."""
    common = ["--model", model, "--img_dir", dirs["img"], "--seg_dir", dirs["seg"],
              "--batch_size", str(BATCH), "--workdir", workdir, "--logdir",
              os.path.join(workdir, "log")]
    runs = {}
    for label, extra in (("train", ["--epochs", "1", "--cp", "0"]),
                         ("resume", ["--epochs", "2", "--cp", "1"])):
        out = io.StringIO()
        reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            state = cli_train.main(common + extra, device="cuda")
        torch.cuda.synchronize()
        runs[label] = out.getvalue()
        print(f"  {model} {label} ({' '.join(extra)}): {time.time() - t0:.1f} s, "
              f"{state.step} steps in all, launches {counts()}")
        for line in cli_summary(runs[label]):
            print(f"    {line}")
    require("EPOCH 1/1" in runs["train"] and "saving new best weights" in runs["train"],
            "the first training run did not train or save")
    require("loading checkpoint state" in runs["resume"]
            and "EPOCH 1/2" not in runs["resume"] and "EPOCH 2/2" in runs["resume"],
            "the resume did not skip the finished epoch")
    require(state.step == 2 * 80, "8 training volumes of 80 slices make 80 steps an epoch")
    return state


def synthetic_eval_cli(model, dirs, workdir):
    """The inference CLI in ``--mode synthetic`` on the best weights under
    ``workdir``: 8 samples in batches of 4; returns the launches."""
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = cli_inference.main([
            "--mode", "synthetic", "--model", model, "--batch_size", "4",
            "--img_dir", dirs["img"], "--seg_dir", dirs["seg"], "--workdir", workdir,
            "--logdir", os.path.join(workdir, "log"), "--max_samples", "8",
        ], device="cuda")
    torch.cuda.synchronize()
    got = counts()
    print(f"  {model} inference --mode synthetic on the best weights, 8 samples: "
          f"launches {got}")
    for line in cli_summary(out.getvalue()):
        print(f"    {line}")
    for k, v in results.items():
        require(np.isfinite(v), f"CLI metric {k} is not finite")
    return got


def run_train_cli(dirs):
    phase("8. training CLI on 10 phantom volumes, resume, inference --mode synthetic")
    with tempfile.TemporaryDirectory() as tmp:
        train_cli_and_resume("flownet2", dirs, tmp)
        synthetic_eval_cli("flownet2", dirs, tmp)


def check_flows(label, got, want):
    """Card against CPU: each flow within 1e-3 of its scale (at least 1 px)."""
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        err = float((g.float().cpu() - w).abs().max())
        print(f"  {label} flow {i} {tuple(w.shape)}: max |Δ| = {err:.3g} at |flow| ≤ "
              f"{scale:.4g} (tolerance 1e-3 of the scale)")
        require(err <= 1e-3 * max(scale, 1.0), f"{label}: card and CPU flows disagree")


def conv_flops(model, x):
    """FLOP (two a multiply-add) of the convolutions, transposed ones
    included, in one forward of ``model`` on ``x``, from the layers'
    shapes."""
    total = []

    def count(m, inputs, out):
        k = m.weight[0, 0].numel()
        if isinstance(m, torch.nn.ConvTranspose2d):
            total.append(2 * inputs[0].numel() * m.weight.shape[1] * k)
        else:
            total.append(2 * out.numel() * m.weight.shape[1] * k)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return sum(total)


def pwc_path(pair_dirs, train_dirs):
    phase("8h. PWC family: pwc-reg eval and train steps at 256², batch 8, fp32 "
          "and bf16; card against CPU; both 2-D CLIs")
    loss_kwargs = default_loss_kwargs("pwc-reg")
    n = {name: sum(p.numel() for p in build_predictor(name).parameters())
         for name in ("pwc-reg", "pwc", "pwc-old")}
    print(f"  parameters: pwc-reg {n['pwc-reg']}, pwc and pwc-bilinear {n['pwc']}, "
          f"pwc-old {n['pwc-old']}; seeded random weights; the loss takes the "
          f"finest {loss_kwargs['num_scales']} flows")
    model = OpticalFlowReg("pwc-reg", generator=torch.Generator().manual_seed(20))
    model.to(DEV)
    imgs, segs = phantom_batch(BATCH, SIZE, seed=21)
    imgs, segs = imgs.to(DEV), segs.to(DEV)
    sizes = [SIZE >> i for i in range(7)]
    eval_launches, eval_steps = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        step = make_eval_step(model, loss_kwargs, dtype)
        torch.cuda.synchronize()
        reset_counts()
        (flows, warped, wsegs, grid), metrics = step(imgs, segs)
        torch.cuda.synchronize()
        eval_launches[name] = counts()
        print(f"  eval {name}: launches {eval_launches[name]}; loss "
              f"{float(metrics['loss']):.6g}; |flow0| max "
              f"{float(flows[0].float().abs().max()):.4g} px")
        require(eval_launches[name] == PWC_EVAL_LAUNCHES,
                f"pwc-reg's {name} eval step should launch {PWC_EVAL_LAUNCHES}")
        require([tuple(f.shape) for f in flows] == [(BATCH, n, n, 2) for n in sizes]
                and [tuple(w.shape) for w in warped] == [(BATCH, n, n, 1) for n in sizes]
                and wsegs.shape == grid.shape == (BATCH, SIZE, SIZE, 1),
                "pwc-reg: output shapes")
        for t in (*flows, *warped, wsegs, grid, *metrics.values()):
            require(bool(torch.isfinite(t.float()).all()), f"pwc-reg {name}: non-finite output")
        require(set(torch.unique(wsegs).tolist()) <= {0.0, 1.0, 2.0, 3.0},
                "warped labels outside 0..3")
        eval_steps[name] = step

    train_launches, train_steps = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        tmodel = OpticalFlowReg("pwc-reg", generator=torch.Generator().manual_seed(22))
        state = create_train_state(tmodel.to(DEV))
        step = make_train_step(state, loss_kwargs, dtype)
        torch.cuda.synchronize()
        reset_counts()
        metrics = step(imgs)
        torch.cuda.synchronize()
        train_launches[name] = counts()
        print(f"  train {name}: launches in one step {train_launches[name]}")
        require(train_launches[name] == PWC_TRAIN_LAUNCHES,
                f"pwc-reg's {name} train step should launch {PWC_TRAIN_LAUNCHES}")
        loss_falls(f"pwc-reg train {name}", step, imgs, float(metrics["loss"]))
        require(state.step == 5 and all(bool(torch.isfinite(p).all())
                                         for p in tmodel.parameters()),
                f"pwc-reg {name}: step count or non-finite weights")
        train_steps[name] = step

    # batch 1 against the same weights on the CPU, through the plain versions
    cpu_model = copy.deepcopy(model).cpu()
    flops = conv_flops(cpu_model.eval(), imgs[:1].cpu())
    print(f"  pwc-reg's convolutions: {flops / 1e9:.3f} GFLOP a pair forward at 256², "
          f"{BATCH * flops / 1e9:.3f} at batch {BATCH}")
    (cflows, _, _, _), cmetrics = make_eval_step(cpu_model, loss_kwargs)(
        imgs[:1].cpu(), segs[:1].cpu())
    (gflows, _, _, _), gmetrics = eval_steps["fp32"](imgs[:1], segs[:1])
    check_flows("pwc-reg eval, batch 1, card vs CPU (fp32, no TF32),", gflows, cflows)
    for k in cmetrics:
        r = abs(float(gmetrics[k]) / float(cmetrics[k]) - 1)
        print(f"    {k}: card {float(gmetrics[k]):.7g}, CPU {float(cmetrics[k]):.7g}, "
              f"{r:.3g} relative (tolerance 1e-4)")
        require(r <= 1e-4, f"pwc-reg: card and CPU {k} disagree")
    card_against_cpu("pwc-reg", OpticalFlowReg(
        "pwc-reg", generator=torch.Generator().manual_seed(23)),
        lambda st: make_train_step(st, loss_kwargs), imgs[:1].cpu())
    for name in ("pwc", "pwc-bilinear"):
        net = OpticalFlowReg(name, generator=torch.Generator().manual_seed(24))
        want = make_eval_step(net, loss_kwargs)(imgs[:1].cpu(), segs[:1].cpu())[0][0]
        got = make_eval_step(copy.deepcopy(net).to(DEV), loss_kwargs)(
            imgs[:1], segs[:1])[0][0]
        check_flows(f"{name} eval, batch 1, card vs CPU,", got, want)
    # pwc-old, the module alone on a 6-channel pair: train mode gives 5
    # flows, eval mode the bare flow2
    old = build_predictor("pwc-old", generator=torch.Generator().manual_seed(25))
    pair = imgs[:1].permute(0, 3, 1, 2).cpu()
    noise = torch.rand((1, 6, SIZE, SIZE), generator=torch.Generator().manual_seed(26))
    x = torch.cat([pair[:, :1]] * 3 + [pair[:, 1:]] * 3, 1) + 0.05 * noise
    card_old = copy.deepcopy(old).to(DEV)
    for train in (True, False):
        with torch.no_grad():
            want = old.train(train)(x)
            got = card_old.train(train)(x.to(DEV))
        if not train:
            require(isinstance(got, torch.Tensor), "pwc-old eval returns a bare flow2")
            got, want = (got,), (want,)
        require(len(got) == (5 if train else 1), "pwc-old: number of flows")
        check_flows(f"pwc-old {'train' if train else 'eval'} mode, card vs CPU,", got, want)

    # both 2-D CLIs with --model pwc-reg
    with tempfile.TemporaryDirectory() as work:
        train_cli_and_resume("pwc-reg", train_dirs, work)
        require(os.path.isfile(best_weight_path(work, "PWCDCNet")),
                "the training CLI did not save pwc-reg's best weights under PWCDCNet")
        real_eval_cli("pwc-reg", pair_dirs, work, PWC_EVAL_LAUNCHES)
        got = synthetic_eval_cli("pwc-reg", train_dirs, work)
        require(got["correlation"] == 2 * 5 and got["correlation_bwd"] == 0
                and got["warp2d_dpos"] == 0 and got["warp2d_dimg"] == 0,
                "pwc-reg inference --mode synthetic: launch counts")
    return ({"eval": eval_launches, "train": train_launches},
            {"eval": eval_steps, "train": train_steps}, imgs, segs)


def raft_path(pair_dirs, train_dirs):
    phase("8i. RAFT: raft-reg eval and train steps at 256², batch 8, fp32 and bf16; "
          "raft's; card against CPU; both 2-D CLIs with raft-reg")
    loss_kwargs = default_loss_kwargs("raft-reg")  # None: all 5 flows, ascending
    n = {name: sum(p.numel() for p in build_predictor(name).parameters())
         for name in ("raft-reg", "raft")}
    print(f"  parameters: raft-reg {n['raft-reg']}, raft {n['raft']}; seeded random "
          f"weights; 5 iterations; the loss reads all 5 flows, ascending weights")
    model = OpticalFlowReg("raft-reg", generator=torch.Generator().manual_seed(30))
    model.to(DEV)
    imgs, segs = phantom_batch(BATCH, SIZE, seed=31)
    imgs, segs = imgs.to(DEV), segs.to(DEV)
    eval_launches, eval_steps = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        step = make_eval_step(model, loss_kwargs, dtype)
        torch.cuda.synchronize()
        reset_counts()
        (flows, warped, wsegs, grid), metrics = step(imgs, segs)
        torch.cuda.synchronize()
        eval_launches[name] = counts()
        print(f"  eval {name}: launches {eval_launches[name]}; loss "
              f"{float(metrics['loss']):.6g}; |flow0| max "
              f"{float(flows[0].float().abs().max()):.4g} px")
        require(eval_launches[name] == RAFT_REG_EVAL_LAUNCHES,
                f"raft-reg's {name} eval step should launch {RAFT_REG_EVAL_LAUNCHES}")
        require(len(flows) == len(warped) == 5
                and all(tuple(f.shape) == (BATCH, SIZE, SIZE, 2) for f in flows)
                and all(tuple(w.shape) == (BATCH, SIZE, SIZE, 1) for w in warped)
                and wsegs.shape == grid.shape == (BATCH, SIZE, SIZE, 1),
                "raft-reg: output shapes")
        for t in (*flows, *warped, wsegs, grid, *metrics.values()):
            require(bool(torch.isfinite(t.float()).all()), f"raft-reg {name}: non-finite output")
        require(set(torch.unique(wsegs).tolist()) <= {0.0, 1.0, 2.0, 3.0},
                "warped labels outside 0..3")
        eval_steps[name] = step

    train_launches, train_steps = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        tmodel = OpticalFlowReg("raft-reg", generator=torch.Generator().manual_seed(32))
        state = create_train_state(tmodel.to(DEV))
        step = make_train_step(state, loss_kwargs, dtype)
        torch.cuda.synchronize()
        reset_counts()
        metrics = step(imgs)
        torch.cuda.synchronize()
        train_launches[name] = counts()
        print(f"  train {name}: launches in one step {train_launches[name]}")
        require(train_launches[name] == RAFT_REG_TRAIN_LAUNCHES,
                f"raft-reg's {name} train step should launch {RAFT_REG_TRAIN_LAUNCHES}")
        loss_falls(f"raft-reg train {name}", step, imgs, float(metrics["loss"]))
        require(state.step == 5 and all(bool(torch.isfinite(p).all())
                                         for p in tmodel.parameters()),
                f"raft-reg {name}: step count or non-finite weights")
        train_steps[name] = step

    # batch 1 against the same weights on the CPU, through the plain versions
    cpu_model = copy.deepcopy(model).cpu()
    flops = conv_flops(cpu_model.eval(), imgs[:1].cpu())
    print(f"  raft-reg's convolutions: {flops / 1e9:.3f} GFLOP a pair forward at 256², "
          f"{BATCH * flops / 1e9:.3f} at batch {BATCH} (the correlation's product "
          f"{2 * (SIZE // 4) ** 4 * 128 / 1e9:.3f} GFLOP a pair beside them)")
    (cflows, _, _, _), cmetrics = make_eval_step(cpu_model, loss_kwargs)(
        imgs[:1].cpu(), segs[:1].cpu())
    (gflows, _, _, _), gmetrics = eval_steps["fp32"](imgs[:1], segs[:1])
    check_flows("raft-reg eval, batch 1, card vs CPU (fp32, no TF32),", gflows, cflows)
    for k in cmetrics:
        r = abs(float(gmetrics[k]) / float(cmetrics[k]) - 1)
        print(f"    {k}: card {float(gmetrics[k]):.7g}, CPU {float(cmetrics[k]):.7g}, "
              f"{r:.3g} relative (tolerance 1e-4)")
        require(r <= 1e-4, f"raft-reg: card and CPU {k} disagree")
    # the fp32-gradient rule, held with PyTorch's own CUDA convolutions:
    # with cuDNN's (whose backward of RAFT's convolutions runs as FFTs at
    # batch 8, PERF.md §5) the card's fp32 gradient lies about 3 times the
    # CPU's distance from fp64, without cuDNN as far as the CPU's, so the
    # distance is cuDNN's algorithms and not the port's kernels (PERF.md
    # §6); the cuDNN run's distance is printed beside the held one
    net = OpticalFlowReg("raft-reg", generator=torch.Generator().manual_seed(33))
    step_of = lambda st: make_train_step(st, loss_kwargs)
    cpu = cpu_gradients(net, step_of, imgs[:1].cpu())
    with torch.backends.cudnn.flags(enabled=False):
        card_against_cpu("raft-reg (convolutions without cuDNN)", net, step_of,
                         imgs[:1].cpu(), cpu)
    _, ggrads = gradients3d(copy.deepcopy(net).to(DEV), step_of, imgs[:1])
    whole, median, worst = gradient_distance(ggrads, cpu[1][1])
    print(f"  raft-reg (cuDNN's convolutions, not held) batch 1 gradients, card fp32 "
          f"vs CPU fp64, relative L2: whole model {whole:.3g}, per tensor median "
          f"{median:.3g}, worst {worst:.3g}")

    # raft, 1/8 resolution: eval at batch 1 against the CPU; one eval and
    # one train step at batch 8 for its launches
    net = OpticalFlowReg("raft", generator=torch.Generator().manual_seed(34))
    want = make_eval_step(net, loss_kwargs)(imgs[:1].cpu(), segs[:1].cpu())[0][0]
    card_net = copy.deepcopy(net).to(DEV)
    got = make_eval_step(card_net, loss_kwargs)(imgs[:1], segs[:1])[0][0]
    check_flows("raft eval, batch 1, card vs CPU,", got, want)
    torch.cuda.synchronize()
    reset_counts()
    make_eval_step(card_net, loss_kwargs)(imgs, segs)
    torch.cuda.synchronize()
    raft_eval = counts()
    reset_counts()
    metrics = make_train_step(create_train_state(card_net), loss_kwargs)(imgs)
    torch.cuda.synchronize()
    raft_train = counts()
    print(f"  raft at batch {BATCH}: eval step launches {raft_eval}; train step "
          f"{raft_train}; loss {float(metrics['loss']):.6g}")
    require(raft_eval == RAFT_EVAL_LAUNCHES and raft_train == RAFT_TRAIN_LAUNCHES,
            f"raft's steps should launch {RAFT_EVAL_LAUNCHES} and {RAFT_TRAIN_LAUNCHES}")
    require(bool(torch.isfinite(metrics["loss"])), "raft: non-finite loss")
    del card_net, net

    # both 2-D CLIs with --model raft-reg
    with tempfile.TemporaryDirectory() as work:
        train_cli_and_resume("raft-reg", train_dirs, work)
        require(os.path.isfile(best_weight_path(work, "RAFT")),
                "the training CLI did not save raft-reg's best weights under RAFT")
        real_eval_cli("raft-reg", pair_dirs, work, RAFT_REG_EVAL_LAUNCHES)
        got = synthetic_eval_cli("raft-reg", train_dirs, work)
        # 2 batches of 4: each eval step's launches and one K3 in the
        # batch's elastic synthesis
        require(got == launches_of(warp2d=2 * (RAFT_REG_EVAL_LAUNCHES["warp2d"] + 1)),
                "raft-reg inference --mode synthetic: launch counts")
    return ({"eval": eval_launches, "train": train_launches},
            {"eval": eval_steps, "train": train_steps}, imgs, segs)


def real_eval_cli(model, pair_dirs, work, launches):
    """The inference CLI in ``--mode real`` on the best weights under
    ``work``, 4 pairs at batch 1: each pair's eval step launches
    ``launches``; every metric finite."""
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = cli_inference.main([
            "--mode", "real", "--model", model, "--batch_size", "1",
            "--fiximg_dir", pair_dirs["fiximg"], "--fixseg_dir", pair_dirs["fixseg"],
            "--movimg_dir", pair_dirs["movimg"], "--movseg_dir", pair_dirs["movseg"],
            "--workdir", work, "--logdir", os.path.join(work, "log_eval"),
            "--max_samples", "4"], device="cuda")
    torch.cuda.synchronize()
    got = counts()
    print(f"  {model} inference --mode real on the best weights, 4 pairs: "
          f"launches {got}")
    for line in cli_summary(out.getvalue()):
        print(f"    {line}")
    require("loaded best weights ({" in out.getvalue()
            and got == {k: 4 * n for k, n in launches.items()},
            f"{model} inference --mode real: weights or launch counts")
    require(all(np.isfinite(v) for v in results.values()),
            f"{model} inference --mode real: a metric is not finite")


def supervised_gradients(model, units, imgs, disp):
    """({"epe", "epe0"}, {name: gradient}) of one flow-supervised step of
    ``model`` on ``imgs``, ``disp``, through the public step with a zero
    learning rate."""
    state = create_train_state(model, learning_rate=0.0)
    metrics = make_flow_supervised_step(state, flow_units=units)(imgs, disp)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()})


def hold_fp32_gradients(label, card, cpu32, cpu64):
    """The card's fp32 gradient against the CPU's fp64 one by the CPU
    tests' fp32 rule (tests/test_torch_train.py): relative L2 at most 1e-2
    over the model and 3e-2 in every tensor; the CPU's fp32 distance is
    printed beside it."""
    got, ref = gradient_distance(card, cpu64), gradient_distance(cpu32, cpu64)
    for name, (whole, median, worst) in (("card fp32", got), ("CPU fp32", ref)):
        print(f"  {label} batch 1 gradients, {name} vs CPU fp64, relative L2: whole "
              f"model {whole:.3g}, per tensor median {median:.3g}, worst {worst:.3g}")
    require(got[0] <= 1e-2 and got[2] <= 3e-2,
            f"{label}: the card's fp32 gradients are further from fp64 than 1e-2 "
            "over the model or 3e-2 in a tensor")


def flownets_path(pair_dirs, train_dirs):
    phase("8j. FlowNetS (pinard): eval and train steps at 256², batch 8, fp32 and "
          "bf16; the flow-supervised step; card against CPU; the rest of the 2-D "
          "zoo; both 2-D CLIs with flownets")
    n = sum(p.numel() for p in build_predictor("flownets").parameters())
    print(f"  FlowNetS (pinard, with BatchNorm): {n} parameters; seeded random "
          f"weights; the loss reads all 6 flows")
    model = OpticalFlowReg("flownets", generator=torch.Generator().manual_seed(40))
    model.to(DEV)
    imgs, segs = phantom_batch(BATCH, SIZE, seed=41)
    imgs, segs = imgs.to(DEV), segs.to(DEV)
    eval_launches, eval_steps = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        step = make_eval_step(model, compute_dtype=dtype)
        torch.cuda.synchronize()
        reset_counts()
        (flows, warped, wsegs, grid), metrics = step(imgs, segs)
        torch.cuda.synchronize()
        eval_launches[name] = counts()
        print(f"  eval {name}: launches {eval_launches[name]}; loss "
              f"{float(metrics['loss']):.6g}; |flow0| max "
              f"{float(flows[0].float().abs().max()):.4g} px")
        require(eval_launches[name] == FLOWNETS_EVAL_LAUNCHES,
                f"flownets' {name} eval step should launch {FLOWNETS_EVAL_LAUNCHES}")
        require([tuple(f.shape) for f in flows] == [(BATCH, SIZE, SIZE, 2),
                                                    (BATCH, SIZE // 4, SIZE // 4, 2)]
                and [tuple(w.shape) for w in warped] == [(BATCH, SIZE, SIZE, 1),
                                                         (BATCH, SIZE // 4, SIZE // 4, 1)]
                and wsegs.shape == grid.shape == (BATCH, SIZE, SIZE, 1),
                "flownets: output shapes")
        for t in (*flows, *warped, wsegs, grid, *metrics.values()):
            require(bool(torch.isfinite(t.float()).all()), f"flownets {name}: non-finite output")
        require(set(torch.unique(wsegs).tolist()) <= {0.0, 1.0, 2.0, 3.0},
                "warped labels outside 0..3")
        eval_steps[name] = step

    train_launches, train_steps = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        tmodel = OpticalFlowReg("flownets", generator=torch.Generator().manual_seed(42))
        state = create_train_state(tmodel.to(DEV))
        step = make_train_step(state, compute_dtype=dtype)
        torch.cuda.synchronize()
        reset_counts()
        metrics = step(imgs)
        torch.cuda.synchronize()
        train_launches[name] = counts()
        print(f"  train {name}: launches in one step {train_launches[name]}")
        require(train_launches[name] == FLOWNETS_TRAIN_LAUNCHES,
                f"flownets' {name} train step should launch {FLOWNETS_TRAIN_LAUNCHES}")
        loss_falls(f"flownets train {name}", step, imgs, float(metrics["loss"]))
        require(state.step == 5 and all(bool(torch.isfinite(p).all())
                                         for p in tmodel.parameters()),
                f"flownets {name}: step count or non-finite weights")
        train_steps[name] = step

    # batch 1 against the same weights on the CPU, through the plain versions
    cpu_model = copy.deepcopy(model).cpu()
    flops = conv_flops(cpu_model.eval(), imgs[:1].cpu())
    print(f"  flownets' convolutions: {flops / 1e9:.3f} GFLOP a pair forward at 256², "
          f"{BATCH * flops / 1e9:.3f} at batch {BATCH}")
    (cflows, _, _, _), cmetrics = make_eval_step(cpu_model)(imgs[:1].cpu(),
                                                             segs[:1].cpu())
    (gflows, _, _, _), gmetrics = eval_steps["fp32"](imgs[:1], segs[:1])
    check_flows("flownets eval, batch 1, card vs CPU (fp32, no TF32),", gflows, cflows)
    for k in cmetrics:
        r = abs(float(gmetrics[k]) / float(cmetrics[k]) - 1)
        print(f"    {k}: card {float(gmetrics[k]):.7g}, CPU {float(cmetrics[k]):.7g}, "
              f"{r:.3g} relative (tolerance 1e-4)")
        require(r <= 1e-4, f"flownets: card and CPU {k} disagree")
    # the fp32-gradient rule with cuDNN's convolutions, as the step runs;
    # the distance without cuDNN is printed beside it
    net = OpticalFlowReg("flownets", generator=torch.Generator().manual_seed(43))
    step_of = lambda st: make_train_step(st)
    cpu = cpu_gradients(net, step_of, imgs[:1].cpu())
    card_against_cpu("flownets", net, step_of, imgs[:1].cpu(), cpu)
    with torch.backends.cudnn.flags(enabled=False):
        _, ggrads = gradients3d(copy.deepcopy(net).to(DEV), step_of, imgs[:1])
    whole, median, worst = gradient_distance(ggrads, cpu[1][1])
    print(f"  flownets (convolutions without cuDNN, not held) batch 1 gradients, card "
          f"fp32 vs CPU fp64, relative L2: whole model {whole:.3g}, per tensor median "
          f"{median:.3g}, worst {worst:.3g}")

    # the flow-supervised step on the phantom gate's pairs, magnitude (0, 1.5)
    gen = torch.Generator(device=DEV).manual_seed(44)
    simgs, _, disp = phantom_pairs(gen, BATCH, SIZE, (0.0, 1.5))
    for units in ("resolution", "pwc20"):
        smodel = OpticalFlowReg("flownets", generator=torch.Generator().manual_seed(45))
        state = create_train_state(smodel.to(DEV))
        step = make_flow_supervised_step(state, flow_units=units)
        torch.cuda.synchronize()
        reset_counts()
        epes = [step(simgs, disp)]
        torch.cuda.synchronize()
        got = counts()
        epes += [step(simgs, disp) for _ in range(4)]
        print(f"  flow-supervised step ({units}) at batch {BATCH}: launches {got}; "
              f"EPE over 5 steps on one batch: "
              + ", ".join(f"{float(m['epe']):.6g}" for m in epes)
              + f" (finest {float(epes[0]['epe0']):.6g} -> {float(epes[-1]['epe0']):.6g} px)")
        require(got == SUPERVISED_LAUNCHES,
                f"the flow-supervised step should launch {SUPERVISED_LAUNCHES}")
        require(all(np.isfinite(float(m["epe"])) for m in epes)
                and float(epes[-1]["epe"]) < float(epes[0]["epe"]),
                f"flow-supervised ({units}): the EPE is not finite or does not fall")
        # batch 1, card against CPU: the metrics, and the fp32 gradient by
        # the CPU tests' rule, not PERF.md §2's "twice the CPU's distance":
        # no hand-written kernel is on this gradient's path (K3's warps are
        # not in the loss), the CPU's fp32 gradient of this well-conditioned
        # loss lay 1.94e-05 from fp64, and the card's 1.36e-03 with cuDNN
        # and 6.51e-04 with PyTorch's own CUDA convolutions, nearly all of
        # it in the full-resolution encoder convolutions' weight gradients
        # (conv2: 2.9e-03 and 8.7e-04 against the CPU's 2.0e-05; PERF.md
        # §6, PR 12)
        net = OpticalFlowReg("flownets", generator=torch.Generator().manual_seed(46))
        pair, dpair = simgs[:1].cpu(), disp[:1].cpu()
        cm, c32 = supervised_gradients(net, units, pair, dpair)
        _, c64 = supervised_gradients(copy.deepcopy(net).double(), units,
                                      pair.double(), dpair.double())
        gm, g32 = supervised_gradients(copy.deepcopy(net).to(DEV), units,
                                       pair.to(DEV), dpair.to(DEV))
        for k in cm:
            r = abs(gm[k] / cm[k] - 1)
            print(f"    {units} {k}: card {gm[k]:.7g}, CPU {cm[k]:.7g}, {r:.3g} "
                  f"relative (tolerance 1e-4)")
            require(r <= 1e-4, f"flow-supervised ({units}): card and CPU {k} disagree")
        hold_fp32_gradients(f"flow-supervised ({units})", g32, c32, c64)

    # the rest of the 2-D zoo through the head, eval mode, batch 1, against
    # the CPU, with each one's launches
    for name, want_launches in ZOO_EVAL_LAUNCHES.items():
        net = OpticalFlowReg(name, generator=torch.Generator().manual_seed(47))
        (want, _, _, _), cm = make_eval_step(net)(imgs[:1].cpu(), segs[:1].cpu())
        card_net = copy.deepcopy(net).to(DEV)
        step = make_eval_step(card_net)
        torch.cuda.synchronize()
        reset_counts()
        (got, _, _, _), gm = step(imgs[:1], segs[:1])
        torch.cuda.synchronize()
        launches = counts()
        print(f"  {name} ({type(net.predictor).__name__}, "
              f"{sum(p.numel() for p in net.parameters())} parameters) eval, batch 1: "
              f"launches {launches}")
        require(launches == want_launches, f"{name}'s eval step should launch "
                f"{want_launches}")
        check_flows(f"{name} eval, batch 1, card vs CPU,", got, want)
        for k in cm:
            require(abs(float(gm[k]) / float(cm[k]) - 1) <= 1e-4,
                    f"{name}: card and CPU {k} disagree")
        del net, card_net
    # FlowNetCPinard, the module alone on a 6-channel pair (the head feeds 2
    # channels): train mode gives 5 flows, eval mode (flow2,); one K1 each
    pinard = build_predictor("flownetc-pinard", generator=torch.Generator().manual_seed(48))
    pair = imgs[:1].permute(0, 3, 1, 2).cpu()
    noise = torch.rand((1, 6, SIZE, SIZE), generator=torch.Generator().manual_seed(49))
    x = torch.cat([pair[:, :1]] * 3 + [pair[:, 1:]] * 3, 1) + 0.05 * noise
    card_pinard = copy.deepcopy(pinard).to(DEV)
    for train in (True, False):
        with torch.no_grad():
            want = pinard.train(train)(x)
            reset_counts()
            got = card_pinard.train(train)(x.to(DEV))
            torch.cuda.synchronize()
        require(counts() == launches_of(correlation=1), "flownetc-pinard: one K1")
        require(len(got) == (5 if train else 1), "flownetc-pinard: number of flows")
        check_flows(f"flownetc-pinard {'train' if train else 'eval'} mode, card vs CPU,",
                    got, want)
    del pinard, card_pinard

    # both 2-D CLIs with --model flownets
    with tempfile.TemporaryDirectory() as work:
        train_cli_and_resume("flownets", train_dirs, work)
        require(os.path.isfile(best_weight_path(work, "FlowNetS")),
                "the training CLI did not save flownets' best weights under FlowNetS")
        real_eval_cli("flownets", pair_dirs, work, FLOWNETS_EVAL_LAUNCHES)
        got = synthetic_eval_cli("flownets", train_dirs, work)
        # 2 batches of 4: each eval step's launches and one K3 in the
        # batch's elastic synthesis
        require(got == launches_of(warp2d=2 * (FLOWNETS_EVAL_LAUNCHES["warp2d"] + 1)),
                "flownets inference --mode synthetic: launch counts")
    return ({"eval": eval_launches, "train": train_launches},
            {"eval": eval_steps, "train": train_steps}, imgs, segs)


# ---------------------------------------------------------------------------
# A.6: remat, --pretrained/--surgery, the native decoder, TensorBoard, trace

def batchnorm_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def remat_steps(name, dtypes, base_gate, gate, seed, imgs):
    """One step of the base, "full" and "dots" train steps of ``name`` from
    the same weights on ``imgs``, for each of ``dtypes``: the launch gates,
    the loss and the running statistics against the base step's, each
    step's time and peak memory. In fp32 a second base step shows the
    card's own spread of the gradient, and each remat step's gradient is
    held at batch 1 by ``hold_remat_gradient`` (at 256²: at 64² FlowNet2's
    deepest BatchNorms see one value a channel, and rounding alone sets
    the gradient)."""
    loss_kwargs = default_loss_kwargs(name)
    init = OpticalFlowReg(name, generator=torch.Generator().manual_seed(seed))
    small = imgs[:1].cpu()
    cpu = cpu_gradients(init, lambda st: make_train_step(st, loss_kwargs), small)
    init.to(DEV)
    base_small = batch1_distance(init, lambda st: make_train_step(st, loss_kwargs),
                                 small, cpu[1][1])
    for dname, dtype in dtypes:
        runs = {}
        modes = (None, "again", "full", "dots") if dtype is None else (None, "full", "dots")
        for mode in modes:
            remat = None if mode == "again" else mode
            model = copy.deepcopy(init)
            state = create_train_state(model)
            step = make_train_step(state, loss_kwargs, dtype, remat=remat)
            torch.cuda.synchronize()
            reset_counts()
            metrics = step(imgs)
            torch.cuda.synchronize()
            got = counts()
            want = base_gate if remat is None else gate
            label = f"{name} {dname} remat={remat}"
            print(f"  {label}: launches in one step {got}")
            require(got == want, f"{label} should launch {want}")
            runs[mode] = (float(metrics["loss"]), batchnorm_stats(model),
                          {n: p.grad.double().cpu() for n, p in model.named_parameters()})
            if mode != "again":
                runs[mode] += (step_times(f"{label} train step, batch {BATCH} at 256²",
                                          lambda: step(imgs)),)
            del model, state, step
        loss, stats, grads, ms = runs[None]
        if dtype is None:
            whole, median, worst = gradient_distance(runs["again"][2], grads)
            print(f"  {name} fp32: a second base step's gradient against the first's, "
                  f"relative L2: whole model {whole:.3g}, per tensor median "
                  f"{median:.3g}, worst {worst:.3g} (the card's own spread)")
        for remat in ("full", "dots"):
            rloss, rstats, rgrads, rms = runs[remat]
            rel = abs(rloss / loss - 1)
            # each statistic against the largest of its tensor (at least 1):
            # a reduction's order may follow its input's address, so the
            # same batch statistics can differ in the last bit between runs
            diffs = [(float((rstats[k] - stats[k]).abs().max()),
                      max(float(stats[k].abs().max()), 1.0)) for k in stats]
            worst_abs = max((d for d, _ in diffs), default=0.0)
            worst_rel = max((d / m for d, m in diffs), default=0.0)
            print(f"  {name} {dname} remat={remat} against the base step: loss "
                  f"{rloss:.9g} vs {loss:.9g}, {rel:.3g} relative (tolerance 1e-5); "
                  f"running statistics over {len(stats)} tensors: max |diff| "
                  f"{worst_abs:.3g}, relative to the tensor's largest value "
                  f"{worst_rel:.3g} (tolerance 1e-6); step {rms:.3f} vs {ms:.3f} ms")
            require(rel <= 1e-5, f"{name} {dname} remat={remat}: the loss moved")
            require(worst_rel <= 1e-6,
                    f"{name} {dname} remat={remat}: the running statistics moved")
            if dtype is None:
                whole, median, worst = gradient_distance(rgrads, grads)
                print(f"    its fp32 gradient against the base step's, relative L2: "
                      f"whole model {whole:.3g}, per tensor median {median:.3g}, "
                      f"worst {worst:.3g}")
                hold_remat_gradient(name, remat, init, loss_kwargs, small, cpu,
                                    base_small)


def batch1_distance(model, make_step, small, fp64):
    """Relative L2 of one card step's fp32 gradient at batch 1 from the CPU's
    fp64 one: (whole model, per tensor median, worst)."""
    _, grads = gradients3d(copy.deepcopy(model), make_step, small.to(DEV))
    return gradient_distance(grads, fp64)


def hold_remat_gradient(name, remat, init, loss_kwargs, small, cpu, base_small):
    """At batch 1, 256², the remat step's fp32 gradient on the card against
    the CPU's fp64 one: no further than twice the further of the card's base
    step and the CPU's fp32 step (phase 7's rule, with the base step on the
    card beside the CPU: the recompute may take other cuDNN algorithms than
    the forward, one more rounding of the activations the backward reads)."""
    (_, _), (_, fp64) = cpu
    got = batch1_distance(init, lambda st: make_train_step(st, loss_kwargs, remat=remat),
                          small, fp64)
    cpu32 = gradient_distance(cpu[0][1], fp64)
    bound = [2 * max(a, b, 5e-6) for a, b in zip(base_small[:2], cpu32[:2])]
    print(f"    batch 1 fp32 gradients against the CPU's fp64, relative L2 (whole "
          f"model, per tensor median): remat={remat} {got[0]:.3g}, {got[1]:.3g}; card "
          f"base step {base_small[0]:.3g}, {base_small[1]:.3g}; CPU fp32 {cpu32[0]:.3g}, "
          f"{cpu32[1]:.3g} (tolerance twice the further: {bound[0]:.3g}, {bound[1]:.3g})")
    require(got[0] <= bound[0] and got[1] <= bound[1],
            f"{name} remat={remat}: the fp32 gradient is further from fp64 than the "
            "base step's allows")


def remat_path():
    phase("8k(a). remat: FlowNet2 (fp32, bf16) and pwc-reg (fp32) train steps at "
          "256², batch 8, with remat full and dots against the base step")
    imgs, _ = phantom_batch(BATCH, SIZE, seed=6)
    imgs = imgs.to(DEV)
    remat_steps("flownet2", (("fp32", None), ("bf16", torch.bfloat16)),
                TRAIN_LAUNCHES, REMAT_TRAIN_LAUNCHES, 1, imgs)
    remat_steps("pwc-reg", (("fp32", None),), PWC_TRAIN_LAUNCHES,
                PWC_REMAT_TRAIN_LAUNCHES, 22, imgs)


def pretrained_and_native_paths(pair_dirs, train_dirs):
    phase("8k(b, d, e). --pretrained with --surgery rgb_pair on phase 8's volumes; "
          "the native Analyze decoder; the TensorBoard writer's warning")
    lib = analyze.build_native()
    print(f"  native Analyze decoder: {lib.name}, built with "
          f"{' '.join(analyze.CXX_FLAGS)}")
    paths = sorted(glob.glob(os.path.join(pair_dirs["fiximg"], "*.img"))
                   + glob.glob(os.path.join(train_dirs["img"], "*.img")))
    for path in paths:
        got = analyze.read_analyze(path, use_native=True)
        want = analyze.read_analyze(path, use_native=False)
        require(got.dtype == want.dtype and np.array_equal(got, want),
                f"{path}: the native decoder and numpy disagree")
    print(f"  native decoder equal to numpy on {len(paths)} volumes")
    decoded = {"n": 0}
    native = analyze._load_native()
    raw = native.analyze_decode

    def counting_decode(*args):
        decoded["n"] += 1
        return raw(*args)

    native.analyze_decode = counting_decode
    stderr = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as work:
            sd = OpticalFlowReg("flownets", generator=torch.Generator().manual_seed(30)
                                ).predictor.state_dict()
            w = sd["conv1.0.weight"]
            sd["conv1.0.weight"] = torch.cat([w[:, :1] / 3] * 3 + [w[:, 1:] / 3] * 3, 1)
            ckpt = os.path.join(work, "flownets_rgb_pair.pt")
            torch.save({"state_dict": sd}, ckpt)
            n_tensors = sum(not k.endswith("num_batches_tracked") for k in sd)
            out = io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(stderr):
                state = cli_train.main([
                    "--model", "flownets", "--img_dir", train_dirs["img"],
                    "--seg_dir", train_dirs["seg"], "--batch_size", str(BATCH),
                    "--epochs", "1", "--cp", "0", "--workdir", work, "--logdir",
                    os.path.join(work, "log"), "--pretrained", ckpt,
                    "--surgery", "rgb_pair"], device="cuda")
            torch.cuda.synchronize()
            line = f"imported {n_tensors} tensors (0 unmatched, 0 shape-mismatched)"
            print(f"  training CLI --model flownets --pretrained --surgery rgb_pair: "
                  f"{state.step} steps; {decoded['n']} volumes decoded natively")
            for text in [line for line in out.getvalue().splitlines()
                         if "imported" in line] + cli_summary(out.getvalue()):
                print(f"    {text}")
            require(line in out.getvalue(), f"the training CLI did not print {line!r}")
            require(state.step == 80 and decoded["n"] >= 10,
                    "the training CLI's steps or its native reads")
            trained = dict(state.model.predictor.named_parameters())["conv1.0.weight"]
            require(trained.shape == w.shape, "the collapsed stem's shape")
            n_train = decoded["n"]
            real_eval_cli("flownets", pair_dirs, work, FLOWNETS_EVAL_LAUNCHES)
            require(decoded["n"] > n_train, "the inference CLI did not decode natively")
            print(f"  inference CLI --mode real: {decoded['n'] - n_train} volumes "
                  "decoded natively")
    finally:
        native.analyze_decode = raw
    warnings = stderr.getvalue().count("WARNING: no TensorBoard backend available")
    backends = []
    for module in ("torch.utils.tensorboard", "tensorboardX"):
        with contextlib.suppress(Exception):
            __import__(module)
            backends.append(module)
    has_backend = bool(backends)
    print(f"  TensorBoard backends importable on this machine: "
          f"{', '.join(backends) or 'none'}; the training CLI's stderr held "
          f"{warnings} warning(s)")
    require(warnings == (0 if has_backend else 1),
            "the TensorBoard writer's warning: one where no backend imports")


def trace_path(eval_step, imgs, segs):
    phase("8k(c). profiling.trace around one FlowNet2 eval step at 256², batch 8")
    eval_step(imgs, segs)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            eval_step(imgs, segs)
            torch.cuda.synchronize()
        (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels)
             for k in ("corr_fwd_kernel", "warp2d_fwd_kernel")}
    print(f"  {os.path.basename(path)}: {size} bytes, {len(events)} events, "
          f"{len(kernels)} device kernels; K1 (corr_fwd_kernel) {named['corr_fwd_kernel']}, "
          f"K3 (warp2d_fwd_kernel) {named['warp2d_fwd_kernel']}")
    require(all(named.values()), "the trace does not name K1's and K3's kernels")


# launches of the eval head without segmentations: one K3 fewer
FLOWNETS_EXPORT_LAUNCHES = {True: FLOWNETS_EVAL_LAUNCHES, False: launches_of(warp2d=3)}
FLOWNET2_EXPORT_LAUNCHES = {True: EVAL_LAUNCHES,
                            False: launches_of(correlation=1, warp2d=6)}


def leaves(outputs):
    return [t for t in torch.utils._pytree.tree_leaves(outputs) if t is not None]


def hold_artifact(label, got, want):
    """``compare_outputs``' rule (tpureg_torch/serving/export.py): flows
    within 1e-5 of their scale, warped images and grid within what the
    flows' difference moves a sample, warped segmentations equal."""
    try:
        return compare_outputs(got, want)
    except AssertionError as e:
        raise RuntimeError(f"{label}: the artifact and the live head disagree: {e}")


def export_path(flownet2):
    phase("8l. the serving export: FlowNetS and FlowNet2 at 256², batch 8, fp32, "
          "with and without segs; card and CPU; the export CLI")
    set_fp32_numerics()
    heads = {"flownets": (OpticalFlowReg("flownets", generator=torch.Generator()
                                         .manual_seed(60)).to(DEV),
                          FLOWNETS_EXPORT_LAUNCHES),
             "flownet2": (flownet2, FLOWNET2_EXPORT_LAUNCHES)}
    imgs, segs = phantom_batch(BATCH, SIZE, seed=61)
    imgs, segs = imgs.to(DEV), segs.to(DEV)
    tmp = tempfile.TemporaryDirectory()
    for name, (head, gates) in heads.items():
        head.eval()
        for with_segs in (True, False):
            label = f"{name} {'with' if with_segs else 'without'} segs"
            inputs = (imgs, segs) if with_segs else (imgs,)
            t0 = time.perf_counter()
            exported = export_registration(head, BATCH, SIZE, with_segs=with_segs)
            t_export = time.perf_counter() - t0
            ops = [str(n.target) for n in exported.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("tpureg.")]
            path = os.path.join(tmp.name, f"{name}_{int(with_segs)}.pt2")
            t0 = time.perf_counter()
            save_artifact(path, exported)
            served = load_artifact(path, DEV)
            t_io = time.perf_counter() - t0
            with torch.no_grad():
                # cuDNN's default algorithms: two live calls, the artifact
                first, again, default = (head(*inputs), head(*inputs),
                                         served(*inputs))
                repeat = max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(leaves(again), leaves(first)))
                off = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(leaves(default), leaves(first)))
                with deterministic_cudnn():
                    torch.cuda.synchronize()
                    reset_counts()
                    live = head(*inputs)
                    torch.cuda.synchronize()
                    live_launches = counts()
                    reset_counts()
                    got = served(*inputs)
                    torch.cuda.synchronize()
                    art_launches = counts()
            print(f"  {label}: exported in {t_export:.1f} s, {len(ops)} op nodes "
                  f"({', '.join(sorted(set(ops)))}); {os.path.getsize(path) / 1e6:.1f} "
                  f"MB, saved and loaded in {t_io:.1f} s; launches live "
                  f"{live_launches}, artifact {art_launches}")
            require(live_launches == gates[with_segs],
                    f"{label}: the live head should launch {gates[with_segs]}")
            require(art_launches == live_launches,
                    f"{label}: the artifact should launch the live head's kernels")
            require(len(ops) == sum(gates[with_segs][k] for k in ("correlation", "warp2d")),
                    f"{label}: every kernel of the forward should be a graph node")
            diffs = hold_artifact(label, got, live)
            print(f"    artifact vs live head on the card, cuDNN deterministic: "
                  f"flows {diffs['flows']}, warped images {diffs['warped']}, grid "
                  f"{diffs['grid']:.3g}, segmentations equal; with cuDNN's default "
                  f"algorithms two live calls differ by up to {repeat:.3g}, the "
                  f"artifact from the live head by {off:.3g}")
            if not with_segs:
                continue
            with torch.no_grad():  # "loss": a view of one flow value
                live_ms = step_times(f"{label}: live eval head",
                                     lambda: {"loss": head(*inputs)[0][0][0, 0, 0, 0]})
                art_ms = step_times(f"{label}: artifact",
                                    lambda: {"loss": served(*inputs)[0][0][0, 0, 0, 0]})
            print(f"    artifact / live head: {art_ms / live_ms:.3f}")
            cpu_served = load_artifact(path, "cpu")
            cpu_head = copy.deepcopy(head).cpu()
            cpu_in = tuple(t.cpu() for t in inputs)
            with torch.no_grad():
                cflow = cpu_head(*cpu_in)[0][0]
                aflow = cpu_served(*cpu_in)[0][0]
            dflow = (aflow - cflow).abs()
            dcard = (aflow - got[0][0].cpu()).abs()
            print(f"    the file on the CPU vs the CPU's plain path: |Δflow| max "
                  f"{float(dflow.max()):.3g} px, mean {float(dflow.mean()):.3g} "
                  f"(tolerances 0.1 and 2e-3 px); vs the card: max "
                  f"{float(dcard.max()):.3g}, mean {float(dcard.mean()):.3g} px")
            require(float(dflow.max()) <= 0.1 and float(dflow.mean()) <= 2e-3,
                    f"{label}: the artifact on the CPU and the CPU's plain path disagree")
            del cpu_served, cpu_head
    out = os.path.join(tmp.name, "cli.pt2")
    res = subprocess.run(
        [sys.executable, "-m", "tpureg_torch.cli.export", "--model", "flownets",
         "--random_weights", "--check", "--with_segs", "--batch_size", str(BATCH),
         "--image_size", str(SIZE), "--out", out, "--platforms", "cuda", "cpu"],
        capture_output=True, text=True, timeout=600)
    print("  export CLI: " + "\n  export CLI: ".join(res.stdout.strip().splitlines()))
    require(res.returncode == 0 and "artifact check OK" in res.stdout,
            f"the export CLI's --check failed: {res.stderr[-2000:]}")
    tmp.cleanup()


# phase 8m(ii): the ranks, each this script run with ``--dp-rank``
DP_WORLD = 2
DP_TIMEOUT = 600


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def update_of(sd, before):
    """The change of each weight of state dict ``sd`` from ``before``
    (fp64, on the host); running statistics left out."""
    return {k: v.double().cpu() - before[k].double().cpu() for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def relative_l2(got, want):
    diff2 = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (diff2 / sum(float((want[k] ** 2).sum()) for k in want)) ** 0.5


def stats_of(sd):
    return {k: v.double().cpu() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def stats_error(got, want):
    """The largest difference of each running statistic from ``want``'s,
    relative to that tensor's largest value."""
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
               for k in want)


def host_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def grads_of(model):
    """Each parameter's gradient (fp64, on the host), as the last step left
    it before its Adam update."""
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def biases_before_batchnorm(model):
    """The names of the convolution biases that a BatchNorm in training
    normalises away: their gradient is zero in exact arithmetic, so rounding
    alone is left of it, and a tensor's relative distance reads noise."""
    names = []
    for prefix, module in model.named_modules():
        children = list(module.named_children())
        for (name, a), (_, b) in zip(children, children[1:]):
            if isinstance(b, BatchNorm2d) and getattr(a, "bias", None) is not None:
                names.append(f"{prefix}.{name}.bias" if prefix else f"{name}.bias")
    return names


def tensor_distances(grads, rgrads):
    """Each tensor's relative L2 distance of ``grads`` from ``rgrads``."""
    return {k: float((grads[k] - rgrads[k]).norm()) / max(float(rgrads[k].norm()), 1e-30)
            for k in rgrads}


def quantiles(distances, skip):
    """The 10%, 50% and 90% quantiles and the largest of ``distances``
    (``tensor_distances``) outside ``skip``, as text."""
    q = sorted(v for k, v in distances.items() if k not in skip)
    return "/".join(f"{v:.3g}" for v in (q[len(q) // 10], q[len(q) // 2],
                                          q[9 * len(q) // 10], q[-1]))


def projection(grads, rgrads):
    """<grads, rgrads> / <rgrads, rgrads> over the whole model: 1 for the
    same gradient, W for one W times too large."""
    return (sum(float((grads[k] * rgrads[k]).sum()) for k in rgrads)
            / sum(float((rgrads[k] ** 2).sum()) for k in rgrads))


@contextlib.contextmanager
def torchrun_env(rank, world, port):
    """``torchrun``'s environment for a rank of this process's group, every
    rank on card 0; the variables put back afterwards."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def flownet2_train_state(base=None):
    """Phase 7's FlowNet2 (seeded random weights; a copy of ``base`` when
    given) on the card, with a fresh Adam state."""
    model = (copy.deepcopy(base) if base is not None else
             OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(1)))
    return create_train_state(model.to(DEV))


def dp_world_of_one(base, train_dirs):
    """8m(i): the data-parallel step over an NCCL group of one on cuda:0
    against the single-process step, launches, times, the --fsdp CLI."""
    imgs, _ = phantom_batch(BATCH, SIZE, seed=6)
    imgs = imgs.to(DEV)
    group = dist.group.WORLD
    before, reference, steps = None, None, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        one, again, dp = (flownet2_train_state(base) for _ in range(3))
        before = before or host_state(one.model)
        one_step = make_train_step(one, compute_dtype=dtype)
        dp_step = make_train_step(dp, compute_dtype=dtype, group=group)
        with deterministic_cudnn():
            m_one = one_step(imgs)
            m_again = make_train_step(again, compute_dtype=dtype)(imgs)
            torch.cuda.synchronize()
            reset_counts()
            m_dp = dp_step(imgs[local_rows(BATCH, 1, 0)])
            torch.cuda.synchronize()
            launches = counts()
        sd_one = host_state(one.model)
        u_one = update_of(sd_one, before)
        if name == "fp32":
            g_one, g_again = grads_of(one.model), grads_of(again.model)
            g_spread = (gradient_distance(g_again, g_one)[0],
                        tensor_distances(g_again, g_one), projection(g_again, g_one))
            del g_again
        metrics = max(abs(float(m[k]) - float(m_one[k])) for m in (m_dp, m_again)
                      for k in m_one)
        stats = max(stats_error(stats_of(host_state(m.model)), stats_of(sd_one))
                    for m in (dp, again))
        update = relative_l2(update_of(host_state(dp.model), before), u_one)
        spread = relative_l2(update_of(host_state(again.model), before), u_one)
        print(f"  (i) {name}: DP step over NCCL, world 1, launches {launches}; against "
              f"the single-process step from the same weights on the same batch, cuDNN "
              f"deterministic: metrics and running statistics (the forward) differ by "
              f"{metrics:.3g} and {stats:.3g} (tolerance 0: the all-reduce of one rank "
              f"copies), the update by {update:.3g} in relative L2 (tolerance twice "
              f"the single-process step's distance from itself, {spread:.3g}: some "
              f"CUDA ops of the backward add with atomics)")
        require(launches == TRAIN_LAUNCHES,
                f"{name}: the DP step should launch {TRAIN_LAUNCHES}")
        require(metrics == 0 and stats == 0 and update <= 2 * spread,
                f"{name}: the world-of-one DP step differs from the single-process step")
        if name == "fp32":
            reference = {"metrics": {k: float(v) for k, v in m_one.items()},
                         "update": u_one, "stats": stats_of(sd_one), "spread": spread,
                         "grads": g_one, "grad_spread": g_spread}
        steps[name] = (one_step, dp_step)
        del again, sd_one
    # the collectives' cost on one card: single, DP, DP, single
    for name, (one_step, dp_step) in steps.items():
        label = f"train step {name}, batch {BATCH} at 256²"
        first = step_times(f"8m(i) single-process {label}", lambda: one_step(imgs))
        dp1 = step_times(f"8m(i) DP world-1 (NCCL) {label}", lambda: dp_step(imgs))
        dp2 = step_times(f"8m(i) DP world-1 (NCCL) {label}, again", lambda: dp_step(imgs))
        last = step_times(f"8m(i) single-process {label}, again", lambda: one_step(imgs))
        print(f"  (i) {name}: DP world 1 / single process: "
              f"{(dp1 + dp2) / (first + last):.3f} (medians {dp1:.3f}, {dp2:.3f} "
              f"against {first:.3f}, {last:.3f} ms)")
    del steps
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        common = ["--model", "flownet2", "--img_dir", train_dirs["img"], "--seg_dir",
                  train_dirs["seg"], "--batch_size", str(BATCH), "--workdir", work,
                  "--logdir", os.path.join(work, "log")]
        out = io.StringIO()
        reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            state = cli_train.main(common + ["--epochs", "1", "--cp", "0", "--fsdp"],
                                   device="cuda")
        torch.cuda.synchronize()
        text, launches = out.getvalue(), counts()
        print(f"  (i) --fsdp CLI, one epoch on phase 8's volumes: {time.time() - t0:.1f} s,"
              f" {state.step} steps, {len(state.shards.dims)} sharded parameters, "
              f"launches {launches}")
        for line in cli_summary(text) + [l for l in text.splitlines() if "FSDP" in l]:
            print(f"    {line}")
        require("FSDP: params/opt-state sharded over 1 devices" in text
                and "EPOCH 1/1" in text and "saving new best weights" in text
                and state.step == 80, "the --fsdp CLI did not train one epoch or save")
        require(all(launches[k] > 0 for k in ("correlation", "correlation_bwd", "warp2d",
                                              "warp2d_dpos")),
                "the --fsdp CLI did not launch K1-K4")
        del state
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = cli_train.main(common + ["--epochs", "1", "--cp", "1"], device="cuda")
        require("loading checkpoint state" in out.getvalue() and state.step == 80,
                "the --fsdp checkpoint did not restore in a single process")
        print("    its checkpoint restores in a single process (no --fsdp): "
              f"step {state.step}")
        del state
    return before, reference


def dp_two_ranks(base, before, reference):
    """8m(ii): two ranks on the one card over gloo (named explicitly: NCCL
    refuses two ranks on one device), each running this script with
    ``--dp-rank``; held against the single-process step of (i)."""
    print("  (ii) two ranks on cuda:0 over gloo, named explicitly (NCCL refuses two "
          "ranks on one device); gloo stages each CUDA tensor of a collective "
          "through host memory itself")
    folder = tempfile.mkdtemp(prefix="dp_ranks_")
    port = free_port()
    logs = [open(os.path.join(folder, f"log{r}.txt"), "w") for r in range(DP_WORLD)]
    procs = []
    for r in range(DP_WORLD):
        with torchrun_env(r, DP_WORLD, port):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank", folder],
                stdout=logs[r], stderr=subprocess.STDOUT))
    try:
        # meanwhile the yardsticks, changes of rounding only: the
        # single-process step with cuDNN's default algorithms (its
        # transposed convolutions add with atomics), and on the batch with
        # its halves swapped
        imgs, _ = phantom_batch(BATCH, SIZE, seed=6)
        spreads = {"itself (i)": reference["spread"]}
        grad_spreads = {"itself (i)": reference["grad_spread"]}
        for label, batch, deterministic in (
                ("cuDNN's default algorithms", imgs, False),
                ("halves swapped", torch.cat([imgs[BATCH // 2:], imgs[:BATCH // 2]]),
                 True)):
            other = flownet2_train_state(base)
            with (deterministic_cudnn() if deterministic else contextlib.nullcontext()):
                make_train_step(other)(batch.to(DEV))
            spreads[label] = relative_l2(update_of(host_state(other.model), before),
                                         reference["update"])
            g_other = grads_of(other.model)
            grad_spreads[label] = (gradient_distance(g_other, reference["grads"])[0],
                                   tensor_distances(g_other, reference["grads"]),
                                   projection(g_other, reference["grads"]))
            del g_other
            del other
        spread = max(spreads.values())
        torch.cuda.empty_cache()
        deadline = time.time() + DP_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(folder, f"log{r}.txt")) as f:
            log = f.read()
        print(f"  rank {r}: " + f"\n  rank {r}: ".join(log.strip().splitlines()[-12:]))
        require(p.returncode == 0, f"rank {r} of the gloo run failed (exit {p.returncode})")
    ranks = [json.load(open(os.path.join(folder, f"rank{r}.json"))) for r in range(DP_WORLD)]
    dp_sd = torch.load(os.path.join(folder, "dp.pt"), weights_only=True)
    dp_grads = {k: v.double() for k, v in
                torch.load(os.path.join(folder, "dp_grads.pt"), weights_only=True).items()}
    fsdp_sd = torch.load(os.path.join(folder, "fsdp.pt"), weights_only=True)
    shutil.rmtree(folder, ignore_errors=True)
    for r, res in enumerate(ranks):
        for label in ("dp", "fsdp"):
            require(res[label]["launches"] == TRAIN_LAUNCHES,
                    f"rank {r} {label}: the step should launch {TRAIN_LAUNCHES}")
            require(res[label]["from_rank0"] == 0.0,
                    f"rank {r} {label}: the ranks' weights differ")
        require(res["dp"]["metrics"] == ranks[0]["dp"]["metrics"],
                "the ranks' metrics differ")
        for k, (held, full) in res["fsdp"]["shares"].items():
            require(2 * held == full, f"rank {r}: {k} is not halved under FSDP")
    metrics = max(abs(ranks[0]["dp"]["metrics"][k] / reference["metrics"][k] - 1)
                  for k in reference["metrics"])
    update = relative_l2(update_of(dp_sd, before), reference["update"])
    ref = reference["grads"]
    skip = set(biases_before_batchnorm(base))
    grads = (gradient_distance(dp_grads, ref)[0], projection(dp_grads, ref),
             quantiles(tensor_distances(dp_grads, ref), skip))
    del dp_grads
    stats = stats_error(stats_of(dp_sd), reference["stats"])
    fsdp_metrics = ranks[0]["fsdp"]["metrics"] == ranks[0]["dp"]["metrics"]
    fsdp_stats = stats_error(stats_of(fsdp_sd), stats_of(dp_sd))
    fsdp = relative_l2(update_of(fsdp_sd, before), update_of(dp_sd, before))
    print(f"  (ii) fp32 DP step, 4 rows a rank, against the single-process step on "
          f"the 8 (cuDNN deterministic): metrics {metrics:.3g} relative (tolerance "
          f"1e-4), running statistics {stats:.3g} of each tensor's largest value "
          f"(tolerance 1e-4), update {update:.3g} in relative L2 (tolerance twice the "
          f"larger distance of the single-process step from itself under a change "
          f"of rounding: " + ", ".join(f"{k} {v:.3g}" for k, v in spreads.items())
          + ")")
    print(f"  (ii) fp32 DP step's gradients, summed over the ranks before Adam, against "
          f"the single-process step's on the 8: relative L2 {grads[0]:.3g} over the "
          f"model (tolerance 0.5), projection on it {grads[1]:.6g} (tolerance 1 ± 0.25; "
          f"a gradient W = 2 times too large reads 1 and 2), per tensor 10/50/90% and "
          f"worst {grads[2]} (the {len(skip)} convolution biases that a BatchNorm "
          f"normalises away, zero but for rounding, left out). The single-process "
          f"step's own under a change of rounding, the same figures: "
          + "; ".join(f"{k} {v[0]:.3g}, {v[2]:.6g}, {quantiles(v[1], skip)}"
                      for k, v in grad_spreads.items()))
    print(f"  (ii) FSDP step over the two ranks, {len(ranks[0]['fsdp']['shares'])} "
          f"parameters halved on each, against the DP step: metrics equal "
          f"{fsdp_metrics}, running statistics {fsdp_stats:.3g} (tolerance 0: the "
          f"same arithmetic, the forward deterministic), the update {fsdp:.3g} in "
          f"relative L2 (tolerance twice the yardsticks' largest); step times "
          f"(host clock, one step, gloo through host memory): DP "
          f"{ranks[0]['dp']['seconds']:.3f} s, FSDP {ranks[0]['fsdp']['seconds']:.3f} s")
    cli = ranks[0]["cli"]
    print(f"  (ii) --fsdp CLI over the two ranks, --synthetic 2 at 256², batch 8: "
          f"steps {[r['cli']['step'] for r in ranks]}, files written by rank 0 "
          f"{cli['written']}, by rank 1 {ranks[1]['cli']['written']}, train loss "
          f"{cli['loss']}")
    require(metrics <= 1e-4 and stats <= 1e-4 and update <= 2 * spread,
            "the two-rank DP step and the single-process step disagree")
    require(grads[0] <= 0.5 and abs(grads[1] - 1) <= 0.25,
            "the two-rank DP step's summed gradients and the single-process step's "
            "disagree")
    require(fsdp_metrics and fsdp_stats == 0 and fsdp <= 2 * spread,
            "the two-rank FSDP step differs from the DP step")
    # (best weights only where the validation loss falls below the CLI's
    # initial 1e5, which a random FlowNet2's does not)
    require([r["cli"]["step"] for r in ranks] == [2, 2]
            and os.path.join("Checkpoints", "Unsupervised", "FlowNet2",
                             "training_state.pt") in cli["written"]
            and ranks[1]["cli"]["written"] == [] and np.isfinite(cli["loss"]),
            "the two-rank --fsdp CLI did not train or checkpoint, or rank 1 wrote")


def dp_rank(folder):
    """One rank of 8m(ii): FlowNet2's fp32 DP step and FSDP step on its 4
    rows of phase 7's batch (cuDNN deterministic), then the --fsdp CLI on
    two synthetic batches, over a gloo group of two on cuda:0 that it joins
    from torchrun's environment, gloo named (NCCL refuses two ranks on one
    device)."""
    init_from_env(DEV, backend="gloo")
    rank = dist.get_rank()
    try:
        set_fp32_numerics()
        group = dist.group.WORLD
        imgs, _ = phantom_batch(BATCH, SIZE, seed=6)
        x = imgs[local_rows(BATCH, DP_WORLD, rank)].to(DEV)
        base = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(1))
        out = {}
        for label in ("dp", "fsdp"):
            state = flownet2_train_state(base)
            if label == "fsdp":
                shard_train_state(state, group)
            step = make_train_step(state, group=group)
            with deterministic_cudnn():
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                metrics = step(x)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = counts()
            names = {p: n for n, p in state.model.named_parameters()}
            shares = ({names[p]: (p.numel(), p.numel() * DP_WORLD)
                       for p in state.shards.dims} if state.shards else {})
            with (state.shards.gathered() if state.shards else contextlib.nullcontext()):
                sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            from_rank0 = 0.0
            for v in sd.values():
                v0 = v.clone()
                dist.broadcast(v0, 0, group=group)
                from_rank0 = max(from_rank0, float((v.double() - v0.double()).abs().max()))
            out[label] = {"metrics": {k: float(v) for k, v in metrics.items()},
                          "launches": launches, "seconds": seconds, "shares": shares,
                          "from_rank0": from_rank0}
            print(f"rank {rank} {label}: launches {launches}, {seconds:.3f} s, metrics "
                  f"{out[label]['metrics']}", flush=True)
            if rank == 0:
                torch.save({k: v.cpu() for k, v in sd.items()},
                           os.path.join(folder, f"{label}.pt"))
                if label == "dp":  # the summed gradients Adam was given
                    torch.save({n: p.grad.detach().cpu()
                                for n, p in state.model.named_parameters()},
                               os.path.join(folder, "dp_grads.pt"))
            del state, step, sd
            torch.cuda.empty_cache()
        work = os.path.join(folder, "cli")
        written = []
        save = checkpoint_module._save

        def record(path, payload):
            written.append(os.path.relpath(path, work))
            save(path, payload)

        checkpoint_module._save = record
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            state = cli_train.main(["--model", "flownet2", "--synthetic", "2",
                                    "--image_size", str(SIZE), "--batch_size",
                                    str(BATCH), "--epochs", "1", "--cp", "0", "--fsdp",
                                    "--workdir", work, "--logdir",
                                    os.path.join(work, "log")], device="cuda")
        losses = [line for line in text.getvalue().splitlines() if "TRAIN done" in line]
        out["cli"] = {"step": state.step, "written": written,
                      "loss": float(losses[0].split("avg loss ")[1].split()[0])
                      if losses else float("nan")}
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dp_path(train_dirs):
    phase("8m. data parallel and --fsdp: (i) FlowNet2's DP train step over an NCCL "
          "group of one on cuda:0, fp32 and bf16, at 256², batch 8, and the --fsdp "
          "CLI; (ii) two ranks on the one card over gloo")
    base = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(1))
    with torchrun_env(0, 1, free_port()):
        init_from_env(DEV)  # NCCL, as under torchrun
    try:
        before, reference = dp_world_of_one(base, train_dirs)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    dp_two_ranks(base, before, reference)


def step_medians_beside_ctypes():
    print("\n  train steps beside commit bf75122's (kernels called through "
          "torch.library ops now, ctypes inside autograd.Functions then):")
    for label, then in CTYPES_TRAIN_MS.items():
        now = STEP_MEDIANS[label]
        print(f"    {label}: {now:.3f} ms, then {then:.3f} ms ({now / then - 1:+.1%})")


def kernel_row(name, source, replaces, counter, path, err, ms, plain, work,
               dtype, library):
    """One entry of the kernel table; ``launches`` is filled in from the
    counts of ``path`` (the eval or the train step) under ``counter``."""
    bms, by = bound(*work, dtype)
    return {"name": name, "route": "cuda", "source": f"tpureg_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": library, "_counter": counter, "_path": path}


def print_rows(rows):
    for row in rows:
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f} us"
        print(f"  {row['name']:24s} kernel {row['ms'] * 1e3:8.2f} us  plain "
              f"{row['plain_ms'] * 1e3:9.2f} us  bound {row['bound_ms'] * 1e3:6.2f} us "
              f"({row['bound_by']})  library {lib}")


# step_times' medians by label, and the train steps' at commit bf75122
# (NVIDIA H100 80GB HBM3, 700.00 W), when the kernels were ctypes calls
# inside autograd.Functions rather than torch.library ops
STEP_MEDIANS = {}
CTYPES_TRAIN_MS = {f"train step fp32, batch {BATCH} at 256²": 120.481,
                 f"train step bf16, batch {BATCH} at 256²": 111.754,
                 f"pwc-reg train step fp32, batch {BATCH} at 256²": 65.470}


def step_times(label, call, reps=10, warmup=2, per=BATCH, unit="pair"):
    """Median host time of ``call`` (which returns its metrics) to a
    synchronised card, after ``warmup`` calls; ``per`` items a step."""
    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = call()
        float(metrics["loss"])
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    STEP_MEDIANS[label] = med
    print(f"  {label}: median {med:.3f} ms ({med / per:.3f} ms per {unit}; min "
          f"{min(times):.3f}, max {max(times):.3f}, {reps} steps after {warmup})")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"    peak memory of one step: {(peak - resident) / 2**30:.3f} GiB "
          f"allocated above the {resident / 2**30:.3f} GiB resident before it "
          f"(weights, Adam's state and every other step's model)")
    return med


def rigid_positions(ang, tx, ty, size=VOLUME_SIZE, b=VOL_BATCH):
    """Positions [B, P] of the volume synthesis's warp (``affine_warp3d``)
    for a rotation by ``ang`` about the axial axis and an in-plane shift of
    (tx, ty) voxels."""
    d, h, w = size
    norm = lambda n: (2.0 * torch.arange(n, device=DEV, dtype=torch.float32) + 1.0) / n - 1.0
    zz, yy, xx = torch.meshgrid(norm(d), norm(h), norm(w), indexing="ij")
    c, s = float(np.cos(ang)), float(np.sin(ang))
    gx = xx * c - yy * s + tx * 2 / w
    gy = xx * s + yy * c + ty * 2 / h
    pos = (((gx + 1.0) * w - 1.0) / 2.0, ((gy + 1.0) * h - 1.0) / 2.0,
           ((zz + 1.0) * d - 1.0) / 2.0)
    return [t.expand(b, d, h, w).reshape(b, -1).contiguous() for t in pos]


def unit_grid(px, py, pz, shape):
    """``grid_sample``'s grid (align_corners=True) for voxel positions."""
    b, _, d, h, w = shape
    return torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1,
                        pz * (2 / (d - 1)) - 1], -1).reshape(b, d, h, w, 3)


def dpos_yardstick(label, cot, vol, pos, grid, reps):
    """``grid_sampler_3d_backward``'s d/dgrid, which is K6b's function scaled
    per axis by (size - 1) / 2: its agreement with K6b and its time. The
    derivative jumps at voxel planes, and grid_sample maps its normalised
    grid back to voxels as ((g + 1) / 2) * (size - 1), which can move a
    position across a plane; those positions are counted apart."""
    shape = tuple(vol.shape)
    b = shape[0]
    _, dgrid = torch.ops.aten.grid_sampler_3d_backward(
        cot.reshape(shape), vol, grid, 0, 0, True, [False, True])
    dpos = sample3d_dpos_cuda(cot, vol, *pos)
    moved = torch.zeros_like(pos[0], dtype=torch.bool)
    diff = []
    for k, n in enumerate((shape[4], shape[3], shape[2])):
        back = (grid[..., k].reshape(b, -1) + 1) / 2 * (n - 1)
        moved |= torch.floor(back) != torch.floor(pos[k])
        diff.append((dgrid[..., k].reshape(b, -1) - dpos[k] * ((n - 1) / 2)).abs())
    top = max(float(dgrid[..., k].abs().max()) for k in range(3))
    kept = max(float(d[~moved].max()) for d in diff)
    print(f"  grid_sampler_3d_backward d/dgrid agrees with K6b ({label}) to {kept:.3g} "
          f"(of {top:.3g}) where grid_sample's round trip keeps the voxel cell; "
          f"{int(moved.sum())} of {moved.numel()} positions change cell (largest "
          f"difference there {max(float(d.max()) for d in diff):.3g})")
    del dgrid, dpos, moved, diff
    return time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
        cot.reshape(shape), vol, grid, 0, 0, True, [False, True]), reps)


def warp3d_timings(errs, vols, vflow, velocity):
    """K6a, K6b and K6c at the shapes of the 3-D paths, with their plain
    versions and ``grid_sample``'s 5-D forward and backward as yardsticks."""
    rows = []
    moving = vols[..., 1][:, None].contiguous()   # [2, 1, 176, 256, 256]
    shape = tuple(moving.shape)
    # K6a: the synthesis's rigid warp of the moving volume
    px, py, pz = rigid_positions(0.5, 3.0, -2.0)
    p = px.shape[1]
    grid = unit_grid(px, py, pz, shape)
    ms = time_ms(lambda: sample3d_cuda(moving, px, py, pz), 50)
    plain = time_ms(lambda: sample3d_gather(moving, px, py, pz), 3, head_start_ms=300.0)
    lib_out = F.grid_sample(moving, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True).reshape(shape[0], 1, -1)
    print(f"  grid_sample 5-D yardstick agrees with K6a to "
          f"{float((lib_out - sample3d_cuda(moving, px, py, pz)).abs().max()):.3g}")
    lib = time_ms(lambda: F.grid_sample(moving, grid, mode="bilinear",
                                        padding_mode="zeros", align_corners=True), 50)
    rows.append(kernel_row("warp3d", "warp3d.cu", "tpureg/ops/warp3d_pallas.py:210",
                           "warp3d", "affine", errs["warp3d"]["final warp"], ms, plain,
                           warp3d_work(moving, p), torch.float32, lib))
    del px, py, pz, grid, lib_out
    # K6b at the final warp: the deform model's flow after five steps
    zz, yy, xx = voxel_grid(*VOLUME_SIZE, DEV)
    fpos = [(g + vflow[:, k]).reshape(shape[0], -1).contiguous()
            for k, g in enumerate((xx, yy, zz))]
    del zz, yy, xx
    grid = unit_grid(*fpos, shape)
    cot = torch.randn((shape[0], 1, p), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(33))
    ms = time_ms(lambda: sample3d_dpos_cuda(cot, moving, *fpos), 50)
    plain = time_ms(lambda: sample3d_dpos_reference(cot, moving, *fpos), 3,
                    head_start_ms=300.0)
    lib = dpos_yardstick("final warp", cot, moving, fpos, grid, 50)
    rows.append(kernel_row("warp3d_dpos", "warp3d.cu", "tpureg/ops/warp3d_pallas.py:210",
                           "warp3d_dpos", "deform", errs["warp3d_dpos"]["final warp"], ms,
                           plain, warp3d_dpos_work(moving, p), torch.float32, lib))
    del fpos, grid, cot
    # K6b and K6c at a composition's shape: the 3-channel field at half
    # resolution warped by itself, at N(0, 0.5²) displacements
    cshape = WARP3D_CASES[1][1]
    field, (cx, cy, cz) = warp3d_inputs(cshape, 0.5, 34)
    cp = cx.shape[1]
    grid = unit_grid(cx, cy, cz, cshape)
    cot = torch.randn((cshape[0], cshape[1], cp), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(35))
    ms = time_ms(lambda: sample3d_dpos_cuda(cot, field, cx, cy, cz), 100)
    plain = time_ms(lambda: sample3d_dpos_reference(cot, field, cx, cy, cz), 3,
                    head_start_ms=300.0)
    lib = dpos_yardstick("composition", cot, field, (cx, cy, cz), grid, 100)
    taps_bound, _ = bound(*warp3d_taps_work(field, cp), torch.float32)
    print(f"  (K6b's earlier function, the sample and three bases a channel, is "
          f"bound at {taps_bound * 1e3:.2f} us here)")
    rows.append(kernel_row("warp3d_dpos_composition", "warp3d.cu",
                           "tpureg/ops/warp3d_pallas.py:210", "warp3d_dpos", "deform",
                           errs["warp3d_dpos"]["composition"], ms, plain,
                           warp3d_dpos_work(field, cp), torch.float32, lib))
    # K6a at the composition: 7 of its 8 launches a deform step run here
    ms = time_ms(lambda: sample3d_cuda(field, cx, cy, cz), 100)
    plain = time_ms(lambda: sample3d_gather(field, cx, cy, cz), 3, head_start_ms=300.0)
    lib_out = F.grid_sample(field, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True).reshape(cshape[0], cshape[1], -1)
    print(f"  grid_sample 5-D yardstick agrees with K6a at the composition to "
          f"{float((lib_out - sample3d_cuda(field, cx, cy, cz)).abs().max()):.3g}")
    del lib_out
    lib = time_ms(lambda: F.grid_sample(field, grid, mode="bilinear",
                                        padding_mode="zeros", align_corners=True), 100)
    rows.append(kernel_row("warp3d_composition", "warp3d.cu",
                           "tpureg/ops/warp3d_pallas.py:210", "warp3d", "deform",
                           errs["warp3d"]["composition"], ms, plain,
                           warp3d_work(field, cp), torch.float32, lib))
    dimg_lib, _ = torch.ops.aten.grid_sampler_3d_backward(
        cot.reshape(cshape), field, grid, 0, 0, True, [True, False])
    print(f"  grid_sampler_3d_backward d/dinput agrees with K6c to "
          f"{float((dimg_lib - sample3d_dvol_cuda(cot, cx, cy, cz, cshape)).abs().max()):.3g}")
    del dimg_lib
    ms = time_ms(lambda: sample3d_dvol_cuda(cot, cx, cy, cz, cshape), 100)
    plain = time_ms(lambda: sample3d_dvol_reference(cot, cx, cy, cz, cshape), 3,
                    head_start_ms=300.0)
    lib = time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
        cot.reshape(cshape), field, grid, 0, 0, True, [True, False]), 100)
    rows.append(kernel_row("warp3d_dvol", "warp3d.cu", "tpureg/ops/warp3d_pallas.py:456",
                           "warp3d_dvol", "deform", errs["warp3d_dvol"]["composition"], ms,
                           plain, warp3d_dvol_work(cshape, cp, torch.float32),
                           torch.float32, lib))
    del field, cx, cy, cz, grid
    # K6b at the deform step's own first composition: its velocity after
    # exp_velocity3d's scaling by 2^-7, warped by itself (smooth, sub-voxel)
    sfield = (velocity / 2.0**7).contiguous()
    d, h, w = sfield.shape[2:]
    zz, yy, xx = voxel_grid(d, h, w, DEV)
    spos = [(g + sfield[:, k]).reshape(cshape[0], -1).contiguous()
            for k, g in enumerate((xx, yy, zz))]
    del zz, yy, xx
    grid = unit_grid(*spos, tuple(sfield.shape))
    want = sample3d_dpos_reference(cot, sfield, *spos)
    got = sample3d_dpos_cuda(cot, sfield, *spos)
    torch.cuda.synchronize()
    err = max(float((k - r).abs().max()) for k, r in zip(got, want))
    require(all(bool(((k - r).abs() <= 1e-6 + 1e-5 * r.abs()).all())
                for k, r in zip(got, want)),
            "K6b disagrees with its plain version at the step's composition")
    del want, got
    print(f"  K6b at the step's first composition: |displacement| max "
          f"{float(sfield.abs().max()):.3g} voxels; max |kernel - plain| = {err:.3g}")
    ms = time_ms(lambda: sample3d_dpos_cuda(cot, sfield, *spos), 100)
    plain = time_ms(lambda: sample3d_dpos_reference(cot, sfield, *spos), 3,
                    head_start_ms=300.0)
    lib = dpos_yardstick("step's composition", cot, sfield, spos, grid, 100)
    rows.append(kernel_row("warp3d_dpos_step_composition", "warp3d.cu",
                           "tpureg/ops/warp3d_pallas.py:210", "warp3d_dpos", "deform",
                           err, ms, plain, warp3d_dpos_work(sfield, cp), torch.float32,
                           lib))
    del spos, grid
    # K6c at the step's own first and last compositions: the scaled velocity
    # warped by itself, and the field after six of the seven squarings
    with torch.no_grad():
        last = exp_velocity3d(velocity / 2.0, 6).contiguous()
    for label, f in (("first", sfield), ("last", last)):
        zz, yy, xx = voxel_grid(d, h, w, DEV)
        pos = [(t + f[:, k]).reshape(cshape[0], -1).contiguous()
               for k, t in enumerate((xx, yy, zz))]
        del zz, yy, xx
        grid = unit_grid(*pos, tuple(f.shape))
        want = sample3d_dvol_reference(cot, *pos, cshape)
        got = sample3d_dvol_cuda(cot, *pos, cshape)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()),
                f"K6c disagrees with its plain version at the step's {label} composition")
        dimg_lib, _ = torch.ops.aten.grid_sampler_3d_backward(
            cot.reshape(cshape), f, grid, 0, 0, True, [True, False])
        print(f"  K6c at the step's {label} composition: |displacement| max "
              f"{float(f.abs().max()):.3g} voxels; max |kernel - plain| = {err:.3g}; "
              f"grid_sampler_3d_backward d/dinput agrees to "
              f"{float((dimg_lib - got).abs().max()):.3g}")
        del want, got, dimg_lib
        ms = time_ms(lambda: sample3d_dvol_cuda(cot, *pos, cshape), 100)
        plain = time_ms(lambda: sample3d_dvol_reference(cot, *pos, cshape), 3,
                        head_start_ms=300.0)
        lib = time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
            cot.reshape(cshape), f, grid, 0, 0, True, [True, False]), 100)
        rows.append(kernel_row(f"warp3d_dvol_step_{label}", "warp3d.cu",
                               "tpureg/ops/warp3d_pallas.py:456", "warp3d_dvol", "deform",
                               err, ms, plain, warp3d_dvol_work(cshape, cp, torch.float32),
                               torch.float32, lib))
        del pos, grid
    return rows


def tensor_core_bound(label, row, ms, nbytes, flops, dtype):
    """Print a row's bound on the tensor-core pipe that K1 and K2 run on
    beside the table's fp32-pipe bound: three TF32 products a multiply-add
    for fp32 operands, one bf16 product for bf16."""
    passes, rate = (3, TF32_FLOPS) if dtype == torch.float32 else (1, PEAK_FLOPS[dtype])
    t_ops = passes * flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  {label}: {ms * 1e3:.2f} us; the table's bound "
          f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
          f"operations at {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s); on the tensor cores "
          f"it runs on ({passes} pass{'es' if passes > 1 else ''} at "
          f"{rate / 1e12:.0f} TFLOP/s) {max(t_ops, t_bytes) * 1e3:.2f} us "
          f"({'operations' if t_ops >= t_bytes else 'bytes'})")


def dimg_timings():
    """K5 at the shapes of the 2-D paths to come, at smooth positions:
    SyN's compose of a 2-channel field at 256² and PWC's level-2 feature
    warp, with ``grid_sampler_2d_backward`` d/dinput as the yardstick (fp32)."""
    rows = []
    for name, shape in (("syn", (1, 2, SIZE, SIZE)), ("pwc", (BATCH, 32, 64, 64))):
        b, c, h, w = shape
        px, py = smooth_positions(b, h, w, 2.0, seed=23)
        p = px.shape[1]
        cot = torch.randn((b, c, p), device=DEV,
                          generator=torch.Generator(device=DEV).manual_seed(24))
        grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1],
                           -1).reshape(b, h, w, 2)
        img = torch.zeros(shape, device=DEV)
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            err = check_dimg(f"{shape} {name}", shape, px, py, dtype)
            lib = None
            if dtype == torch.float32:
                dimg_lib, _ = torch.ops.aten.grid_sampler_2d_backward(
                    cot.reshape(shape), img, grid, 0, 0, True, [True, False])
                got = sample2d_dimg_cuda(cot, px, py, shape, dtype)
                print(f"  grid_sampler_2d_backward d/dinput agrees with K5 at {shape} to "
                      f"{float((dimg_lib - got).abs().max()):.3g}")
                lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                    cot.reshape(shape), img, grid, 0, 0, True, [True, False]), 200)
            ms = time_ms(lambda: sample2d_dimg_cuda(cot, px, py, shape, dtype), 200)
            plain = time_ms(lambda: sample2d_dimg_reference(cot, px, py, shape, dtype),
                            10, head_start_ms=100.0)
            rows.append(kernel_row(
                f"warp2d_dimg_{name}{sfx}", "warp2d_grad.cu",
                "tpureg/ops/warp_pallas.py:230", "warp2d_dimg",
                "pwc_train" if name == "pwc" else "train", err, ms, plain,
                warp_dimg_work(shape, p, dtype), torch.float32, lib))
    return rows


def timings(eval_steps, imgs, segs, flow, errs, train_steps, train_imgs,
            vol_steps, vols, vflow, velocity):
    phase("9. timings (CUDA events, back-to-back launches queued ahead, warm L2)")
    kernels = []
    g = torch.Generator(device=DEV).manual_seed(4)
    f1 = torch.randn((BATCH, 256, 32, 32), device=DEV, generator=g)
    f2 = torch.randn((BATCH, 256, 32, 32), device=DEV, generator=g)
    k = displacement_count(20, 2)
    cot = torch.randn((BATCH, k * k, 32, 32), device=DEV, generator=g)
    for dtype, sfx, line in ((torch.float32, "", 54), (torch.bfloat16, "_bf16", 130)):
        a, b, gr = f1.to(dtype), f2.to(dtype), cot.to(dtype)
        ms = time_ms(lambda: correlation_cuda(a, b, 20, 2), 50)
        plain = time_ms(lambda: correlation_reference(a, b, 20, 2), 3,
                        head_start_ms=300.0)
        kernels.append(kernel_row(
            "correlation" + sfx, "correlation.cu",
            f"tpureg/ops/correlation_pallas.py:{line}", "correlation", "eval",
            errs["corr"][dtype], ms, plain,
            correlation_work(a.shape, 20, 2, dtype), dtype, None))
        tensor_core_bound(f"correlation{sfx}", kernels[-1], ms,
                          *correlation_work(a.shape, 20, 2, dtype), dtype)
        # K1 at PWC's level 3 at 256² (81 displacements; 5 launches a
        # forward of the PWC family, one a level)
        pshape = (BATCH, 64, 32, 32)
        pg = torch.Generator(device=DEV).manual_seed(25)
        pa = torch.randn(pshape, device=DEV, generator=pg).to(dtype)
        pb = torch.randn(pshape, device=DEV, generator=pg).to(dtype)
        got = correlation_cuda(pa, pb, 4, 1).float()
        want = correlation_reference(pa, pb, 4, 1).float()
        perr = float((got - want).abs().max())
        pms = time_ms(lambda: correlation_cuda(pa, pb, 4, 1), 200)
        pplain = time_ms(lambda: correlation_reference(pa, pb, 4, 1), 3,
                         head_start_ms=300.0)
        kernels.append(kernel_row(
            "correlation_pwc" + sfx, "correlation.cu",
            f"tpureg/ops/correlation_pallas.py:{line}", "correlation", "pwc_eval", perr,
            pms, pplain, correlation_work(pshape, 4, 1, dtype), dtype, None))
        tensor_core_bound(f"correlation_pwc{sfx} {pshape} md 4 s2 1", kernels[-1], pms,
                          *correlation_work(pshape, 4, 1, dtype), dtype)
        del pa, pb, got, want
        # K2 on the cotangent of the train step's dtype
        ms = time_ms(lambda: correlation_bwd_cuda(a, b, gr, 20, 2), 50)
        plain = time_ms(lambda: correlation_bwd_reference(a, b, gr, 20, 2), 3,
                        head_start_ms=300.0)
        kernels.append(kernel_row(
            "correlation_bwd" + sfx, "correlation_bwd.cu",
            "tpureg/ops/correlation_pallas.py:335", "correlation_bwd", "train",
            errs["corr_bwd"][dtype], ms, plain,
            correlation_bwd_work(a.shape, 20, 2, dtype, dtype), dtype, None))
        tensor_core_bound(f"correlation_bwd{sfx}", kernels[-1], ms,
                          *correlation_bwd_work(a.shape, 20, 2, dtype, dtype), dtype)

    # the warps at the positions of the eval path: the head's stn warp of the
    # moving image by the fp32 step's fused flow, (x + u) * (W - 1) / W
    base = torch.arange(SIZE, device=DEV, dtype=torch.float32)
    px = ((base + flow[..., 0]) * ((SIZE - 1) / SIZE)).reshape(BATCH, -1).contiguous()
    py = ((base[:, None] + flow[..., 1]) * ((SIZE - 1) / SIZE)).reshape(
        BATCH, -1).contiguous()
    p = px.shape[1]
    moving = imgs[..., 1][:, None].contiguous()
    shape = tuple(moving.shape)
    # grid_sample's grid for the same positions, align_corners=True:
    # x_norm = 2 x / (W - 1) - 1
    grid = torch.stack([px * (2 / (SIZE - 1)) - 1, py * (2 / (SIZE - 1)) - 1],
                       -1).reshape(BATCH, SIZE, SIZE, 2)
    cot = torch.randn((BATCH, 1, p), device=DEV, generator=g)
    cot_img = cot.reshape(shape)
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        img = moving.to(dtype)
        ms = time_ms(lambda: sample2d_cuda(img, px, py), 200)
        plain = time_ms(lambda: sample2d_gather(img, px, py), 20, head_start_ms=100.0)
        # and at the scattered out-of-image positions of phase 4
        rimg, rpx, rpy = warp_inputs(dtype, seed=5)
        scattered = time_ms(lambda: sample2d_cuda(rimg, rpx, rpy), 200)
        print(f"  warp2d{sfx}: kernel at scattered positions (flow std 60 px): "
              f"{scattered * 1e3:.2f} us")
        lib = lib_dpos = lib_dimg = None
        if dtype == torch.float32:
            ref = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=True).reshape(BATCH, 1, -1)
            print(f"  grid_sample yardstick agrees with K3 to "
                  f"{float((ref - sample2d_cuda(img, px, py)).abs().max()):.3g}")
            lib = time_ms(lambda: F.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), 200)
            # grid_sampler_2d_backward: d/dgrid for K4, d/dinput for K5
            dimg_lib, dgrid_lib = torch.ops.aten.grid_sampler_2d_backward(
                cot_img, img, grid, 0, 0, True, [True, True])
            dpx = sample2d_dpos_cuda(cot, img, px, py)[0]
            dx = dpx.reshape(BATCH, SIZE, SIZE) * ((SIZE - 1) / 2)
            print(f"  grid_sampler_2d_backward yardsticks agree with K4 to "
                  f"{float((dgrid_lib[..., 0] - dx).abs().max()):.3g} (of "
                  f"{float(dx.abs().max()):.3g}) and with K5 to "
                  f"{float((dimg_lib - sample2d_dimg_cuda(cot, px, py, shape)).abs().max()):.3g}")
            lib_dpos = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot_img, img, grid, 0, 0, True, [False, True]), 200)
            node_timings("FlowNet2's stn positions", img, px, py, cot, grid, True)
            lib_dimg = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot_img, img, grid, 0, 0, True, [True, False]), 200)
        else:
            # grid_sample takes its grid in the image's dtype: a bf16 grid
            # rounds the positions to 8 bits (up to 1 px at 256²), which is
            # another function, so the bf16 rows have no yardstick
            gb = grid.to(dtype)
            t = time_ms(lambda: F.grid_sample(img, gb, mode="bilinear",
                                              padding_mode="zeros",
                                              align_corners=True), 200)
            print(f"  grid_sample with a bf16 grid (positions rounded to bf16, "
                  f"not K3's function): {t * 1e3:.2f} us")
        kernels.append(kernel_row(
            "warp2d" + sfx, "warp2d.cu", "tpureg/ops/warp_pallas.py:183", "warp2d",
            "eval", errs["warp"][dtype], ms, plain, warp_work(img, p),
            torch.float32, lib))
        ms = time_ms(lambda: sample2d_dpos_cuda(cot, img, px, py), 200)
        plain = time_ms(lambda: sample2d_dpos_reference(cot, img, px, py), 10,
                        head_start_ms=100.0)
        kernels.append(kernel_row(
            "warp2d_dpos" + sfx, "warp2d_grad.cu", "tpureg/ops/warp_pallas.py:197",
            "warp2d_dpos", "train", errs["dpos"][dtype], ms, plain,
            warp_dpos_work(img, p), torch.float32, lib_dpos))
        ms = time_ms(lambda: sample2d_dimg_cuda(cot, px, py, shape, dtype), 200)
        plain = time_ms(lambda: sample2d_dimg_reference(cot, px, py, shape, dtype),
                        10, head_start_ms=100.0)
        kernels.append(kernel_row(
            "warp2d_dimg" + sfx, "warp2d_grad.cu", "tpureg/ops/warp_pallas.py:230",
            "warp2d_dimg", "train", errs["dimg"][dtype], ms, plain,
            warp_dimg_work(shape, p, dtype), torch.float32, lib_dimg))
    kernels += dimg_timings()
    kernels += warp3d_timings(errs["warp3d"], vols, vflow, velocity)
    print_rows(kernels)

    for name, step in eval_steps.items():
        step_times(f"eval step {name}, batch {BATCH} at 256² with segs",
                   lambda: step(imgs, segs)[1])
    for name, step in train_steps.items():
        step_times(f"train step {name}, batch {BATCH} at 256²",
                   lambda: step(train_imgs))
    for name, step in vol_steps.items():
        step_times(f"3-D {name} train step fp32, batch {VOL_BATCH} at 176 x 256 x 256",
                   lambda: step(vols), per=VOL_BATCH, unit="volume")
    return kernels


def node_timings(label, img, px, py, cot, grid, align_corners):
    """The 2-D node's forward and positions' backward, as a train step runs
    a warp whose image is an input: K3, then K4 on the cotangent ``cot``
    [B, C, P], against ``grid_sample`` and ``grid_sampler_2d_backward``'s
    d/dgrid on the same positions (``grid``); turns ours, library, library,
    ours."""
    backward = torch.ops.aten.grid_sampler_2d_backward
    cot_img = cot.reshape(img.shape)

    def ours():
        sample2d_cuda(img, px, py)
        return sample2d_dpos_cuda(cot, img, px, py)

    def library():
        F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=align_corners)
        return backward(cot_img, img, grid, 0, 0, align_corners, [False, True])

    # 2 launches a call: a head start long enough for the host to queue them
    run = lambda fn: time_ms(fn, 100, head_start_ms=50.0)
    t = [run(ours), run(library), run(library), run(ours)]
    print(f"  node at {label} {tuple(img.shape)}, forward and positions' backward: "
          f"K3 + K4 {t[0] * 1e3:.2f} / {t[3] * 1e3:.2f} us; grid_sample + d/dgrid "
          f"{t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} us (turns: ours, library, library, ours)")


def pwc_timings(errs):
    """PWC's kernels at its own shapes: K1 and K2 at levels 2 and 6, fp32
    and bf16; at the four feature warps K3 (fp32 and bf16) beside
    ``grid_sample``, K4 and K5 (fp32) beside ``grid_sampler_2d_backward``'s
    cotangents, the node's forward and positions' backward (K3 + K4), and
    K3, K4 and K5 as one number against ``grid_sample`` and
    ``grid_sampler_2d_backward`` (both cotangents), the library's version
    of the same forward and backward; K3 on the level-2 validity mask."""
    rows = []
    for lvl, shape in ((2, (BATCH, 32, 64, 64)), (6, (BATCH, 196, 4, 4))):
        g = torch.Generator(device=DEV).manual_seed(50 + lvl)
        f1 = torch.randn(shape, device=DEV, generator=g)
        f2 = torch.randn(shape, device=DEV, generator=g)
        cot = torch.randn((shape[0], 81, *shape[2:]), device=DEV, generator=g)
        for dtype, sfx, line in ((torch.float32, "", 54), (torch.bfloat16, "_bf16", 130)):
            a, b, gr = f1.to(dtype), f2.to(dtype), cot.to(dtype)
            err = float((correlation_cuda(a, b, 4, 1).float()
                         - correlation_reference(a, b, 4, 1).float()).abs().max())
            ms = time_ms(lambda: correlation_cuda(a, b, 4, 1), 200)
            plain = time_ms(lambda: correlation_reference(a, b, 4, 1), 5,
                            head_start_ms=100.0)
            work = correlation_work(shape, 4, 1, dtype)
            rows.append(kernel_row(
                f"correlation_pwc_l{lvl}{sfx}", "correlation.cu",
                f"tpureg/ops/correlation_pallas.py:{line}", "correlation", "pwc_eval",
                err, ms, plain, work, dtype, None))
            tensor_core_bound(f"correlation_pwc_l{lvl}{sfx} {shape}", rows[-1], ms,
                              *work, dtype)
            got = correlation_bwd_cuda(a, b, gr, 4, 1)
            want = correlation_bwd_reference(a, b, gr, 4, 1)
            err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
            ms = time_ms(lambda: correlation_bwd_cuda(a, b, gr, 4, 1), 200)
            plain = time_ms(lambda: correlation_bwd_reference(a, b, gr, 4, 1), 3,
                            head_start_ms=100.0)
            work = correlation_bwd_work(shape, 4, 1, dtype, dtype)
            rows.append(kernel_row(
                f"correlation_bwd_pwc_l{lvl}{sfx}", "correlation_bwd.cu",
                "tpureg/ops/correlation_pallas.py:335", "correlation_bwd", "pwc_train",
                err, ms, plain, work, dtype, None))
            tensor_core_bound(f"correlation_bwd_pwc_l{lvl}{sfx} {shape}", rows[-1], ms,
                              *work, dtype)

    backward = torch.ops.aten.grid_sampler_2d_backward
    for lvl, c, h in PWC_WARPS:
        shape = (BATCH, c, h, h)
        flow = smooth_flow(BATCH, h, h, 2.0, seed=40 + lvl)  # phase 4d's flow
        px, py = pwc_positions(flow)
        p = px.shape[1]
        g = torch.Generator(device=DEV).manual_seed(60 + lvl)
        img = torch.rand(shape, device=DEV, generator=g)
        cot = torch.randn((BATCH, c, p), device=DEV, generator=g)
        cot_img = cot.reshape(shape)
        # grid_sample's grid for the same positions, align_corners=False:
        # x = ((gx + 1) W - 1) / 2, so gx = (2 x + 1) / W - 1
        grid = torch.stack([(2 * px + 1) / h - 1, (2 * py + 1) / h - 1],
                           -1).reshape(BATCH, h, h, 2)
        dimg_lib, dgrid_lib = backward(cot_img, img, grid, 0, 0, False, [True, True])
        dx = sample2d_dpos_cuda(cot, img, px, py)[0].reshape(BATCH, h, h) * (h / 2)
        print(f"  PWC level {lvl} {shape}: grid_sampler_2d_backward agrees with "
              f"K4 to {float((dgrid_lib[..., 0] - dx).abs().max()):.3g} (of "
              f"{float(dx.abs().max()):.3g}) and with K5 to "
              f"{float((dimg_lib - sample2d_dimg_cuda(cot, px, py, shape)).abs().max()):.3g}")
        # K3, the feature warp's forward, in fp32 and bf16 (grid_sample takes
        # its grid in the image's dtype, so the bf16 row has no yardstick)
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            im = img.to(dtype)
            ms = time_ms(lambda: sample2d_cuda(im, px, py), 200)
            plain = time_ms(lambda: sample2d_gather(im, px, py), 20, head_start_ms=100.0)
            lib = None
            if dtype == torch.float32:
                lib = time_ms(lambda: F.grid_sample(im, grid, mode="bilinear",
                                                    padding_mode="zeros",
                                                    align_corners=False), 200)
            rows.append(kernel_row(
                f"warp2d_pwc_l{lvl}{sfx}", "warp2d.cu", "tpureg/ops/warp_pallas.py:183",
                "warp2d", "pwc_train", errs[lvl][dtype]["warp2d"], ms, plain,
                warp_work(im, p), torch.float32, lib))
        ms = time_ms(lambda: sample2d_dpos_cuda(cot, img, px, py), 200)
        plain = time_ms(lambda: sample2d_dpos_reference(cot, img, px, py), 3,
                        head_start_ms=100.0)
        lib = time_ms(lambda: backward(cot_img, img, grid, 0, 0, False, [False, True]), 200)
        rows.append(kernel_row(
            f"warp2d_dpos_pwc_l{lvl}", "warp2d_grad.cu", "tpureg/ops/warp_pallas.py:197",
            "warp2d_dpos", "pwc_train", errs[lvl][torch.float32]["warp2d_dpos"], ms, plain,
            warp_dpos_work(img, p), torch.float32, lib))
        ms = time_ms(lambda: sample2d_dimg_cuda(cot, px, py, shape), 200)
        plain = time_ms(lambda: sample2d_dimg_reference(cot, px, py, shape), 5,
                        head_start_ms=100.0)
        lib = time_ms(lambda: backward(cot_img, img, grid, 0, 0, False, [True, False]), 200)
        rows.append(kernel_row(
            f"warp2d_dimg_pwc_l{lvl}", "warp2d_grad.cu", "tpureg/ops/warp_pallas.py:230",
            "warp2d_dimg", "pwc_train", errs[lvl][torch.float32]["warp2d_dimg"], ms, plain,
            warp_dimg_work(shape, p, torch.float32), torch.float32, lib))
        node_timings(f"PWC level {lvl}", img, px, py, cot, grid, False)

        def ours():
            # the train step's feature warp: K3 forward, then K4 and K5
            sample2d_cuda(img, px, py)
            sample2d_dpos_cuda(cot, img, px, py)
            return sample2d_dimg_cuda(cot, px, py, shape)

        def library():
            F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)
            return backward(cot_img, img, grid, 0, 0, False, [True, True])

        # 4 launches a call: a longer head start and fewer calls, so that
        # the host queues them all before the card reaches the start
        both = lambda fn: time_ms(fn, 50, head_start_ms=100.0)
        t_ours, t_lib = both(ours), both(library)
        t_ours2, t_lib2 = both(ours), both(library)
        print(f"  PWC level {lvl} {shape}, sample and both cotangents: K3 + K4 + K5 "
              f"{t_ours * 1e3:.2f} / {t_ours2 * 1e3:.2f} us; grid_sample "
              f"+ grid_sampler_2d_backward {t_lib * 1e3:.2f} / {t_lib2 * 1e3:.2f} us "
              f"(two turns); the {'kernels' if t_ours + t_ours2 < t_lib + t_lib2 else 'library'} "
              f"faster")

    flow = smooth_flow(BATCH, 64, 64, 2.0, seed=70)
    px, py = pwc_positions(flow)
    grid = torch.stack([(2 * px + 1) / 64 - 1, (2 * py + 1) / 64 - 1],
                       -1).reshape(BATCH, 64, 64, 2)
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        ones = torch.ones((BATCH, 1, 64, 64), dtype=dtype, device=DEV)
        got = sample2d_cuda(ones, px, py)
        want = sample2d_gather(ones.float(), px, py)
        err = float((got - want).abs().max())
        require(bool(torch.equal(got, want)), "K3 on the mask disagrees")
        ms = time_ms(lambda: sample2d_cuda(ones, px, py), 200)
        plain = time_ms(lambda: sample2d_gather(ones, px, py), 20, head_start_ms=100.0)
        lib = None
        if dtype == torch.float32:
            lib = time_ms(lambda: F.grid_sample(ones, grid, mode="bilinear",
                                                padding_mode="zeros",
                                                align_corners=False), 200)
        rows.append(kernel_row(
            f"warp2d_mask_pwc{sfx}", "warp2d.cu", "tpureg/ops/warp_pallas.py:183",
            "warp2d", "pwc_train", err, ms, plain, warp_work(ones, px.shape[1]),
            torch.float32, lib))
    return rows


def touched_taps(shape, px, py):
    """How many distinct image pixels the in-image taps of ``px``, ``py``
    [B, P] reach in images [B, C, H, W], counted once a batch row: what a
    sample must read of a one-channel image when its positions cover only
    part of it (RAFT's lookups)."""
    b, _, h, w = shape
    x0, y0 = px.floor().long(), py.floor().long()
    row = torch.arange(b, device=DEV)[:, None] * (h * w)
    idx = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            idx.append((row + y * w + x)[ok])
    return int(torch.unique(torch.cat(idx)).numel())


def raft_lookup_positions(b, h, w, lvl, seed):
    """raft-reg's lookup positions at pyramid level ``lvl`` of [h, w]
    level-0 maps: one map a pixel of B [h, w] feature maps, centred at the
    pixel plus a smooth 2 px flow, scaled by 2^-lvl, and the 9 x 9 offsets
    around it, dy-major: [B·h·w, 81]."""
    flow = smooth_flow(b, h, w, 2.0, seed)
    cx = (torch.arange(w, device=DEV, dtype=torch.float32) + flow[:, 0]).reshape(-1, 1)
    cy = (torch.arange(h, device=DEV, dtype=torch.float32)[:, None]
          + flow[:, 1]).reshape(-1, 1)
    d = torch.arange(-4, 5, device=DEV, dtype=torch.float32)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    scale = 2.0**lvl
    return ((cx / scale + dx.reshape(1, -1)).contiguous(),
            (cy / scale + dy.reshape(1, -1)).contiguous())


def raft_timings():
    """K3, K4 and K5 at raft-reg's shapes at 256², fp32 and bf16, each beside
    its plain version and, in fp32, the library call on the same positions
    (``grid_sample``, ``grid_sampler_2d_backward`` d/dgrid and d/dinput):
    the lookup at level 0 (batch 8: 8 · 64² maps of 64²), at level 3 (maps
    of 8²) and at batch 16 (65,536 maps, more than one launch's 65,535
    rows), 81 positions a map; and the feature warp of the moving features,
    (8, 128, 64, 64), "pixel" convention, at a smooth 2 px flow. K3's and
    K4's bounds count the image pixels that the taps reach."""
    rows = []
    backward = torch.ops.aten.grid_sampler_2d_backward
    cases = (("lookup_l0", 8, 0, 64), ("lookup_l3", 8, 3, 8),
             ("lookup_b16", 16, 0, 64), ("feature_warp", 8, None, 64))
    for label, b, lvl, h in cases:
        if lvl is None:
            shape = (b, 128, h, h)
            flow = smooth_flow(b, h, h, 2.0, seed=80)
            px = (torch.arange(h, device=DEV, dtype=torch.float32) + flow[:, 0]).reshape(b, -1)
            py = (torch.arange(h, device=DEV, dtype=torch.float32)[:, None]
                  + flow[:, 1]).reshape(b, -1)
            px, py = px.contiguous(), py.contiguous()
            touched = None
            out_hw = (h, h)
        else:
            shape = (b * 64 * 64, 1, h, h)
            px, py = raft_lookup_positions(b, 64, 64, lvl, seed=81)
            touched = touched_taps(shape, px, py)
            out_hw = (9, 9)
        n, c = shape[:2]
        p = px.shape[1]
        g = torch.Generator(device=DEV).manual_seed(82)
        img32 = torch.randn(shape, device=DEV, generator=g)
        cot = torch.randn((n, c, p), device=DEV, generator=g)
        # grid_sample's grid for pixel positions, align_corners=True
        grid = torch.stack([px * (2 / (h - 1)) - 1, py * (2 / (h - 1)) - 1],
                           -1).reshape(n, *out_hw, 2)
        cot_img = cot.reshape(n, c, *out_hw)
        print(f"  RAFT {label} {shape}, P={p}"
              + ("" if touched is None else
                 f": the taps reach {touched} pixels of {n * h * h}"))
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            img = img32.to(dtype)
            got = sample2d_cuda(img, px, py)
            require(bool(torch.equal(got, sample2d_gather(img.float(), px, py))),
                    f"K3 disagrees at RAFT's {label}")
            del got
            dpos_err = check_dpos(f"RAFT {label}", img, px, py)
            dimg_err = check_dimg(f"RAFT {label}", shape, px, py, dtype)
            lib = lib_dpos = lib_dimg = None
            if dtype == torch.float32:
                lib = time_ms(lambda: F.grid_sample(img, grid, mode="bilinear",
                                                    padding_mode="zeros",
                                                    align_corners=True), 100)
                lib_dpos = time_ms(lambda: backward(cot_img, img, grid, 0, 0, True,
                                                    [False, True]), 100)
                lib_dimg = time_ms(lambda: backward(cot_img, img, grid, 0, 0, True,
                                                    [True, False]), 50)
            nbytes, flops = warp_work(img, p)
            if touched is not None:
                nbytes -= img.numel() * img.element_size() - touched * img.element_size()
            ms = time_ms(lambda: sample2d_cuda(img, px, py), 100)
            plain = time_ms(lambda: sample2d_gather(img, px, py), 5, head_start_ms=100.0)
            rows.append(kernel_row(
                f"warp2d_raft_{label}{sfx}", "warp2d.cu", "tpureg/ops/warp_pallas.py:183",
                "warp2d", "raft_train", 0.0, ms, plain, (nbytes, flops), torch.float32,
                lib))
            nbytes, flops = warp_dpos_work(img, p)
            if touched is not None:
                nbytes -= img.numel() * img.element_size() - touched * img.element_size()
            ms = time_ms(lambda: sample2d_dpos_cuda(cot, img, px, py), 100)
            plain = time_ms(lambda: sample2d_dpos_reference(cot, img, px, py), 3,
                            head_start_ms=100.0)
            rows.append(kernel_row(
                f"warp2d_dpos_raft_{label}{sfx}", "warp2d_grad.cu",
                "tpureg/ops/warp_pallas.py:197", "warp2d_dpos", "raft_train", dpos_err,
                ms, plain, (nbytes, flops), torch.float32, lib_dpos))
            ms = time_ms(lambda: sample2d_dimg_cuda(cot, px, py, shape, dtype), 50)
            plain = time_ms(lambda: sample2d_dimg_reference(cot, px, py, shape, dtype), 3,
                            head_start_ms=100.0)
            rows.append(kernel_row(
                f"warp2d_dimg_raft_{label}{sfx}", "warp2d_grad.cu",
                "tpureg/ops/warp_pallas.py:230", "warp2d_dimg", "raft_train", dimg_err,
                ms, plain, warp_dimg_work(shape, p, dtype), torch.float32, lib_dimg))
            del img
        del img32, cot, cot_img, grid, px, py
        torch.cuda.empty_cache()
    return rows


def composition_positions(field):
    """Positions [B, P] of ``field`` [B, C, ...] (C = 2 or 3) composed with
    itself: the grid plus the field, (x, y[, z])."""
    b = field.shape[0]
    if field.dim() == 4:
        grid = (torch.arange(field.shape[3], device=DEV, dtype=torch.float32),
                torch.arange(field.shape[2], device=DEV, dtype=torch.float32)[:, None])
    else:
        zz, yy, xx = voxel_grid(*field.shape[2:], DEV)
        grid = (xx, yy, zz)
    return [(g + field[:, k]).reshape(b, -1).contiguous() for k, g in enumerate(grid)]


def syn_timings(flow, flow3d):
    """K3, K4 and K5 at the 2-D comparator's last composition, at the 64²
    level (K4, K5 and the node K3 + K4) and in the final exponential at 256²
    (K3), and K6a, K6b
    and K6c at the 3-D comparator's last full-resolution composition, each
    with its plain version and the library call that computes its function
    (fp32). The fields are the registrations' own: a velocity is taken as
    the registered flow brought to the level, and the last composition
    composes exp(v / 2) with itself."""
    rows = []
    with torch.no_grad():
        v64 = resize2d(flow, (64, 64)) * (64 / SIZE)
        f64 = exp_velocity(v64 / 2, 5).contiguous()
        f256 = exp_velocity(flow / 2, 5).contiguous()
    shape = tuple(f64.shape)
    px, py = composition_positions(f64)
    p = px.shape[1]
    grid = torch.stack([px * (2 / (shape[3] - 1)) - 1, py * (2 / (shape[2] - 1)) - 1],
                       -1).reshape(shape[0], shape[2], shape[3], 2)
    cot = torch.randn((shape[0], shape[1], p), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(50))
    print(f"  SyN's composition {shape}, |displacement| max {float(f64.abs().max()):.3g} px:")
    require(bool(torch.equal(sample2d_cuda(f64, px, py), sample2d_gather(f64, px, py))),
            "K3 disagrees with its plain version at SyN's composition")
    dpos_err = check_dpos(f"at SyN's composition {shape}", f64, px, py, seed=50)
    check_dpos(f"at SyN's composition {shape}", f64.bfloat16(), px, py, seed=50)
    _, dgrid = torch.ops.aten.grid_sampler_2d_backward(
        cot.reshape(shape), f64, grid, 0, 0, True, [False, True])
    dx = sample2d_dpos_cuda(cot, f64, px, py)[0].reshape(
        shape[0], shape[2], shape[3]) * ((shape[3] - 1) / 2)
    print(f"  grid_sampler_2d_backward d/dgrid agrees with K4 to "
          f"{float((dgrid[..., 0] - dx).abs().max()):.3g} (of {float(dx.abs().max()):.3g})")
    ms = time_ms(lambda: sample2d_dpos_cuda(cot, f64, px, py), 200)
    plain = time_ms(lambda: sample2d_dpos_reference(cot, f64, px, py), 10,
                    head_start_ms=100.0)
    lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        cot.reshape(shape), f64, grid, 0, 0, True, [False, True]), 200)
    rows.append(kernel_row("warp2d_dpos_syn", "warp2d_grad.cu",
                           "tpureg/ops/warp_pallas.py:197", "warp2d_dpos", "syn",
                           dpos_err, ms, plain, warp_dpos_work(f64, p), torch.float32, lib))
    node_timings("SyN's composition", f64, px, py, cot, grid, True)
    dimg_err = check_dimg(f"SyN's composition {shape}", shape, px, py, torch.float32)
    dimg_lib, _ = torch.ops.aten.grid_sampler_2d_backward(
        cot.reshape(shape), f64, grid, 0, 0, True, [True, False])
    print(f"  grid_sampler_2d_backward d/dinput agrees with K5 to "
          f"{float((dimg_lib - sample2d_dimg_cuda(cot, px, py, shape)).abs().max()):.3g}")
    ms = time_ms(lambda: sample2d_dimg_cuda(cot, px, py, shape), 200)
    plain = time_ms(lambda: sample2d_dimg_reference(cot, px, py, shape), 10,
                    head_start_ms=100.0)
    lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        cot.reshape(shape), f64, grid, 0, 0, True, [True, False]), 200)
    rows.append(kernel_row("warp2d_dimg_syn_level", "warp2d_grad.cu",
                           "tpureg/ops/warp_pallas.py:230", "warp2d_dimg", "syn",
                           dimg_err, ms, plain, warp_dimg_work(shape, p, torch.float32),
                           torch.float32, lib))
    # K3 in the final exponential at 256²
    shape = tuple(f256.shape)
    px, py = composition_positions(f256)
    p = px.shape[1]
    grid = torch.stack([px * (2 / (SIZE - 1)) - 1, py * (2 / (SIZE - 1)) - 1],
                       -1).reshape(shape[0], SIZE, SIZE, 2)
    got = sample2d_cuda(f256, px, py)
    exact = bool(torch.equal(got, sample2d_gather(f256, px, py)))
    lib_err = float((F.grid_sample(f256, grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=True).reshape(got.shape) - got).abs().max())
    print(f"  K3 at the final exponential's composition {shape}: equal to the plain "
          f"gather: {exact}; grid_sample agrees to {lib_err:.3g}")
    require(exact, "K3 disagrees with its plain version at SyN's final exponential")
    ms = time_ms(lambda: sample2d_cuda(f256, px, py), 200)
    plain = time_ms(lambda: sample2d_gather(f256, px, py), 20, head_start_ms=100.0)
    lib = time_ms(lambda: F.grid_sample(f256, grid, mode="bilinear", padding_mode="zeros",
                                        align_corners=True), 200)
    rows.append(kernel_row("warp2d_syn", "warp2d.cu", "tpureg/ops/warp_pallas.py:183",
                           "warp2d", "syn", 0.0, ms, plain, warp_work(f256, p),
                           torch.float32, lib))

    # K6a, K6b, K6c at the 3-D comparator's last composition at full size
    with torch.no_grad():
        f3 = exp_velocity3d(flow3d / 2, 5).contiguous()
    shape = tuple(f3.shape)
    pos = composition_positions(f3)
    p = pos[0].shape[1]
    grid = unit_grid(*pos, shape)
    cot = torch.randn((shape[0], shape[1], p), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(51))
    got = sample3d_cuda(f3, *pos)
    exact = bool(torch.equal(got, sample3d_gather(f3, *pos)))
    dpos = sample3d_dpos_cuda(cot, f3, *pos)
    ref = sample3d_dpos_reference(cot, f3, *pos)
    # each basis is a difference of corner values, here displacements of up
    # to several voxels, so its roundings are of the values' size, not of
    # the difference's: a few fp32 roundings of max(1, |field|) times
    # Σ_c |g_c|, beside 1e-5 of the result (phase 4c's volumes are in [0, 1])
    scale = max(1.0, float(f3.abs().max()))
    torch.cuda.synchronize()
    pos_err = max(float((k - r).abs().max()) for k, r in zip(dpos, ref))
    pos_ok = all(bool(((k - r).abs() <= 1e-6 * scale * cot.abs().sum(1)
                       + 1e-5 * r.abs()).all()) for k, r in zip(dpos, ref))
    del got, dpos, ref
    dvol = sample3d_dvol_cuda(cot, *pos, shape)
    dref = sample3d_dvol_reference(cot, *pos, shape)
    torch.cuda.synchronize()
    dvol_err = float((dvol - dref).abs().max())
    dvol_ok = bool(((dvol - dref).abs() <= 1e-5 + 1e-5 * dref.abs()).all())
    del dref
    print(f"  3-D SyN's last composition {shape}, |displacement| max "
          f"{float(f3.abs().max()):.3g} voxels: K6a equal to the plain sample: {exact}; "
          f"K6b max |kernel - plain| = {pos_err:.3g} (tolerance 1e-6 x {scale:.3g} x "
          f"Σ_c |g_c| + 1e-5 rel); "
          f"K6c {dvol_err:.3g} (tolerance 1e-5 abs + 1e-5 rel)")
    require(exact and pos_ok and dvol_ok, "K6 disagrees at the 3-D SyN's composition")
    ms = time_ms(lambda: sample3d_cuda(f3, *pos), 50)
    plain = time_ms(lambda: sample3d_gather(f3, *pos), 3, head_start_ms=300.0)
    lib = time_ms(lambda: F.grid_sample(f3, grid, mode="bilinear", padding_mode="zeros",
                                        align_corners=True), 50)
    rows.append(kernel_row("warp3d_syn3d", "warp3d.cu", "tpureg/ops/warp3d_pallas.py:210",
                           "warp3d", "syn3d", 0.0, ms, plain, warp3d_work(f3, p),
                           torch.float32, lib))
    ms = time_ms(lambda: sample3d_dpos_cuda(cot, f3, *pos), 50)
    plain = time_ms(lambda: sample3d_dpos_reference(cot, f3, *pos), 3, head_start_ms=300.0)
    lib = dpos_yardstick("3-D SyN's composition", cot, f3, pos, grid, 50)
    rows.append(kernel_row("warp3d_dpos_syn3d", "warp3d.cu",
                           "tpureg/ops/warp3d_pallas.py:210", "warp3d_dpos", "syn3d",
                           pos_err, ms, plain, warp3d_dpos_work(f3, p), torch.float32, lib))
    dimg_lib, _ = torch.ops.aten.grid_sampler_3d_backward(
        cot.reshape(shape), f3, grid, 0, 0, True, [True, False])
    print(f"  grid_sampler_3d_backward d/dinput agrees with K6c to "
          f"{float((dimg_lib - dvol).abs().max()):.3g}")
    del dimg_lib, dvol
    ms = time_ms(lambda: sample3d_dvol_cuda(cot, *pos, shape), 50)
    plain = time_ms(lambda: sample3d_dvol_reference(cot, *pos, shape), 3,
                    head_start_ms=300.0)
    lib = time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
        cot.reshape(shape), f3, grid, 0, 0, True, [True, False]), 50)
    rows.append(kernel_row("warp3d_dvol_syn3d", "warp3d.cu",
                           "tpureg/ops/warp3d_pallas.py:456", "warp3d_dvol", "syn3d",
                           dvol_err, ms, plain, warp3d_dvol_work(shape, p, torch.float32),
                           torch.float32, lib))
    del f3, pos, grid, cot
    torch.cuda.empty_cache()
    return rows


def _kernel_group(name):
    groups = (("corr_fwd_kernel", "K1 correlation"),
              ("corr_bwd_kernel", "K2 correlation backward"),
              ("warp2d_fwd_kernel", "K3 warp"),
              ("warp2d_dpos_kernel", "K4 warp positions' cotangent"),
              ("warp2d_dimg_kernel", "K5 warp image cotangent"),
              ("warp3d_fwd_kernel", "K6a 3-D warp"),
              ("warp3d_dpos_kernel", "K6b 3-D warp positions' cotangent"),
              ("warp3d_dvol_kernel", "K6c 3-D warp volume cotangent"))
    for key, group in groups:
        if key in name:
            return group
    low = name.lower()
    if "multi_tensor_apply" in low or "adam" in low:
        return "Adam (multi-tensor kernels)"
    if any(t in low for t in ("dgrad", "wgrad", "bprop", "bwd_filter", "bwd_data")):
        return "cuDNN dgrad, wgrad (backward; deconv forward)"
    if any(t in low for t in ("conv", "cudnn", "xmma", "gemm", "fprop", "fft",
                              "dse::", "nchwtonhwc", "nhwctonchw",
                              "tensortransform", "cutlass")):
        return "cuDNN forward, other products, layout transforms"
    if "batch_norm" in low:
        return "BatchNorm (forward and backward)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "backward" in low:
        return "other backward (elementwise, resize)"
    return "other (elementwise, resize, reductions)"


def breakdown(label, steps, args):
    """Device time of one step of each of ``steps`` by kernel group, and
    the device's idle share of the profiled step."""
    from torch.profiler import ProfilerActivity, profile

    for name, step in steps.items():
        step(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        groups, per_kernel, launches = {}, {}, 0
        for evt in prof.events():
            # (a user annotation, such as Optimizer.step#Adam.step, spans
            # kernels that are counted on their own)
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or evt.is_user_annotation):
                continue
            ms = evt.device_time_total / 1e3
            launches += 1
            groups[_kernel_group(evt.name)] = groups.get(_kernel_group(evt.name), 0) + ms
            per_kernel[evt.name] = per_kernel.get(evt.name, 0) + ms
        busy = sum(groups.values())
        if not launches:
            print(f"  {label} {name}: the profiler recorded no device time "
                  "(not measured)")
            continue
        print(f"  {label} {name}: {launches} device kernels, busy {busy:.3f} ms of "
              f"a {wall:.3f} ms profiled step ({100 * (1 - busy / wall):.1f}% idle)")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {g:48s} {ms:8.3f} ms  {100 * ms / busy:5.1f}%")
        for k, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
            print(f"      {ms:8.3f} ms  {k[:100]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA card found")
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(sys.argv[2])
        return
    t_start = time.time()
    marks = []

    def mark(label):
        marks.append((label, time.time()))
        print(f"  [{label} done at {marks[-1][1] - t_start:.1f} s]", flush=True)

    smi = card()
    build()
    mark("build")
    errs = {"corr": check_correlation(), "corr_bwd": check_correlation_bwd(),
            "warp": check_warp(), **check_warp_grads(), "warp3d": check_warp3d(),
            "pwc": check_pwc_warps()}
    check_any_batch()
    mark("kernel checks")

    model = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    model.to(DEV)
    print(f"\nFlowNet2 registration head: {n_params / 1e6:.2f} M parameters, "
          f"seeded random weights")
    eval_launches, eval_steps, imgs, segs, flow = main_path(model)
    mark("eval path")
    pairs = tempfile.TemporaryDirectory()
    pair_dirs = phantom_pair_dirs(pairs.name)
    run_cli(model, pair_dirs, pairs.name)
    mark("inference CLI")
    train_launches, train_steps, train_imgs = train_path()
    mark("train path")
    train_vols = tempfile.TemporaryDirectory()
    train_dirs = training_volume_dirs(train_vols.name)
    run_train_cli(train_dirs)
    mark("training CLI")
    affine_launches, affine_step, vols = affine_path()
    mark("3-D affine path")
    deform_launches, deform_step, vflow, velocity = deform_path(vols)
    mark("3-D deform path")
    run_3d_cli()
    mark("3-D CLI")
    syn_launches, syn_args, syn_flow = syn_path()
    mark("2-D SyN")
    run_ants_cli(pair_dirs)
    mark("comparator CLI")
    syn3d_launches, syn3d_args, syn3d_flow = syn3d_path()
    mark("3-D SyN")
    pwc_launches, pwc_steps, pwc_imgs, pwc_segs = pwc_path(pair_dirs, train_dirs)
    mark("PWC family")
    raft_launches, raft_steps, raft_imgs, raft_segs = raft_path(pair_dirs, train_dirs)
    mark("RAFT")
    fns_launches, fns_steps, fns_imgs, fns_segs = flownets_path(pair_dirs, train_dirs)
    mark("FlowNetS and the 2-D zoo")
    remat_path()
    pretrained_and_native_paths(pair_dirs, train_dirs)
    trace_path(eval_steps["fp32"], imgs, segs)
    pairs.cleanup()
    mark("A.6: remat, --pretrained, the native decoder, TensorBoard, trace")
    export_path(model)
    mark("A.8: the serving export")
    dp_path(train_dirs)
    train_vols.cleanup()
    mark("A.7a-b: data parallel and --fsdp")
    vol_steps = {"affine": affine_step, "deform": deform_step}
    kernels = timings(eval_steps, imgs, segs, flow, errs, train_steps, train_imgs,
                      vol_steps, vols, vflow, velocity)
    syn_rows = syn_timings(syn_flow, syn3d_flow)
    print_rows(syn_rows)
    kernels += syn_rows
    pwc_rows = pwc_timings(errs["pwc"])
    print_rows(pwc_rows)
    kernels += pwc_rows
    for name, step in pwc_steps["eval"].items():
        step_times(f"pwc-reg eval step {name}, batch {BATCH} at 256² with segs",
                   lambda: step(pwc_imgs, pwc_segs)[1])
    for name, step in pwc_steps["train"].items():
        step_times(f"pwc-reg train step {name}, batch {BATCH} at 256²",
                   lambda: step(pwc_imgs))
    raft_rows = raft_timings()
    print_rows(raft_rows)
    kernels += raft_rows
    for name, step in raft_steps["eval"].items():
        step_times(f"raft-reg eval step {name}, batch {BATCH} at 256² with segs",
                   lambda: step(raft_imgs, raft_segs)[1])
    for name, step in raft_steps["train"].items():
        step_times(f"raft-reg train step {name}, batch {BATCH} at 256²",
                   lambda: step(raft_imgs))
    for name, step in fns_steps["eval"].items():
        step_times(f"flownets eval step {name}, batch {BATCH} at 256² with segs",
                   lambda: step(fns_imgs, fns_segs)[1])
    for name, step in fns_steps["train"].items():
        step_times(f"flownets train step {name}, batch {BATCH} at 256²",
                   lambda: step(fns_imgs))
    syn_calls = {"register_syn": lambda f, m, k: register_syn(f, m, k, (10, 0, 0))}
    syn3d_calls = {"register_syn3d": lambda f, m: register_syn3d(f, m)}
    step_times("register_syn at 256², (10, 0, 0)",
               lambda: {"loss": syn_calls["register_syn"](*syn_args)[1].sum()},
               warmup=1, per=1)
    step_times("register_syn3d at 176 x 256 x 256, (30, 20, 10)",
               lambda: {"loss": syn3d_calls["register_syn3d"](*syn3d_args)[1].sum()},
               reps=3, warmup=1, per=1)
    step_medians_beside_ctypes()
    mark("timings")
    phase("10. where the steps' time goes (torch.profiler, one step each)")
    breakdown("eval step", eval_steps, (imgs, segs))
    breakdown("train step", train_steps, (train_imgs,))
    breakdown("3-D train step", vol_steps, (vols,))
    breakdown("pwc-reg eval step", pwc_steps["eval"], (pwc_imgs, pwc_segs))
    breakdown("pwc-reg train step", pwc_steps["train"], (pwc_imgs,))
    breakdown("raft-reg eval step", raft_steps["eval"], (raft_imgs, raft_segs))
    breakdown("raft-reg train step", raft_steps["train"], (raft_imgs,))
    breakdown("flownets eval step", fns_steps["eval"], (fns_imgs, fns_segs))
    breakdown("flownets train step", fns_steps["train"], (fns_imgs,))
    breakdown("registration", syn_calls, syn_args)
    breakdown("registration", syn3d_calls, syn3d_args)
    mark("breakdown")
    launches = {"eval": eval_launches, "train": train_launches,
                "affine": {"fp32": affine_launches}, "deform": {"fp32": deform_launches},
                "syn": {"fp32": syn_launches}, "syn3d": {"fp32": syn3d_launches},
                "pwc_eval": pwc_launches["eval"], "pwc_train": pwc_launches["train"],
                "raft_eval": raft_launches["eval"], "raft_train": raft_launches["train"],
                "flownets_eval": fns_launches["eval"],
                "flownets_train": fns_launches["train"]}
    for row in kernels:
        dtype = "bf16" if row["name"].endswith("_bf16") else "fp32"
        row["launches"] = launches[row.pop("_path")][dtype][row.pop("_counter")]
    print(f"\nall phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
