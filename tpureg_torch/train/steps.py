"""Train and eval steps: model forward + multi-scale loss [+ Adam update].
Counterpart of ``default_loss_kwargs``, ``loss_from_outputs``,
``make_train_step`` and ``make_eval_step`` in ``tpureg/train/steps.py``.

The loss is always evaluated in fp32. With ``compute_dtype=torch.bfloat16``
the model's parameters and the images are cast to bf16 on every call and the
step runs through ``torch.func.functional_call``, so gradients reach the
fp32 master weights through the cast; BatchNorm keeps its running statistics
and its scale and shift in fp32 and normalises in fp32 before returning the
activation dtype, as tpureg's bf16 step does (``_cast_floats`` and
nn/layers.py:219-242 there). This is not ``torch.autocast``, which would
keep other ops in fp32 than tpureg does. The fp32 steps turn TF32 off for
convolutions and matrix products, which would otherwise keep about three
decimal digits.

Each call sets the model's mode: the train step puts it in train mode
(batch statistics, running-stat updates), the eval step in eval mode.

``make_train_step(remat=...)`` recomputes the head's forward inside the
backward (``torch.utils.checkpoint``, non-reentrant), tpureg's
``jax.checkpoint`` over ``apply_fn``: ``"full"`` keeps nothing of the
forward, ``"dots"`` keeps the outputs of the convolutions and matrix
products (tpureg's ``checkpoint_dots``) and recomputes the rest. The casts
of the bf16 step stay outside the recomputed region. The hand-written
kernels are ``torch.library`` ops, which the "dots" policy recomputes as
it does every op but the products: K1 and K3 launch once more in the
backward for each launch in the forward, since the last tensor the forward
saves is the grid warp's.
BatchNorm's recomputed forward would update its running statistics a
second time; the step puts back the statistics of the first forward.

``make_train_step(group=...)`` and ``make_eval_step(group=...)`` are the
data-parallel steps: one process a card, each passing its rows of the
global batch (``parallel.local_rows``: its part of every microbatch, in
tpureg's microbatch order), and the result is the global batch's, as
tpureg's step over a batch sharded on ``'data'`` is one program over the
global batch. The rank's loss is its share of the global loss
(``OFEloss(group=)``: its photometric and smoothness sums over the global
B, 1/W of the global Pearson); BatchNorm normalises by the global batch's
statistics through a differentiable all-reduce (its ``process_group``, set
for the step's duration); the parameter gradients are summed over the
ranks, so their sum is the gradient of tpureg's loss; the metrics are
all-reduced, so every rank returns the global values. Every rank issues
the same collectives in the same order, in the forward, the backward and a
``remat`` recompute. With ``replicated=True`` every rank passes the whole
batch instead (the training CLI's ``--fsdp`` where the batch does not split
over the ranks): everything is computed as in one process and the
gradients and metrics are averaged over the ranks. Under FSDP
(``TrainState.shards``) the steps gather the full parameters for their
duration and Adam updates each rank's slices. Without a group nothing
crosses processes and every result is the single-process step's.

``make_flow_supervised_step`` is the synthetic-flow pretraining step
(tpureg steps.py:214-343): mean endpoint error of every flow the head
returns against ``stn_inverse_target`` of the displacement that synthesised
the pair, with the same casts as the train step.

``make_deform3d_train_step`` and ``make_affine_train_step`` are the
volumetric steps (tpureg steps.py:345-409): VoxelMorph3D with ``DEFloss3D``
and AffineNet3D with ``Affloss`` on [B, D, H, W, 2] volumes, in fp32 with
TF32 off, one Adam update each.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..losses import Affloss, DEFloss3D, OFEloss
from ..nn import BatchNorm2d
from ..ops.warp import base_grid
from ..parallel.mesh import rank_and_world

__all__ = ["default_loss_kwargs", "loss_from_outputs", "cast_params",
           "make_train_step", "make_eval_step", "set_fp32_numerics",
           "stn_inverse_target", "make_flow_supervised_step",
           "make_deform3d_train_step", "make_affine_train_step"]

_TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")


def default_loss_kwargs(model_name: str) -> Optional[dict]:
    """Per-family loss conventions: the PWC family restricts the loss to its
    finest 2 flows; every other family keeps the reference's semantics."""
    if "pwc" in model_name.lower():
        return {"num_scales": 2}
    return None


def loss_from_outputs(outputs, imgs, loss_kwargs, group=None):
    """OFE loss of NCHW head ``outputs`` against the fixed channel of NCHW
    ``imgs``; ``num_scales`` keeps only the finest k flows; ``group``: the
    data-parallel group whose global batch the loss is (``OFEloss``)."""
    flows, warped_imgs = outputs[0], outputs[1]
    loss_kwargs = dict(loss_kwargs or {})
    num_scales = loss_kwargs.pop("num_scales", None)
    if num_scales is not None:
        flows = flows[:num_scales]
        warped_imgs = warped_imgs[:num_scales]
    flows = [f.float() for f in flows]
    warped_imgs = [w.float() for w in warped_imgs]
    fixed = imgs[:, 0:1].float()
    return OFEloss(flows, warped_imgs, fixed, group=group, **loss_kwargs)


def cast_params(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``model``'s current parameters cast to ``dtype``, by name, for
    ``torch.func.functional_call``; the casts stay on autograd's tape.
    BatchNorm's scale and shift are rounded through ``dtype`` and kept fp32,
    so that it normalises in fp32 with the cast values."""
    out = {}
    for prefix, m in model.named_modules():
        bn = isinstance(m, nn.modules.batchnorm._BatchNorm)
        for name, p in m.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            out[key] = p.to(dtype).float() if bn else p.to(dtype)
    return out


def set_fp32_numerics() -> None:
    """Full fp32 for cuDNN convolutions and cuBLAS products (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _nchw(t):
    return None if t is None else t.permute(0, 3, 1, 2)


# the products whose outputs ``remat="dots"`` keeps: jax's checkpoint_dots
# saves dot_general and convolution outputs
_DOTS = frozenset((torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.addmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXTS = {
    "full": {},
    "dots": {"context_fn": partial(create_selective_checkpoint_contexts,
                                   _dots_policy)},
}


def _forward(model, imgs, segs, compute_dtype, remat=None):
    """The head on channels-last ``imgs``/``segs`` with the current weights,
    cast to ``compute_dtype`` when it is given; channels-last outputs. Under
    ``remat`` the head's forward (not the casts) is checkpointed."""
    if compute_dtype is None:
        apply = lambda x: model(x, segs)
    else:
        params = cast_params(model, compute_dtype)
        imgs = imgs.to(compute_dtype)
        apply = lambda x: torch.func.functional_call(model, params, (x, segs))
    if remat is None:
        return apply(imgs)
    return checkpoint(apply, imgs, use_reentrant=False, **_REMAT_CONTEXTS[remat])


def _batchnorm_stats(model):
    """Clones of every BatchNorm buffer (running statistics and count)."""
    return [(b, b.clone()) for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]


def _loss_terms(model, imgs, segs, loss_kwargs, compute_dtype, remat=None,
                group=None):
    outputs = _forward(model, imgs, segs, compute_dtype, remat)
    flows, warped = outputs[0], outputs[1]
    p, c, s, total = loss_from_outputs(
        (tuple(_nchw(f) for f in flows), tuple(_nchw(w) for w in warped)),
        _nchw(imgs), loss_kwargs, group)
    return outputs, dict(zip(_TERMS, (total, p, c, s)))


class _DataParallel:
    """What a step does across the ranks of ``group``: None for one
    process; ``replicated`` when every rank holds the whole batch."""

    def __init__(self, group, replicated: bool, shards=None):
        if shards is not None and group is None:
            group = shards.group
        self.group, self.replicated, self.shards = group, replicated, shards
        self.world = 1 if group is None else rank_and_world(group)[1]
        # the group the loss and BatchNorm reduce over
        self.batch_group = None if replicated else group

    def gathered(self):
        return (contextlib.nullcontext() if self.shards is None
                else self.shards.gathered())

    @contextlib.contextmanager
    def global_batchnorm(self, model):
        """``model``'s BatchNorm over the global batch for the duration."""
        bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
        for m in bns:
            m.process_group = self.batch_group
        try:
            yield
        finally:
            for m in bns:
                m.process_group = None

    def _reduce(self, tensors):
        """Sum (average when replicated) ``tensors`` over the ranks, in one
        all-reduce of their concatenation."""
        if self.group is None:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        if self.replicated:
            flat.div_(self.world)
        return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]),
                                             tensors)]

    def metrics(self, terms):
        return self._reduce([terms])[0]

    def gradients(self, params, grads):
        grads = self._reduce(grads)
        if self.shards is not None:
            grads = [self.shards.shard_grad(p, g) for p, g in zip(params, grads)]
        return grads


def make_eval_step(model, loss_kwargs: Optional[dict] = None,
                   compute_dtype: Optional[torch.dtype] = None, group=None,
                   replicated: bool = False, shards=None):
    """``eval_step(imgs, segs=None) -> (outputs, metrics)`` for an
    ``OpticalFlowReg``.

    ``imgs``/``segs`` are [B, H, W, 2] on the model's device; ``outputs`` are
    the head's outputs in tpureg's channels-last layout and ``metrics`` holds
    0-d fp32 tensors ``loss``, ``photo_loss``, ``corr_loss``,
    ``smooth_loss``. Each call puts the model in eval mode and, under
    ``compute_dtype``, casts the model's current parameters.

    ``group``, ``replicated``: data parallelism (the module docstring): the
    outputs are the rank's rows, the metrics the global batch's, equal on
    every rank, so a best-weight decision is the same everywhere.
    ``shards``: the train state's FSDP layout, gathered for each call.
    """
    loss_kwargs = loss_kwargs or {}
    if compute_dtype is None:
        set_fp32_numerics()
    dp = _DataParallel(group, replicated, shards)

    @torch.inference_mode()
    def step(imgs, segs):
        model.eval()
        outputs, metrics = _loss_terms(model, imgs, segs, loss_kwargs,
                                       compute_dtype, group=dp.batch_group)
        if dp.group is not None:
            terms = dp.metrics(torch.stack([metrics[k] for k in _TERMS]))
            metrics = {k: terms[i] for i, k in enumerate(_TERMS)}
        return outputs, metrics

    def eval_step(imgs, segs=None):
        # the gather stays outside inference mode: the slices kept on exit
        # are the parameters Adam updates in place
        with dp.gathered():
            return step(imgs, segs)

    return eval_step


def make_train_step(state, loss_kwargs: Optional[dict] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    remat: Optional[str] = None, accum_steps: int = 1,
                    synth: Optional[Callable] = None, group=None,
                    replicated: bool = False):
    """``train_step(imgs) -> metrics`` for a ``TrainState``
    (``train/state.py``): forward in train mode, multi-scale loss, gradients,
    one Adam update of the state's optimizer at the scheduled learning rate.

    ``imgs`` is [B, H, W, 2]; ``metrics`` holds detached 0-d fp32 tensors
    ``loss``, ``photo_loss``, ``corr_loss``, ``smooth_loss``.

    ``accum_steps > 1`` splits the batch into that many microbatches, run in
    order: each sees the BatchNorm running statistics its predecessor left,
    the update takes the mean of their gradients and the metrics are
    microbatch means, as tpureg's ``lax.scan`` form does.

    ``synth``: when given, the step's argument is a spec tuple (e.g.
    ``SliceDataset.batch_specs()``'s) and ``imgs = synth(*spec)``.

    ``remat``: ``None``, ``"full"`` or ``"dots"`` (the module docstring);
    the metrics, the update and the running statistics are the base step's.

    ``group``: None, or the process group of data parallelism (the module
    docstring): each rank passes its rows of the global batch (with
    ``synth``, the spec of its rows) and the step takes the global batch's
    update; ``replicated=True``: each rank passes the whole batch. A sharded
    state (``state.shards``) implies its group.
    """
    loss_kwargs = loss_kwargs or {}
    if remat not in (None, "full", "dots"):
        raise ValueError(f"remat must be None|'full'|'dots', got {remat!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if compute_dtype is None:
        set_fp32_numerics()
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]
    dp = _DataParallel(group, replicated, state.shards)

    def train_step(imgs):
        if synth is not None:
            imgs = synth(*imgs)
        b = imgs.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        model.train()
        grads, sums = None, None
        with dp.gathered(), dp.global_batchnorm(model):
            for mb in imgs.reshape(accum_steps, b // accum_steps, *imgs.shape[1:]):
                with torch.enable_grad():
                    _, metrics = _loss_terms(model, mb, None, loss_kwargs,
                                             compute_dtype, remat, dp.batch_group)
                    stats = _batchnorm_stats(model) if remat else ()
                    # a parameter the forward never reads (PWC's deconv0)
                    # gets a zero gradient, as tpureg's does
                    g = torch.autograd.grad(metrics["loss"], params,
                                            materialize_grads=True)
                for buf, first in stats:  # undo the recomputed forward's update
                    buf.copy_(first)
                terms = torch.stack([metrics[k].detach() for k in _TERMS])
                if grads is None:
                    grads, sums = list(g), terms
                else:
                    for acc, gi in zip(grads, g):
                        acc.add_(gi)
                    sums = sums + terms
            grads = dp.gradients(params, grads)
        for p, g in zip(params, grads):
            p.grad = g if accum_steps == 1 else g.div_(accum_steps)
        state.apply_gradients()
        means = dp.metrics(sums) / accum_steps
        return {k: means[i] for i, k in enumerate(_TERMS)}

    return train_step


def _resize_antialiased(x, h: int, w: int):
    """``jax.image.resize(x, ..., "bilinear")`` of NCHW ``x``: a triangle
    filter widened by the factor where it shrinks (``antialias=True``, JAX's
    default), each output's weights over the in-image inputs summing to 1;
    the input itself at its own size."""
    if tuple(x.shape[2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def stn_inverse_target(disp, h: int, w: int, h_full: int):
    """The flow [B, h, w, 2] that the head's "stn" warp needs to undo
    ``disp`` [B, H, W, 2], the full-resolution pixel displacement that
    synthesised ``moving(x) = fixed(x + d(x))``. The warp samples at
    ``(x + flow)·(s-1)/s``, so ``flow = -d·s/(s-1) + x/(s-1)`` per axis,
    with ``d`` resized to (h, w) (antialiased, as tpureg's) and scaled to
    pixels of that size (w/W for x, h/H for y). At a 1-wide scale the warp
    ignores the flow, and the target is ``-d``."""
    w_full = disp.shape[2]
    d = _resize_antialiased(disp.permute(0, 3, 1, 2), h, w)
    dx = d[:, 0] * (w / w_full)
    dy = d[:, 1] * (h / h_full)
    g = base_grid(h, w, disp.device, dx.dtype)
    wd, hd = max(w - 1, 1), max(h - 1, 1)
    tx = -dx * (w / wd) + (g[..., 0] / wd if w > 1 else 0.0)
    ty = -dy * (h / hd) + (g[..., 1] / hd if h > 1 else 0.0)
    return torch.stack([tx, ty], dim=-1)


def make_flow_supervised_step(state, compute_dtype: Optional[torch.dtype] = None,
                              flow_units: str = "resolution"):
    """``step(imgs, disp) -> metrics`` for a ``TrainState`` around an
    ``OpticalFlowReg``: supervised synthetic-flow pretraining (tpureg's
    ``make_flow_supervised_step``, the stand-in for the reference's
    FlyingChairs weights). ``imgs`` [B, H, W, 2] is a pair whose moving
    channel was synthesised from the fixed one by the pixel displacement
    ``disp`` [B, H, W, 2]. The loss is the mean over the head's flows of
    each one's mean endpoint error (with 1e-12 under the root) against its
    target; one Adam update. ``metrics``: ``epe`` (the loss) and ``epe0``
    (the finest flow's), detached 0-d fp32 tensors.

    ``flow_units``: ``"resolution"`` (every flow's target is
    ``stn_inverse_target`` at its size) or ``"pwc20"`` (flows at ¼ of the
    input's height or less take ``-d / 20`` resized, PWC's native units,
    their error counted ×20; the finer ones the stn inverse). Casts and
    numerics as ``make_train_step``'s."""
    if flow_units not in ("resolution", "pwc20"):
        raise ValueError(f"flow_units must be 'resolution' or 'pwc20', got "
                         f"{flow_units!r}")
    if compute_dtype is None:
        set_fp32_numerics()
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]

    def step(imgs, disp):
        model.train()
        h_full = imgs.shape[1]
        with torch.enable_grad():
            flows = _forward(model, imgs, None, compute_dtype)[0]
            epe, epe0 = 0.0, None
            for f in flows:
                f = f.float()
                h, w = f.shape[1], f.shape[2]
                if flow_units == "pwc20" and h * 4 <= h_full:
                    unit = 20.0
                    gt = _resize_antialiased(-disp.permute(0, 3, 1, 2), h, w)
                    gt = gt.permute(0, 2, 3, 1) * (1.0 / 20.0)
                else:
                    unit = 1.0
                    gt = stn_inverse_target(disp, h, w, h_full)
                term = torch.sqrt(((f - gt) ** 2).sum(-1) + 1e-12).mean()
                epe0 = term if epe0 is None else epe0
                epe = epe + unit * term
            epe = epe / len(flows)
            grads = torch.autograd.grad(epe, params, materialize_grads=True)
        for p, g in zip(params, grads):
            p.grad = g
        state.apply_gradients()
        return {"epe": epe.detach(), "epe0": epe0.detach()}

    return step


def _volume_train_step(state, terms_of):
    """``train_step(vols) -> metrics``: ``terms_of(model, x)`` gives the
    metrics of NCDHW ``x`` [B, 2, D, H, W], the total under ``"loss"``; one
    gradient of it and one Adam update."""
    set_fp32_numerics()
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(vols):
        model.train()
        x = vols.permute(0, 4, 1, 2, 3).contiguous()
        with torch.enable_grad():
            metrics = terms_of(model, x)
            grads = torch.autograd.grad(metrics["loss"], params)
        for p, g in zip(params, grads):
            p.grad = g
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_deform3d_train_step(state, loss_kwargs: Optional[dict] = None):
    """``train_step(vols) -> metrics`` for a ``TrainState`` around a
    ``VoxelMorph3D``: ``vols`` [B, D, H, W, 2] (fixed, moving); ``DEFloss3D``
    of the warped moving volume against the fixed one and of the flow;
    metrics ``loss``, ``photo_loss``, ``corr_loss``, ``smooth_loss`` (0-d
    fp32 tensors, detached)."""
    loss_kwargs = loss_kwargs or {}

    def terms(model, x):
        flow, warped, _ = model(x)
        p, c, s, total = DEFloss3D(flow, warped, x[:, 0:1], **loss_kwargs)
        return {"loss": total, "photo_loss": p, "corr_loss": c, "smooth_loss": s}

    return _volume_train_step(state, terms)


def make_affine_train_step(state, loss_kwargs: Optional[dict] = None):
    """``train_step(vols) -> metrics`` for a ``TrainState`` around an
    ``AffineNet3D``: ``Affloss`` of the affinely warped moving volume
    against the fixed one; metrics ``loss``, ``photo_loss``, ``corr_loss``."""
    loss_kwargs = loss_kwargs or {}

    def terms(model, x):
        _, warped = model(x)
        p, c, total = Affloss(warped, x[:, 0:1], **loss_kwargs)
        return {"loss": total, "photo_loss": p, "corr_loss": c}

    return _volume_train_step(state, terms)
