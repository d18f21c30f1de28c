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

``make_deform3d_train_step`` and ``make_affine_train_step`` are the
volumetric steps (tpureg steps.py:345-409): VoxelMorph3D with ``DEFloss3D``
and AffineNet3D with ``Affloss`` on [B, D, H, W, 2] volumes, in fp32 with
TF32 off, one Adam update each.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..losses import Affloss, DEFloss3D, OFEloss

__all__ = ["default_loss_kwargs", "loss_from_outputs", "cast_params",
           "make_train_step", "make_eval_step", "set_fp32_numerics",
           "make_deform3d_train_step", "make_affine_train_step"]

_TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")


def default_loss_kwargs(model_name: str) -> Optional[dict]:
    """Per-family loss conventions: the PWC family restricts the loss to its
    finest 2 flows; every other family keeps the reference's semantics."""
    if "pwc" in model_name.lower():
        return {"num_scales": 2}
    return None


def loss_from_outputs(outputs, imgs, loss_kwargs):
    """OFE loss of NCHW head ``outputs`` against the fixed channel of NCHW
    ``imgs``; ``num_scales`` keeps only the finest k flows."""
    flows, warped_imgs = outputs[0], outputs[1]
    loss_kwargs = dict(loss_kwargs or {})
    num_scales = loss_kwargs.pop("num_scales", None)
    if num_scales is not None:
        flows = flows[:num_scales]
        warped_imgs = warped_imgs[:num_scales]
    flows = [f.float() for f in flows]
    warped_imgs = [w.float() for w in warped_imgs]
    fixed = imgs[:, 0:1].float()
    return OFEloss(flows, warped_imgs, fixed, **loss_kwargs)


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


def _forward(model, imgs, segs, compute_dtype):
    """The head on channels-last ``imgs``/``segs`` with the current weights,
    cast to ``compute_dtype`` when it is given; channels-last outputs."""
    if compute_dtype is None:
        return model(imgs, segs)
    return torch.func.functional_call(
        model, cast_params(model, compute_dtype), (imgs.to(compute_dtype), segs))


def _loss_terms(model, imgs, segs, loss_kwargs, compute_dtype):
    outputs = _forward(model, imgs, segs, compute_dtype)
    flows, warped = outputs[0], outputs[1]
    p, c, s, total = loss_from_outputs(
        (tuple(_nchw(f) for f in flows), tuple(_nchw(w) for w in warped)),
        _nchw(imgs), loss_kwargs)
    return outputs, dict(zip(_TERMS, (total, p, c, s)))


def make_eval_step(model, loss_kwargs: Optional[dict] = None,
                   compute_dtype: Optional[torch.dtype] = None):
    """``eval_step(imgs, segs=None) -> (outputs, metrics)`` for an
    ``OpticalFlowReg``.

    ``imgs``/``segs`` are [B, H, W, 2] on the model's device; ``outputs`` are
    the head's outputs in tpureg's channels-last layout and ``metrics`` holds
    0-d fp32 tensors ``loss``, ``photo_loss``, ``corr_loss``,
    ``smooth_loss``. Each call puts the model in eval mode and, under
    ``compute_dtype``, casts the model's current parameters.
    """
    loss_kwargs = loss_kwargs or {}
    if compute_dtype is None:
        set_fp32_numerics()

    @torch.inference_mode()
    def eval_step(imgs, segs=None):
        model.eval()
        outputs, metrics = _loss_terms(model, imgs, segs, loss_kwargs,
                                       compute_dtype)
        return outputs, metrics

    return eval_step


def make_train_step(state, loss_kwargs: Optional[dict] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    accum_steps: int = 1, synth: Optional[Callable] = None):
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

    (tpureg's ``remat`` is not ported; see ROADMAP.md.)
    """
    loss_kwargs = loss_kwargs or {}
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if compute_dtype is None:
        set_fp32_numerics()
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(imgs):
        if synth is not None:
            imgs = synth(*imgs)
        b = imgs.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        model.train()
        grads, sums = None, None
        for mb in imgs.reshape(accum_steps, b // accum_steps, *imgs.shape[1:]):
            with torch.enable_grad():
                _, metrics = _loss_terms(model, mb, None, loss_kwargs,
                                         compute_dtype)
                # a parameter the forward never reads (PWC's deconv0) gets
                # a zero gradient, as tpureg's does
                g = torch.autograd.grad(metrics["loss"], params,
                                        materialize_grads=True)
            terms = torch.stack([metrics[k].detach() for k in _TERMS])
            if grads is None:
                grads, sums = list(g), terms
            else:
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                sums = sums + terms
        for p, g in zip(params, grads):
            p.grad = g if accum_steps == 1 else g.div_(accum_steps)
        state.apply_gradients()
        means = sums / accum_steps
        return {k: means[i] for i, k in enumerate(_TERMS)}

    return train_step


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
