"""Evaluation step: model forward + multi-scale loss. Counterpart of
``default_loss_kwargs``, ``loss_from_outputs`` and ``make_eval_step`` in
``tpureg/train/steps.py``; the training step comes with the training slice.

The loss is always evaluated in fp32. With ``compute_dtype=torch.bfloat16``
the model's parameters and the images are cast to bf16, while BatchNorm keeps
its running statistics in fp32 and normalises in fp32 before returning the
activation dtype, as tpureg's bf16 step does (``_cast_floats`` and
nn/layers.py:219-234 there). The fp32 step turns TF32 off for convolutions
and matrix products, which would otherwise keep about three decimal digits.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..losses import OFEloss
from ..reg.head import outputs_to_nhwc

__all__ = ["default_loss_kwargs", "loss_from_outputs", "cast_floats",
           "make_eval_step", "set_fp32_numerics"]


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


def cast_floats(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``model``'s parameters to ``dtype`` in place. BatchNorm keeps its
    running statistics and its scale and shift in fp32, the latter rounded
    through ``dtype``, so that it normalises in fp32 with the cast values."""
    for m in model.modules():
        bn = isinstance(m, nn.modules.batchnorm._BatchNorm)
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype).float() if bn else p.data.to(dtype)
    return model


def set_fp32_numerics() -> None:
    """Full fp32 for cuDNN convolutions and cuBLAS products (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_eval_step(model, loss_kwargs: Optional[dict] = None,
                   compute_dtype: Optional[torch.dtype] = None):
    """``eval_step(imgs, segs=None) -> (outputs, metrics)`` for an
    ``OpticalFlowReg``.

    ``imgs``/``segs`` are [B, H, W, 2] on the model's device; ``outputs`` are
    the head's outputs in tpureg's channels-last layout and ``metrics`` holds
    0-d fp32 tensors ``loss``, ``photo_loss``, ``corr_loss``,
    ``smooth_loss``. The model is put in eval mode; under ``compute_dtype``
    the step runs a cast copy and leaves ``model``'s parameters alone.
    """
    loss_kwargs = loss_kwargs or {}
    if compute_dtype is None:
        set_fp32_numerics()
        net = model
    else:
        net = cast_floats(copy.deepcopy(model), compute_dtype)
    net.eval()

    @torch.inference_mode()
    def eval_step(imgs, segs=None):
        imgs_n = imgs.permute(0, 3, 1, 2)
        segs_n = None if segs is None else segs.permute(0, 3, 1, 2)
        imgs_c = imgs_n if compute_dtype is None else imgs_n.to(compute_dtype)
        outputs = net.register(imgs_c, segs_n)
        p, c, s, total = loss_from_outputs(outputs, imgs_n, loss_kwargs)
        metrics = {"loss": total, "photo_loss": p, "corr_loss": c,
                   "smooth_loss": s}
        return outputs_to_nhwc(outputs), metrics

    return eval_step
