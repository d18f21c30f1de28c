"""Layer-ordered weight ingestion from caffe dumps into the port's modules,
the counterpart of ``tpureg/compat/caffe_import.py``.

The reference's caffe parsers (flownet2/utils/param_utils.py:5-254) copy
weights from a caffe blob container into each subnet by layer order, not by
name, flipping the first convolution's BGR channels. tpureg assigns a
sequence of (weight, bias) numpy pairs to the convolution and
deconvolution kernels of a flax tree in its traversal order; the tree has
passed through ``jax.tree.map``, which sorts every dict's keys, so that
order is the sorted order of the kernels' flax paths, not the modules'
definition order. This module assigns as tpureg does: it walks the
module's convolution and deconvolution weights in the sorted order of
their flax paths (the weight bridge's ``_translate``), so that both
packages put each caffe layer into the same layer. Where that order and
the caffe order part (FlowNetC: ``conv3_1`` where the caffe order has
``conv_redir``), both load a layer into another, or stop at a shape that
does not fit.

Caffe's (O, I, kh, kw) is a convolution's torch layout already; a
deconvolution gets what tpureg's transpose to HWIO becomes through the
bridge (``_invert``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .from_jax import _invert, _translate

__all__ = ["assign_layer_ordered", "bgr_to_rgb_first_conv", "conv_walk"]


def bgr_to_rgb_first_conv(weight: np.ndarray) -> np.ndarray:
    """Flip a (O, 3, kh, kw) caffe BGR stem conv to RGB channel order
    (param_utils.py first-conv channel flip)."""
    return weight[:, ::-1].copy()


def conv_walk(model) -> List[Tuple[str, str]]:
    """(torch key, kind) of every convolution ('conv') and deconvolution
    ('deconv') weight of ``model``, in tpureg's traversal order: the sorted
    order of their flax paths."""
    walk = []
    for key, _ in model.named_parameters():
        tr = _translate(key)
        if tr is not None and tr[1] == "kernel":
            walk.append((tuple(tr[0]), key, tr[2]))
    return [(key, kind) for _, key, kind in sorted(walk)]


def assign_layer_ordered(
    model,
    layers: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
    flip_first_bgr: bool = False,
) -> Tuple[object, List[str]]:
    """Assign (weight, bias) pairs in caffe layout to ``model``'s
    convolution and deconvolution weights in ``conv_walk`` order, in place;
    a bias goes to the layer's bias where it has one. Stops at whichever
    runs out first, or at the first weight whose shape does not fit.
    Returns (model, report lines)."""
    params = dict(model.named_parameters())
    report = []
    with torch.no_grad():
        for i, ((key, kind), (weight, bias)) in enumerate(
                zip(conv_walk(model), layers)):
            weight = np.asarray(weight)
            if i == 0 and flip_first_bgr:
                weight = bgr_to_rgb_first_conv(weight)
            value = _invert(weight.transpose(2, 3, 1, 0), kind, "kernel")
            target = params[key]
            if tuple(value.shape) != tuple(target.shape):
                report.append(f"stop at layer {i} ({key}): "
                              f"{tuple(value.shape)} != {tuple(target.shape)}")
                break
            target.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            bias_key = key.rsplit(".", 1)[0] + ".bias"
            if bias is not None and bias_key in params:
                params[bias_key].copy_(torch.from_numpy(np.asarray(bias)))
            report.append(f"layer {i} -> {key} {tuple(value.shape)}")
    return model, report
