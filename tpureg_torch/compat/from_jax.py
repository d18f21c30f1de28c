"""Weight bridge from tpureg's flax trees to the port's state dicts.

The port's modules carry the reference networks' torch key names
(``conv1.0.weight``, ``predict_flow6.weight``, ``upsampled_flow6_to_5.bias``,
``conv1.1.running_mean``, ...), so a tpureg ``{"params", "batch_stats"}``
pair maps onto them exactly as tpureg's own torch export maps it
(``tpureg/compat/torch_export.py``). This module is the port's copy of that
mapping: ``_translate`` (torch key → flax path, kind) and ``_invert`` (flax
layout → torch layout) are copied from ``tpureg/compat/torch_import.py:72-130``
(FlowNet- and PWC-family keys; PWC's ``deconvN`` and ``upfeatN`` are bare
transposed convolutions, not ``Sequential`` members) and
``torch_export.py:45-56``. The trees come in as nested dicts of numpy
arrays, so nothing here needs JAX.

Layouts: conv kernels HWIO → OIHW; transposed-conv kernels, stored by
tpureg in the equivalent-convolution layout (kh, kw, in, out), go back to
torch's (in, out, kh, kw) with the spatial flip undone; BatchNorm
scale/bias/mean/var → weight/bias/running_mean/running_var, plus a zero
``num_batches_tracked``, so that a strict ``load_state_dict`` succeeds.

``state_dict_from_jax_3d`` carries the 3-D models' trees
(``VoxelMorph3D``, ``AffineNet3D``), whose port modules are named as the
flax modules are (``enc0/conv/kernel`` → ``enc0.conv.weight``,
``flow_head/bias`` → ``flow_head.bias``, ``conv3/kernel`` →
``conv3.weight``, ``fc/kernel`` → ``fc.weight``): Conv3D kernels go from
DHWIO to OIDHW, the dense kernel from (in, out) to (out, in).
``state_dict_from_jax_raft`` does the same for ``RAFT``, whose tree has no
``batch_stats``: convolution kernels (``fnet/res1a/conv1/kernel``,
``menc1/kernel``, ``gru/convz/kernel``, ``fh2/kernel``) go from HWIO to
OIHW, and GroupNorm's ``scale`` (``fnet/stem_norm/scale``) becomes
``weight``. The reference vendors no RAFT, so there is no torch export to
follow: the module names are flax's.

``load_adam_state_from_jax`` carries optax's Adam state (``count``, ``mu``,
``nu``; trees shaped like the parameters) into ``torch.optim.Adam``'s
(``step``, ``exp_avg``, ``exp_avg_sq``) with the same key mapping and layout
transposes, so that a training run continues from a tpureg state.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "state_dict_from_jax_3d",
           "state_dict_from_jax_raft", "load_adam_state_from_jax"]

_UPFLOW_RE = re.compile(r"upsampled_flow(\d)_to_(\d)")
_UPFLOW_FLAX_RE = re.compile(r"^upflow(\d)to(\d)$")
_BARE_DECONV_RE = re.compile(r"^(deconv\d|upfeat\d)$")
# module paths of the 3-D models' flax trees
_MODULE_3D_RE = re.compile(r"^((enc|dec|extra)\d+/conv|flow_head|conv\d+|fc)$")
# RAFT's convolutions and its GroupNorms
_CONV_RAFT_RE = re.compile(
    r"^((fnet|cnet)/(stem|head|res\d[ab]/(conv[12]|proj))|menc[12]|gru/conv[zrq]|fh[12])$")
_NORM_RAFT_RE = re.compile(r"^(fnet|cnet)/(stem_norm|res\d[ab]/norm[12])$")
_BN_TO_TORCH = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}


def _conv_leaf(leaf: str) -> str:
    return {"weight": "kernel", "bias": "bias"}.get(leaf, leaf)


def _translate(key: str) -> Optional[Tuple[List[str], str, str]]:
    """torch key → (flax path segments, leaf name, kind), kind one of
    'conv', 'deconv', 'bn_param', 'bn_stat'; None for keys with no flax
    counterpart (num_batches_tracked). The port's 2-D models have no dense
    layers, so tpureg's branch for those is not copied."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "num_batches_tracked":
        return None
    mods = [_UPFLOW_RE.sub(lambda m: f"upflow{m.group(1)}to{m.group(2)}", m)
            for m in parts[:-1]]
    last = mods[-1]
    if last == "0" and len(mods) >= 2:  # Sequential member 0 = conv/deconv
        if mods[-2].startswith("deconv"):
            return mods[:-1] + ["convt"], _conv_leaf(leaf), "deconv"
        return mods[:-1] + ["conv"], _conv_leaf(leaf), "conv"
    if last == "1" and len(mods) >= 2:  # Sequential member 1 = BatchNorm
        base = mods[:-1] + ["bn"]
        kinds = {"weight": ("scale", "bn_param"), "bias": ("bias", "bn_param"),
                 "running_mean": ("mean", "bn_stat"),
                 "running_var": ("var", "bn_stat")}
        if leaf not in kinds:
            return None
        return base, kinds[leaf][0], kinds[leaf][1]
    if last.startswith("upflow") or _BARE_DECONV_RE.match(last):
        return mods, _conv_leaf(leaf), "deconv"
    return mods, _conv_leaf(leaf), "conv"  # bare conv (predict_flow*, ...)


def _invert(value: np.ndarray, kind: str, leaf: str) -> np.ndarray:
    if leaf != "kernel":
        return value
    if kind == "conv" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "deconv" and value.ndim == 4:
        return np.flip(value.transpose(2, 3, 0, 1), axis=(2, 3)).copy()
    return value


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict) or hasattr(node, "items"):
            yield from _leaves(node, path + (name,))
        else:
            yield path + (name,), node


def _torch_key(path: Sequence[str]) -> Optional[str]:
    """flax path (ending in the leaf) → the reference's torch key, or None."""
    *mods, leaf = path
    if not mods:
        return None
    if mods[-1] == "bn":
        if leaf not in _BN_TO_TORCH:
            return None
        return ".".join(mods[:-1] + ["1", _BN_TO_TORCH[leaf]])
    if leaf not in ("kernel", "bias"):
        return None
    torch_leaf = {"kernel": "weight", "bias": "bias"}[leaf]
    if mods[-1] in ("conv", "convt"):
        return ".".join(mods[:-1] + ["0", torch_leaf])
    mods = [_UPFLOW_FLAX_RE.sub(r"upsampled_flow\1_to_\2", m) for m in mods]
    return ".".join(mods + [torch_leaf])


def _subtree(tree, prefix):
    for p in prefix:
        tree = tree[p]
    return tree


def state_dict_from_jax(params, batch_stats=None,
                        prefix: Tuple[str, ...] = ("predictor",)
                        ) -> Dict[str, torch.Tensor]:
    """tpureg ``params``/``batch_stats`` (nested dicts of numpy arrays) →
    the port's state dict for the module under ``prefix`` (the registration
    head's predictor by default). Raises if a leaf has no torch counterpart."""
    out: Dict[str, torch.Tensor] = {}
    trees = (("params", _subtree(params, prefix)),
             ("batch_stats", _subtree(batch_stats or {}, prefix)
              if batch_stats else {}))
    for collection, tree in trees:
        for path, value in _leaves(tree):
            key = _torch_key(path)
            tr = None if key is None else _translate(key)
            if tr is None or tr[0] + [tr[1]] != list(path) \
                    or (tr[2] == "bn_stat") != (collection == "batch_stats"):
                raise ValueError(f"{collection} leaf {'/'.join(path)} has no "
                                 f"torch counterpart (tried {key!r})")
            _, leaf, kind = tr
            value = _invert(np.asarray(value, dtype=np.float32), kind, leaf)
            out[key] = torch.tensor(value)
            if collection == "batch_stats" and leaf == "mean":
                nbt = key.rsplit(".", 1)[0] + ".num_batches_tracked"
                out[nbt] = torch.zeros((), dtype=torch.int64)
    return out


def _named_state_dict(params, place, what) -> Dict[str, torch.Tensor]:
    """A flax tree whose port modules carry the flax module names:
    ``place(module path, leaf, value)`` gives the torch leaf name and value,
    or None for a leaf that has no counterpart, which raises."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        *mods, leaf = path
        placed = place("/".join(mods), leaf, np.asarray(value, dtype=np.float32))
        if placed is None:
            raise ValueError(f"params leaf {'/'.join(path)} (shape "
                             f"{np.shape(value)}) has no counterpart in {what}")
        name, value = placed
        out[".".join(mods + [name])] = torch.tensor(np.ascontiguousarray(value))
    return out


def _place_3d(module, leaf, value):
    if not _MODULE_3D_RE.match(module) or leaf not in ("kernel", "bias"):
        return None
    if leaf == "bias":
        return "bias", value
    if value.ndim == 5:
        return "weight", value.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    if value.ndim == 2 and module == "fc":
        return "weight", value.T  # (in, out) -> (out, in)
    return None


def state_dict_from_jax_3d(params) -> Dict[str, torch.Tensor]:
    """tpureg ``params`` of a ``VoxelMorph3D`` or ``AffineNet3D`` (nested
    dicts of numpy arrays) → the port's state dict. Raises on a leaf it
    cannot place: a module path the models do not have, a leaf other than a
    kernel or a bias, or a kernel that is neither a 3-D convolution's nor a
    dense layer's."""
    return _named_state_dict(params, _place_3d, "the port's 3-D models")


def _place_raft(module, leaf, value):
    if _NORM_RAFT_RE.match(module) and leaf in ("scale", "bias") and value.ndim == 1:
        return ("weight" if leaf == "scale" else "bias"), value
    if not _CONV_RAFT_RE.match(module):
        return None
    if leaf == "bias" and value.ndim == 1:
        return "bias", value
    if leaf == "kernel" and value.ndim == 4:
        return "weight", value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return None


def state_dict_from_jax_raft(params, prefix: Tuple[str, ...] = ("predictor",)
                             ) -> Dict[str, torch.Tensor]:
    """tpureg ``params`` of a ``RAFT`` under the module path ``prefix`` (the
    registration head's predictor by default; nested dicts of numpy arrays)
    → the port's state dict. Raises on a leaf it cannot place: a module path
    RAFT does not have, or a leaf that is not its module's kernel, bias or
    scale."""
    return _named_state_dict(_subtree(params, prefix), _place_raft, "the port's RAFT")


def load_adam_state_from_jax(optimizer: torch.optim.Optimizer, model, count,
                             mu, nu, prefix: Tuple[str, ...] = ("predictor",)
                             ) -> None:
    """Load optax's Adam state into ``optimizer``, a ``torch.optim.Adam``
    over ``model.parameters()`` in their order (as ``create_train_state``
    builds it). ``count`` is the update count; ``mu`` and ``nu`` are the
    moment trees (nested dicts of numpy arrays) rooted where the parameters
    are, with the model's parameters under the module path ``prefix``.
    Raises unless every parameter has both moments."""
    exp_avg = state_dict_from_jax(mu, None, prefix)
    exp_avg_sq = state_dict_from_jax(nu, None, prefix)
    head = ".".join(prefix) + "." if prefix else ""
    names = [n for n, _ in model.named_parameters()]
    keys = [n[len(head):] if n.startswith(head) else n for n in names]
    missing = [n for n, k in zip(names, keys)
               if k not in exp_avg or k not in exp_avg_sq]
    extra = sorted(set(exp_avg) - set(keys))
    if missing or extra:
        raise ValueError(f"Adam moments do not cover the model: missing "
                         f"{missing[:5]}, unmatched {extra[:5]}")
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": exp_avg[k],
                       "exp_avg_sq": exp_avg_sq[k]}
                   for i, k in enumerate(keys)}
    optimizer.load_state_dict(sd)
