"""PyTorch checkpoint import with channel surgery, the counterpart of
``tpureg/compat/torch_import.py``.

The port's modules carry the reference's torch key names, so a reference
checkpoint loads key by key with no translation. The import is lenient as
tpureg's is (``load_state_dict(strict=False)``): a key with a tensor of the
same shape in the model loads; a key the model lacks is reported as
``missing``, one whose shape differs as ``shape_mismatch``, and neither is
fatal. The keys tpureg's ``_translate`` drops are skipped unreported, as
there: ``num_batches_tracked`` and any other leaf of a Sequential's
BatchNorm (member ``1``) than its weight, bias and running statistics.

The surgeries collapse a stem convolution's RGB input (reference
models.py:246-248, train.py:158-166): ``"rgb"`` sums 3 input channels into
1, ``"rgb_pair"`` sums each image's RGB triplet of a 6-channel pair into 2.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

__all__ = ["load_torch_checkpoint", "import_torch_state_dict",
           "collapse_rgb_input", "collapse_rgb_pair_input"]

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a flat ``{key: tensor}`` state dict on the
    CPU, unwrapping ``"state_dict"`` and then ``"model_state_dict"``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in obj.items()}


def _channel_sum(weight: torch.Tensor) -> torch.Tensor:
    """Σ over dim 1, kept, added in channel order as numpy adds along an
    axis that is not the last, so that the sum is tpureg's to the bit (and
    zeros over no channels, as there)."""
    out = weight.new_zeros((weight.shape[0], 1, *weight.shape[2:]))
    for i in range(weight.shape[1]):
        out = out + weight[:, i:i + 1]
    return out


def collapse_rgb_input(weight: torch.Tensor) -> torch.Tensor:
    """(O, 3, kh, kw) → (O, 1, kh, kw) by channel sum."""
    return _channel_sum(weight)


def collapse_rgb_pair_input(weight: torch.Tensor) -> torch.Tensor:
    """(O, 6, kh, kw) → (O, 2, kh, kw): each image's RGB triplet summed."""
    return torch.cat([_channel_sum(weight[:, :3]), _channel_sum(weight[:, 3:])],
                     dim=1)


def _dropped(key: str) -> bool:
    """Whether tpureg's ``_translate`` gives the key no target."""
    parts = key.split(".")
    leaf, mods = parts[-1], parts[:-1]
    if leaf == "num_batches_tracked":
        return True
    return (len(mods) >= 2 and mods[-1] == "1" and leaf not in _BN_LEAVES)


def import_torch_state_dict(state_dict: Dict[str, torch.Tensor], model: nn.Module,
                            surgery: Optional[Dict[str, str]] = None,
                            prefix: str = "") -> Dict[str, List[str]]:
    """Copy ``state_dict`` into ``model``'s parameters and buffers in place
    (strict=False) and return tpureg's report: the keys ``loaded``,
    ``missing`` (no tensor of that name) and ``shape_mismatch``.

    ``surgery`` maps keys to ``"rgb"`` or ``"rgb_pair"``, applied before
    the shapes are compared; ``prefix`` is put before every key (e.g.
    ``"predictor."`` to import a predictor's checkpoint into the
    registration head). Each value is cast to its target's dtype.
    """
    targets = model.state_dict(keep_vars=True)
    report: Dict[str, List[str]] = {"loaded": [], "missing": [],
                                    "shape_mismatch": []}
    surgery = surgery or {}
    with torch.no_grad():
        for key, value in state_dict.items():
            if _dropped(key):
                continue
            if key in surgery:
                value = (collapse_rgb_input(value) if surgery[key] == "rgb"
                         else collapse_rgb_pair_input(value))
            target = targets.get(prefix + key)
            if target is None:
                report["missing"].append(key)
                continue
            if tuple(target.shape) != tuple(value.shape):
                report["shape_mismatch"].append(
                    f"{key}: {tuple(value.shape)} -> {tuple(target.shape)}")
                continue
            target.copy_(value.to(target.dtype))
            report["loaded"].append(key)
    return report
