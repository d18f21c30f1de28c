"""Export of a registration head for serving (``torch.export``), the
counterpart of ``tpureg/serving/export.py``.

:func:`export_registration` traces the head's eval forward with its
weights and BatchNorm statistics into an ``ExportedProgram``;
:func:`save_artifact` writes it as one file (``torch.export.save``). The
file needs no model code at the serving site: ``torch.export.load`` (or
:func:`load_artifact`) in a process that has imported ``tpureg_torch.ops``,
which registers the ops ``tpureg::*`` the graph calls (the kernels build
at their first launch).

Calling convention, tpureg's: ``f(imgs[, segs]) -> (flows, warped_imgs,
warped_segs or None, warped_grid)``, channels-last in and out, with the
shapes of ``OpticalFlowReg.forward`` at the batch and size fixed at export.

tpureg lowers for ``platforms=("tpu", "cpu")``; here the platforms are
``"cuda"`` and ``"cpu"``. Each op of the graph dispatches by the device of
its tensors, so one artifact serves on both: it is traced where the model
lies, and :func:`load_artifact` moves it to the device asked for.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from .. import ops  # noqa: F401 (registers tpureg::*)
from ..train.steps import _forward

__all__ = ["PLATFORMS", "export_registration", "save_artifact", "load_artifact",
           "compare_outputs", "deterministic_cudnn"]

PLATFORMS = ("cuda", "cpu")


class _EvalForward(nn.Module):
    """The head's eval forward on channels-last inputs, the eval step's
    casts included (``train/steps.py::_forward``)."""

    def __init__(self, head, compute_dtype):
        super().__init__()
        self.head = head
        self.compute_dtype = compute_dtype

    def forward(self, imgs, segs=None):
        return _forward(self.head, imgs, segs, self.compute_dtype)


def export_registration(model, batch_size: int, image_size: int,
                        with_segs: bool = False,
                        platforms: Optional[Sequence[str]] = None,
                        dtype: torch.dtype = torch.float32):
    """Export ``model`` (an ``OpticalFlowReg``, put in eval mode) at inputs
    [batch_size, image_size, image_size, 2] of ``dtype``, on the device of
    its parameters. A ``dtype`` other than fp32 casts the weights on every
    call as the bf16 eval step does. ``platforms`` names the devices the
    artifact is meant for (a subset of ``PLATFORMS``; every artifact serves
    on both). Returns a ``torch.export.ExportedProgram``."""
    unknown = set(platforms or ()) - set(PLATFORMS)
    if unknown:
        raise ValueError(f"unknown platforms {sorted(unknown)}; the artifact "
                         f"serves on {PLATFORMS}")
    device = next(model.parameters()).device
    # one example tensor an input: export would fold two inputs given the
    # same tensor into one
    args = tuple(torch.zeros((batch_size, image_size, image_size, 2), dtype=dtype,
                             device=device) for _ in range(2 if with_segs else 1))
    forward = _EvalForward(model.eval(),
                           None if dtype == torch.float32 else dtype)
    with torch.no_grad():
        return torch.export.export(forward, args)


def save_artifact(path: str, exported) -> None:
    torch.export.save(exported, path)


def load_artifact(path: str, device=None):
    """The artifact at ``path`` as a callable ``f(imgs[, segs])`` (its
    weights frozen), moved to ``device`` when one is given."""
    exported = torch.export.load(path)
    if device is not None:
        exported = move_to_device_pass(exported, torch.device(device))
    module = exported.module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the duration: its default
    transposed convolutions (FlowNet's deconvolutions) add with atomics, so
    two calls of one head on the card need not give the same flows."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def compare_outputs(got, want, flow_rtol: float = 1e-5):
    """Hold an artifact's outputs ``got`` to the live head's ``want``: the
    same structure; each flow within ``flow_rtol`` of its scale (its largest
    value, at least 1); each warped image, and the warped grid, within
    2 (d + 2 n 2^-23) + 1e-6, d its flow's largest difference and n the
    image's side: a sample of values in [0, 1] moves by at most its
    position's change along x plus along y, and a position below n changes
    by d and two fp32 roundings; the warped segmentations equal. Raises
    AssertionError; returns the largest differences."""
    tree = torch.utils._pytree.tree_structure
    if tree(got) != tree(want):
        raise AssertionError(f"output structure {tree(got)} != {tree(want)}")
    diff = lambda g, w: float((g.float() - w.float()).abs().max())
    flows = []
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        scale = max(float(w.abs().max()), 1.0)
        flows.append(diff(g, w))
        if flows[-1] > flow_rtol * scale:
            raise AssertionError(f"flow {i} off by {flows[-1]:.3g} at scale {scale:.4g}")
    warped = [diff(g, w) for g, w in zip(got[1], want[1])]
    grid = diff(got[3], want[3])
    for name, d, flow, image in (
            *((f"warped image {i}", d, flows[i], want[1][i]) for i, d in enumerate(warped)),
            ("warped grid", grid, flows[0], want[3])):
        bound = 2 * (flow + 2 * max(image.shape[1:3]) * 2.0 ** -23) + 1e-6
        if d > bound:
            raise AssertionError(f"{name} off by {d:.3g} (bound {bound:.3g}, its "
                                 f"flow off by {flow:.3g})")
    if want[2] is not None and not torch.equal(got[2], want[2]):
        raise AssertionError("warped segmentations differ")
    return {"flows": flows, "warped": warped, "grid": grid}
