"""The port's kernels as ``torch.library`` ops (tpureg_torch/ops/library.py)
on the CPU: ``torch.library.opcheck`` on each of the eight ops in fp32 and
fp64; the forward ops' gradients against autograd through the plain
versions (bit for bit), both on the CPU's own path (autograd through the
plain version) and through the backward the ops register for the card,
whose backward ops then run their CPU implementations; and that rule's
wiring: a backward op runs only for an input that needs its gradient.

The ops' CUDA kernels are held to their launch functions on the card in
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch
from torch._library.custom_ops import _maybe_get_opdef
from torch.utils._python_dispatch import TorchDispatchMode

from tpureg_torch.ops import (
    correlation,
    correlation_plain,
    sample2d,
    sample2d_gather,
    sample3d,
    sample3d_gather,
)
from tpureg_torch.ops.library import OPS
from tpureg_torch.ops.warp import _compute_dtype

DTYPES = (torch.float32, torch.float64)
FORWARD = ("correlation", "sample2d", "sample3d")


def card_autograd(name):
    """``tpureg::<name>`` with the backward it registers for the card
    (``register_autograd``: its ``setup_context`` and ``backward``), as an
    autograd node that also runs on CPU tensors, where the op's own
    autograd is the plain version's: its forward calls the op below
    autograd, its backward the backward ops, which run their CPU
    implementations."""
    opdef = _maybe_get_opdef(f"tpureg::{name}")

    class Node(torch.autograd.Function):
        @staticmethod
        def forward(*args):
            with torch._C._AutoDispatchBelowAutograd():
                return opdef._opoverload(*args)

        @staticmethod
        def setup_context(ctx, inputs, output):
            opdef._setup_context_fn(ctx, inputs, output)

        @staticmethod
        def backward(ctx, *grads):
            return opdef._backward_fn(ctx, *grads)

    return Node.apply


def draw(seed, *shape, dtype=torch.float32, low=None, high=None):
    a = np.random.default_rng(seed).standard_normal(shape)
    if low is not None:
        a = np.random.default_rng(seed).uniform(low, high, shape)
    return torch.from_numpy(a).to(dtype)


def op_args(name, dtype):
    """Small operands of each op: positions reach a tap or two outside the
    image, so the zero padding is in play."""
    b, c, h, w, p = 2, 3, 6, 7, 11
    pos2 = [draw(1, b, p, dtype=dtype, low=-1.5, high=w + 0.5),
            draw(2, b, p, dtype=dtype, low=-1.5, high=h + 0.5)]
    d = 4
    pos3 = pos2 + [draw(3, b, p, dtype=dtype, low=-1.5, high=d + 0.5)]
    img = draw(4, b, c, h, w, dtype=dtype)
    vol = draw(5, b, c, d, h, w, dtype=dtype)
    g = draw(6, b, c, p, dtype=dtype)
    f1, f2 = draw(7, b, 4, h, w, dtype=dtype), draw(8, b, 4, h, w, dtype=dtype)
    return {
        "correlation": (f1, f2, 2, 1),
        "correlation_bwd": (f1, f2, draw(9, b, 25, h, w, dtype=dtype), 2, 1),
        "sample2d": (img, *pos2),
        "sample2d_dpos": (g, img, *pos2),
        "sample2d_dimg": (g, *pos2, [b, c, h, w], dtype),
        "sample3d": (vol, *pos3),
        "sample3d_dpos": (g, vol, *pos3),
        "sample3d_dvol": (g, *pos3, [b, c, d, h, w], dtype),
    }[name]


def test_every_kernel_is_an_op():
    assert [name for name, _, _ in OPS] == [
        "correlation", "correlation_bwd", "sample2d", "sample2d_dpos",
        "sample2d_dimg", "sample3d", "sample3d_dpos", "sample3d_dvol"]
    assert [k for _, k, _ in OPS] == ["K1", "K2", "K3", "K4", "K5", "K6a",
                                      "K6b", "K6c"]
    for name, _, launch in OPS:
        assert hasattr(torch.ops.tpureg, name) and launch.launches == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", [name for name, _, _ in OPS])
def test_opcheck(name, dtype):
    """Schema, fake implementation, autograd registration and the traced
    (AOT) dispatch of each op. A forward op's operands need a gradient; the
    backward ops are first-order (no kernel differentiates them again), so
    theirs do not."""
    forward = name in FORWARD
    args = [a.requires_grad_(forward) if isinstance(a, torch.Tensor) else a
            for a in op_args(name, dtype)]
    result = torch.library.opcheck(getattr(torch.ops.tpureg, name), args)
    assert set(result.values()) == {"SUCCESS"}, result


def _grads(fn, inputs, need, seed):
    leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, need)]
    out = fn(*leaves)
    cot = draw(seed, *out.shape, dtype=out.dtype)
    grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], cot)
    return out.detach(), grads


NEEDS = {"all": None, "source": 0, "positions": 1}


@pytest.mark.parametrize("path", ["cpu", "registered"])
@pytest.mark.parametrize("need", list(NEEDS))
@pytest.mark.parametrize("dtype", (*DTYPES, torch.bfloat16), ids=str)
@pytest.mark.parametrize("which", FORWARD)
def test_cpu_gradients_equal_autograd_through_the_plain_version(which, dtype, need,
                                                                path):
    """Forward and cotangents through the op equal autograd through the
    plain function bit for bit, whichever inputs need a gradient: on the
    CPU's path (the CPU keeps the numbers it had before the ops) and
    through the backward registered for the card, with the backward ops'
    CPU implementations."""
    card = card_autograd(which)
    if which == "correlation":
        ins = (draw(7, 2, 4, 6, 7, dtype=dtype), draw(8, 2, 4, 6, 7, dtype=dtype))
        ours = lambda a, b: correlation(a, b, 2, 1)
        if path == "registered":
            ours = lambda a, b: card(a, b, 2, 1)
        plain = lambda a, b: correlation_plain(a, b, 2, 1)
    else:
        nd = 2 if which == "sample2d" else 3
        src = draw(4, 2, 3, *(4, 6, 7)[3 - nd:], dtype=dtype)
        pos = [draw(10 + i, 2, 15, low=-1.5, high=6.5) for i in range(nd)]
        ins = (src, *pos)
        ours = sample2d if nd == 2 else sample3d
        if path == "registered":  # the op's own operands: positions [B, P], compute dtype
            ours = lambda s, *p: card(s, *(t.to(_compute_dtype(s)) for t in p)).to(s.dtype)
        plain = sample2d_gather if nd == 2 else sample3d_gather
    sel = NEEDS[need]
    flags = [True] * len(ins) if sel is None else (
        [i == 0 for i in range(len(ins))] if sel == 0 else [i > 0 for i in range(len(ins))])
    got, want = _grads(ours, ins, flags, 20), _grads(plain, ins, flags, 20)
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == sum(flags)
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype and torch.equal(g, w)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "tpureg":
            self.ops.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("need,want", [
    ("source", ["sample2d", "sample2d_dimg"]),
    ("positions", ["sample2d", "sample2d_dpos"]),
    ("all", ["sample2d", "sample2d_dimg", "sample2d_dpos"]),
    ("source3d", ["sample3d", "sample3d_dvol"]),
    ("positions3d", ["sample3d", "sample3d_dpos"]),
    ("all3d", ["sample3d", "sample3d_dvol", "sample3d_dpos"]),
])
def test_backward_ops_run_only_where_a_gradient_is_needed(need, want):
    """The backward registered for the card: K5 (K6c) runs only when the
    image (volume) needs a gradient and K4 (K6b) only when the positions
    do, as the autograd nodes decided before the ops."""
    three = need.endswith("3d")
    src = draw(4, 1, 2, *((3, 5, 6) if three else (5, 6)))
    pos = [draw(10 + i, 1, 7, low=-1.0, high=5.0) for i in range(3 if three else 2)]
    base = need.removesuffix("3d")
    src.requires_grad_(base in ("source", "all"))
    for p in pos:
        p.requires_grad_(base in ("positions", "all"))
    with _OpLog() as log:
        out = card_autograd("sample3d" if three else "sample2d")(src, *pos)
        out.sum().backward()
    assert log.ops == want


def test_correlation_backward_is_one_op():
    """The backward registered for the card: K2, once, for both operands."""
    f1 = draw(7, 1, 4, 5, 6).requires_grad_()
    f2 = draw(8, 1, 4, 5, 6).requires_grad_()
    with _OpLog() as log:
        card_autograd("correlation")(f1, f2, 2, 1).sum().backward()
    assert log.ops == ["correlation", "correlation_bwd"]


@pytest.mark.parametrize("which", FORWARD)
def test_cpu_autograd_records_the_plain_operations(which):
    """On the CPU no op node stands in the graph: autograd records the
    plain version's operations (the op goes no further than its autograd
    kernel, so below autograd nothing of ``tpureg`` runs), and no backward
    op runs."""
    if which == "correlation":
        ins = (draw(7, 1, 4, 5, 6), draw(8, 1, 4, 5, 6))
        fn = lambda a, b: correlation(a, b, 2, 1)
    else:
        nd = 2 if which == "sample2d" else 3
        ins = (draw(4, 1, 2, *(3, 5, 6)[3 - nd:]),
               *(draw(10 + i, 1, 7, low=-1.0, high=5.0) for i in range(nd)))
        fn = sample2d if nd == 2 else sample3d
    ins = [t.requires_grad_() for t in ins]
    with _OpLog() as log:
        out = fn(*ins)
        assert "tpureg" not in type(out.grad_fn).__name__
        out.sum().backward()
    assert log.ops == []
    assert all(t.grad is not None for t in ins)


def test_a_cuda_operand_never_reaches_the_plain_version():
    """The op's CPU implementations are registered for the CPU alone: no
    other device falls back to them."""
    for name, _, _ in OPS:
        op = getattr(torch.ops.tpureg, name).default
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CPU)
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CUDA)
        assert not op.has_kernel_for_dispatch_key(
            torch._C.DispatchKey.CompositeExplicitAutograd)
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.AutogradCPU) \
            == (name in FORWARD)
