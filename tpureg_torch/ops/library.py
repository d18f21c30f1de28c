"""The port's kernels as ``torch.library`` operators in the namespace
``tpureg``.

| op                | kernel | on the CPU                                   |
| ----------------- | ------ | -------------------------------------------- |
| ``correlation``   | K1     | the plain cost volume                        |
| ``correlation_bwd`` | K2   | its VJP                                      |
| ``sample2d``      | K3     | the plain 4-tap gather                       |
| ``sample2d_dpos`` | K4     | the gather's VJP in the positions            |
| ``sample2d_dimg`` | K5     | the gather's VJP in the image                |
| ``sample3d``      | K6a    | the plain 8-tap gather                       |
| ``sample3d_dpos`` | K6b    | the gather's VJP in the positions            |
| ``sample3d_dvol`` | K6c    | the gather's VJP in the volume               |

Each op dispatches by its tensors' device: a CUDA tensor goes to the
launch function (``correlation_cuda``, ``sample2d_cuda``, ...), given its
operands contiguous, with its checks and its ``.launches`` counter, and a
failed build or launch raises; a CPU tensor goes to the plain version,
computed in fp32 (fp64 for fp64 operands) as the launch functions are, the
backward ops' by autograd through it (``_vjp``). The fake implementations
give the launch functions' output shapes and dtypes, so ``torch.export``
traces a model through the ops and names each as a node of its graph; an
exported program then runs on either device.

On the card the three forward ops carry their backward
(``register_autograd``): K2 after K1; K5 (K6c) only when the image
(volume) needs a gradient and K4 (K6b) only when the positions do, the
image (volume) saved only then. On the CPU autograd records the plain
version's own operations (an ``AutogradCPU`` kernel), so the CPU path adds
its cotangents in the order it always did: one node in their place sums
the correlation's 441 cotangent terms of FlowNetC's first features before
the ``conv_redir`` branch's, and FlowNet2's fp32 gradient at a random
initialisation amplifies that rounding change to 1e-2 relative L2
(tests/test_torch_train.py holds it to tpureg's fp64 gradient).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch
from torch import Tensor
from torch._C import DispatchKey, DispatchKeySet

from .correlation import (
    correlation_bwd_cuda,
    correlation_cuda,
    correlation_plain,
    displacement_count,
)
from .warp import (
    _compute_dtype,
    sample2d_cuda,
    sample2d_dimg_cuda,
    sample2d_dpos_cuda,
    sample2d_plain,
    sample3d_cuda,
    sample3d_dpos_cuda,
    sample3d_dvol_cuda,
    sample3d_plain,
)

__all__ = ["OPS"]

_LIB = "tpureg"


# what the dispatcher leaves out below an op's autograd kernel
_AUTOGRAD_KEYS = (DispatchKeySet(DispatchKey.AutogradFunctionality)
                  | DispatchKeySet(DispatchKey.AutogradOther)
                  | DispatchKeySet(DispatchKey.AutogradNestedTensor)
                  | DispatchKeySet(DispatchKey.ADInplaceOrView))


# the forward ops' CPU autograd kernels
_CPU_AUTOGRAD = torch.library.Library(_LIB, "IMPL")


def _op(name: str):
    return torch.library.custom_op(f"{_LIB}::{name}", mutates_args=(),
                                   device_types="cpu")


def _on_cuda(op, launch):
    """``launch`` as ``op``'s CUDA kernel, its tensors made contiguous (an
    exported graph passes a convolution's output as cuDNN laid it out)."""
    op.register_kernel("cuda")(lambda *args: launch(*(
        a.contiguous() if isinstance(a, Tensor) else a for a in args)))


@contextlib.contextmanager
def _autograd_on():
    """Autograd inside an op's implementation, which the dispatcher runs
    with the autograd keys excluded."""
    include = torch._C._dispatch_tls_local_include_set()
    exclude = torch._C._dispatch_tls_local_exclude_set()
    with torch._C._ForceDispatchKeyGuard(include, exclude - _AUTOGRAD_KEYS), \
            torch.enable_grad():
        yield


def _vjp(fn, primals, cotangent):
    """The cotangents of ``primals`` by autograd through ``fn(*primals)``."""
    with _autograd_on():
        leaves = [p.detach().requires_grad_() for p in primals]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, cotangent.to(out.dtype))


# ---------------------------------------------------------------------------
# correlation: K1 forward, K2 backward


@_op("correlation")
def _correlation(f1: Tensor, f2: Tensor, max_displacement: int,
                 stride2: int) -> Tensor:
    return correlation_plain(f1, f2, max_displacement, stride2)


@_op("correlation_bwd")
def _correlation_bwd(f1: Tensor, f2: Tensor, grad: Tensor,
                     max_displacement: int, stride2: int
                     ) -> Tuple[Tensor, Tensor]:
    return _vjp(lambda a, b: correlation_plain(a, b, max_displacement, stride2),
                (f1, f2), grad)


_on_cuda(_correlation, correlation_cuda)
_on_cuda(_correlation_bwd, correlation_bwd_cuda)


@_correlation.register_fake
def _(f1, f2, max_displacement, stride2):
    b, _, h, w = f1.shape
    k = displacement_count(max_displacement, stride2)
    return f1.new_empty((b, k * k, h, w))


@_correlation_bwd.register_fake
def _(f1, f2, grad, max_displacement, stride2):
    return torch.empty_like(f1), torch.empty_like(f2)


def _correlation_setup(ctx, inputs, output):
    f1, f2, max_displacement, stride2 = inputs
    ctx.save_for_backward(f1, f2)
    ctx.geometry = (max_displacement, stride2)


def _correlation_backward(ctx, grad):
    f1, f2 = ctx.saved_tensors
    df1, df2 = torch.ops.tpureg.correlation_bwd(f1, f2, grad.contiguous(),
                                                *ctx.geometry)
    return df1, df2, None, None


_correlation.register_autograd(_correlation_backward,
                               setup_context=_correlation_setup)
_CPU_AUTOGRAD.impl("correlation", correlation_plain, "AutogradCPU")


# ---------------------------------------------------------------------------
# bilinear sample: K3 forward, K4 and K5 backward


@_op("sample2d")
def _sample2d(img: Tensor, px: Tensor, py: Tensor) -> Tensor:
    return sample2d_plain(img, px, py)


@_op("sample2d_dpos")
def _sample2d_dpos(grad: Tensor, img: Tensor, px: Tensor, py: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    return _vjp(lambda x, y: sample2d_plain(img, x, y), (px, py), grad)


@_op("sample2d_dimg")
def _sample2d_dimg(grad: Tensor, px: Tensor, py: Tensor,
                   image_shape: List[int], dtype: torch.dtype) -> Tensor:
    zeros = torch.zeros(image_shape, dtype=dtype, device=grad.device)
    return _vjp(lambda i: sample2d_plain(i, px, py), (zeros,), grad)[0]


_on_cuda(_sample2d, sample2d_cuda)
_on_cuda(_sample2d_dpos, sample2d_dpos_cuda)
_on_cuda(_sample2d_dimg, sample2d_dimg_cuda)


@_sample2d.register_fake
def _(img, px, py):
    return px.new_empty((img.shape[0], img.shape[1], px.shape[1]),
                        dtype=_compute_dtype(img))


@_sample2d_dpos.register_fake
def _(grad, img, px, py):
    return torch.empty_like(px), torch.empty_like(py)


@_sample2d_dimg.register_fake
def _(grad, px, py, image_shape, dtype):
    return grad.new_empty(image_shape, dtype=dtype)


def _sample_setup(ctx, inputs, output):
    """(source, *positions): the source saved only when the positions need
    a gradient (K4 and K6b read it; K5 and K6c do not)."""
    src, *pos = inputs
    ctx.source = (list(src.shape), src.dtype)
    ctx.positions = len(pos)
    need_pos = any(ctx.needs_input_grad[1:1 + len(pos)])
    ctx.save_for_backward(src if need_pos else None, *pos)


def _sample_backward(dsrc_op, dpos_op):
    def backward(ctx, grad):
        src, *pos = ctx.saved_tensors
        grad = grad.contiguous()
        need = ctx.needs_input_grad
        dsrc = dsrc_op(grad, *pos, *ctx.source) if need[0] else None
        dpos = (None,) * ctx.positions
        if any(need[1:]):
            dpos = dpos_op(grad, src, *pos)
        return (dsrc, *(d if n else None for d, n in zip(dpos, need[1:])))
    return backward


_sample2d.register_autograd(
    _sample_backward(lambda *a: torch.ops.tpureg.sample2d_dimg(*a),
                     lambda *a: torch.ops.tpureg.sample2d_dpos(*a)),
    setup_context=_sample_setup)
_CPU_AUTOGRAD.impl("sample2d", sample2d_plain, "AutogradCPU")


# ---------------------------------------------------------------------------
# trilinear sample: K6a forward, K6b and K6c backward


@_op("sample3d")
def _sample3d(vol: Tensor, px: Tensor, py: Tensor, pz: Tensor) -> Tensor:
    return sample3d_plain(vol, px, py, pz)


@_op("sample3d_dpos")
def _sample3d_dpos(grad: Tensor, vol: Tensor, px: Tensor, py: Tensor,
                   pz: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return _vjp(lambda x, y, z: sample3d_plain(vol, x, y, z), (px, py, pz), grad)


@_op("sample3d_dvol")
def _sample3d_dvol(grad: Tensor, px: Tensor, py: Tensor, pz: Tensor,
                   volume_shape: List[int], dtype: torch.dtype) -> Tensor:
    zeros = torch.zeros(volume_shape, dtype=dtype, device=grad.device)
    return _vjp(lambda v: sample3d_plain(v, px, py, pz), (zeros,), grad)[0]


_on_cuda(_sample3d, sample3d_cuda)
_on_cuda(_sample3d_dpos, sample3d_dpos_cuda)
_on_cuda(_sample3d_dvol, sample3d_dvol_cuda)


@_sample3d.register_fake
def _(vol, px, py, pz):
    return px.new_empty((vol.shape[0], vol.shape[1], px.shape[1]),
                        dtype=_compute_dtype(vol))


@_sample3d_dpos.register_fake
def _(grad, vol, px, py, pz):
    return torch.empty_like(px), torch.empty_like(py), torch.empty_like(pz)


@_sample3d_dvol.register_fake
def _(grad, px, py, pz, volume_shape, dtype):
    return grad.new_empty(volume_shape, dtype=dtype)


_sample3d.register_autograd(
    _sample_backward(lambda *a: torch.ops.tpureg.sample3d_dvol(*a),
                     lambda *a: torch.ops.tpureg.sample3d_dpos(*a)),
    setup_context=_sample_setup)
_CPU_AUTOGRAD.impl("sample3d", sample3d_plain, "AutogradCPU")


# op name -> (its kernel, its launch function): what chip_smoke.py and the
# card tests walk
OPS: Sequence[Tuple[str, str, object]] = (
    ("correlation", "K1", correlation_cuda),
    ("correlation_bwd", "K2", correlation_bwd_cuda),
    ("sample2d", "K3", sample2d_cuda),
    ("sample2d_dpos", "K4", sample2d_dpos_cuda),
    ("sample2d_dimg", "K5", sample2d_dimg_cuda),
    ("sample3d", "K6a", sample3d_cuda),
    ("sample3d_dpos", "K6b", sample3d_dpos_cuda),
    ("sample3d_dvol", "K6c", sample3d_dvol_cuda),
)
