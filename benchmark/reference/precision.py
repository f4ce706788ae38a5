"""The control's precisions, emulated: TF32 matrix products, and bfloat16
storage of every float32 result.

The port states float32 with TF32 off for its tracker, steady solve and
pose graph (isvins_tpu_torch/device.py). The nearest precision below is
TF32: a tensor core rounds each operand of a matrix product to 10
mantissa bits and accumulates in float32. `Tf32Products` is a
TorchFunctionMode under which every matrix-product call (matmul, mm, bmm,
einsum, the @ operator, addmm, baddbmm, tensordot, linear) gets its
float32 operands rounded to TF32 first, on any device, so that the control
reads the same on the card and on the CPU: what
torch.backends.cuda.matmul.allow_tf32 = True does to cuBLAS. Other
operations, the factorizations and triangular solves among them, stay
float32.

`Bf16Storage` is the step below that: every float32 tensor that an
operation returns is rounded to bfloat16 (8 mantissa bits) and kept as
float32, the arithmetic of each operation itself in float32, as a layer
that holds its values in bfloat16 computes. It reaches the layers where
TF32 products reach nothing that decides the answer (the steady solve's
and the pose graph's answers are set by their float32 residuals and
factorizations, PERF.md section 2), and works for the factorizations,
which torch has no bfloat16 kernel of."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm,
             torch.Tensor.bmm, torch.einsum, torch.addmm, torch.baddbmm,
             torch.tensordot, torch.nn.functional.linear}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value (10 mantissa bits, ties
    away from zero); other dtypes pass unchanged."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class Tf32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            conv = lambda a: ([tf32_round(t) for t in a] if isinstance(a, (list, tuple))
                              else tf32_round(a))
            args = tuple(conv(a) for a in args)
            kwargs = {k: conv(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def bf16_round(x):
    """x (float32) rounded to the nearest bfloat16 value, kept as float32;
    other dtypes and non-tensors pass unchanged."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    return x.to(torch.bfloat16).to(torch.float32)


class Bf16Storage(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        return _round_out(out, args)


def _round_out(out, args):
    if isinstance(out, (tuple, list)):
        return type(out)(_round_out(o, args) for o in out) if not hasattr(out, "_fields") \
            else type(out)(*(_round_out(o, args) for o in out))
    if not isinstance(out, torch.Tensor) or out.dtype != torch.float32:
        return out
    if any(out is a for a in args):  # in place (or returned as it was): round it there
        if 0 in out.stride():  # an expanded tensor, written by nothing
            return out
        return out.copy_(bf16_round(out))
    if out._is_view():  # a view of a tensor already rounded
        return out
    return bf16_round(out)
