"""The precision a reference computation runs in.

``f64``: float64 throughout, the judge. ``tf32``: float32 with every
matrix product's inputs rounded to TF32 (10 mantissa bits, round to
nearest) and accumulated in float32, which is what a TF32 tensor-core
product computes; factorizations and triangular solves stay float32. The
rounding is done here, not by ``torch.backends.cuda.matmul.allow_tf32``,
so the control is the same on every device and covers every product.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def round_tf32(a: Tensor) -> Tensor:
    """float32 ``a`` rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        return round_tf32(a)

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def cast(self, a: Tensor) -> Tensor:
        return a.to(self.dtype)

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.name == "f64":
            return a @ b
        return _StraightThrough.apply(a) @ _StraightThrough.apply(b)
