"""Float8 e4m3 arithmetic for the references' control: the reference
computed one precision below the configurations' bfloat16. Where the
program holds a tensor in its compute dtype, the control rounds it to
e4m3 under a scale per tensor (its largest magnitude at 448, as float8
training scales), and its gradient on the way back (``cast``); every
operand of a matrix product, the incoming gradients of its backward
included, is rounded so (``matmul``), and the products accumulate in
float32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = round_e4m3(a), round_e4m3(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = round_e4m3(g)
        ga = g8 @ b8.transpose(-1, -2)
        gb = a8.transpose(-1, -2) @ g8
        # Operands broadcast over leading dims (a weight shared by a batch):
        # sum the gradient back to the operand's shape.
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        while ga.dim() > a8.dim():
            ga = ga.sum(0)
        return ga, gb


class _Cast(torch.autograd.Function):
    """A value entering low-precision compute: rounded going forward, and
    its gradient rounded coming back."""

    @staticmethod
    def forward(ctx, x):
        return round_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return round_e4m3(g)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Matmul.apply(a, b)


def cast(x: torch.Tensor) -> torch.Tensor:
    return _Cast.apply(x)
