"""Operand precision of the reference's convolutions and matmuls.

'f32' computes in float32 with TF32 off.  'fp8', the control of a
bfloat16 configuration (the next precision below it), rounds each
operand of every convolution and matmul per tensor to e4m3 (scaled to
its absmax) and each gradient to e5m2, and computes in float32.  The
int8 mode's control (int4) lives with its convs in `model.mark_int8`.
"""
from __future__ import annotations

import contextlib

import torch


def _fake(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fake(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fake(grad, torch.float8_e5m2)


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x as a convolution or matmul takes it at `prec`."""
    if prec == "f32":
        return x
    if prec == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {prec!r}")


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
