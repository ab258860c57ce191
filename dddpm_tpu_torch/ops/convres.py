"""Fused ConvResBlock forward (port of the forward half of
dddpm_tpu/ops/pallas/convres.py).

mish -> 1x1 (cio -> cm) -> mish -> 3x3 -> mish -> 3x3 -> mish -> 1x1
(cm -> cio), + x when residual, then an optional 2x2 mean pool ('down')
or 2x nearest upsample ('up').  NHWC activations and HWIO weights, the
JAX package's layout.

On a CUDA tensor the whole block is one hand-written kernel
(csrc/convres_fwd.cu); on a CPU tensor the plain version
`reference_impl` runs.  The backward kernel is not ported yet, so the
kernel path refuses inputs that require grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops.math import mish

MID_CHANNELS = 32          # CM in csrc/convres_fwd.cu
IO_CHANNELS = (32, 64, 128)
_SCALES = {None: 0, "up": 1, "down": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the C entry; chip_smoke.py reads it
LAUNCHES = {"convres_fwd": 0}


def scale_ref(out: torch.Tensor, scale: Optional[str]) -> torch.Tensor:
    """The block's scaling on NHWC: 2x2 mean pool or 2x nearest upsample."""
    b, hh, ww, c = out.shape
    if scale == "down":
        pooled = out.reshape(b, hh // 2, 2, ww // 2, 2, c).sum(dim=(2, 4))
        return (pooled * 0.25).to(out.dtype)
    if scale == "up":
        return (out[:, :, None, :, None, :].expand(b, hh, 2, ww, 2, c)
                .reshape(b, hh * 2, ww * 2, c))
    return out


def reference_impl(x, w1, b1, w2, b2, w3, b3, w4, b4, residual: bool = True,
                   scale: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version on NHWC x with HWIO weights."""
    dt = x.dtype

    def conv(v, w, b, pad):
        y = F.conv2d(v, w.permute(3, 2, 0, 1).to(dt), padding=pad)
        return y + b.to(y.dtype)[None, :, None, None]

    def m(v):
        return mish(v.float()).to(dt)

    xc = x.permute(0, 3, 1, 2)
    h = conv(m(xc), w1, b1, 0)
    h = conv(m(h), w2, b2, 1)
    h = conv(m(h), w3, b3, 1)
    h = conv(m(h), w4, b4, 0)
    out = xc + h if residual else h
    return scale_ref(out.permute(0, 2, 3, 1), scale)


def _lib():
    lib = _build.load("convres_fwd")
    if lib.convres_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.convres_fwd.argtypes = [vp] * 10 + [i] * 7 + [vp]
        lib.convres_fwd.restype = i
    return lib


def _kernel(x, w1, b1, w2, b2, w3, b3, w4, b4, residual, scale):
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    bsz, h, w, c = x.shape
    cm = MID_CHANNELS
    if c not in IO_CHANNELS:
        raise ValueError(f"kernel takes {IO_CHANNELS} channels, got {c}")
    shapes = {"w1": (w1, (1, 1, c, cm)), "w2": (w2, (3, 3, cm, cm)),
              "w3": (w3, (3, 3, cm, cm)), "w4": (w4, (1, 1, cm, c)),
              "b1": (b1, (cm,)), "b2": (b2, (cm,)), "b3": (b3, (cm,)),
              "b4": (b4, (c,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want or t.device != x.device:
            raise ValueError(f"{name} must be {want} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if scale not in _SCALES:
        raise ValueError(f"scale must be None, 'up' or 'down', got {scale!r}")
    if scale == "down" and (h % 2 or w % 2):
        raise ValueError("scale='down' needs even H and W")
    out_hw = {None: (h, w), "up": (2 * h, 2 * w), "down": (h // 2, w // 2)}[scale]
    y = torch.empty((bsz, *out_hw, c), dtype=x.dtype, device=x.device)
    ws = [t.to(x.dtype).contiguous() for t in (w1, w2, w3, w4)]
    bs = [t.float().contiguous() for t in (b1, b2, b3, b4)]
    p = _build.ptr
    lib = _lib()
    LAUNCHES["convres_fwd"] += 1
    status = lib.convres_fwd(
        p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]), p(bs[2]),
        p(ws[3]), p(bs[3]), p(y), bsz, h, w, c, int(residual), _SCALES[scale],
        _DTYPES[x.dtype], _build.stream(x))
    _build.check(status, "convres_fwd")
    return y


def fused_convres_block(x, w1, b1, w2, b2, w3, b3, w4, b4,
                        residual: bool = True,
                        scale: Optional[str] = None) -> torch.Tensor:
    """The whole ConvResBlock on NHWC x: w1 (1,1,cio,cm), w2, w3
    (3,3,cm,cm), w4 (1,1,cm,cio), 1-D biases.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return reference_impl(x, w1, b1, w2, b2, w3, b3, w4, b4, residual,
                              scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2, w3, b3, w4, b4)):
        raise NotImplementedError(
            "the ConvResBlock backward kernel is not ported yet; run the "
            "kernel under torch.no_grad()")
    return _kernel(x, w1, b1, w2, b2, w3, b3, w4, b4, residual, scale)


def cost(bsz: int, h: int, w: int, c: int, itemsize: int,
         scale: Optional[str]) -> dict:
    """Bytes the block must move (x once, y once, weights) and FLOPs it
    must do (the four convs; mish counted as 8 operations)."""
    cm = MID_CHANNELS
    pix = bsz * h * w
    out_pix = {None: pix, "up": 4 * pix, "down": pix // 4}[scale]
    weights = (2 * c * cm + 18 * cm * cm) * itemsize + (3 * cm + c) * 4
    return {
        "bytes": pix * c * itemsize + out_pix * c * itemsize + weights,
        "flops": pix * (2 * (2 * c * cm + 18 * cm * cm) + 8 * (c + 3 * cm)),
    }
