"""Fused ConvResBlock forward (port of the forward half of
dddpm_tpu/ops/pallas/convres.py).

mish -> 1x1 (cio -> cm) -> mish -> 3x3 -> mish -> 3x3 -> mish -> 1x1
(cm -> cio), + x when residual, then an optional 2x2 mean pool ('down')
or 2x nearest upsample ('up').  NHWC activations and HWIO weights, the
JAX package's layout.

On a CUDA tensor the forward is one hand-written kernel
(csrc/convres_fwd.cu, K2) and the backward another (csrc/convres_bwd.cu,
K3) at the widths they are tuned for (cm 32, cio 32 / 64 / 128), and
the width-general route (csrc/convres_general.cu: the same function as a
chain of hand-written implicit-GEMM launches) at every other cm and cio
that are multiples of 32, the widths the JAX gate admits; on a CPU
tensor the plain versions run (`reference_impl`, and
`backward_reference` under autograd).  As in the JAX custom VJP, the
forward saves only x and the weights: the backward recomputes the
intermediates, and the scaling's VJP (`unscale_grad`) runs in plain
PyTorch before the backward kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops.math import mish

# the widths the tuned kernels take (CM in csrc/convres_sm90.cuh, their
# CIO instantiations); csrc/convres_general.cu takes every other width
MID_CHANNELS = 32
IO_CHANNELS = (32, 64, 128)
CHANNEL_STEP = 32          # every route: cm and cio multiples of 32
_SCALES = {None: 0, "up": 1, "down": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each C entry; chip_smoke.py reads these
LAUNCHES = {"convres_fwd": 0, "convres_bwd": 0, "convres_fwd_general": 0,
            "convres_bwd_general": 0}


def tuned(c: int, cm: int) -> bool:
    """Whether the tuned kernels (convres_fwd.cu, convres_bwd.cu) take
    cio c and cm mid channels; else the width-general route runs."""
    return cm == MID_CHANNELS and c in IO_CHANNELS


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


def unscale_grad(dy: torch.Tensor, scale: Optional[str]) -> torch.Tensor:
    """VJP of scale_ref on NHWC dy: 'down' is a 2x2 broadcast x0.25, 'up'
    a 2x2 window sum (dddpm_tpu/ops/pallas/convres.py:_unscale_grad)."""
    b, hh, ww, c = dy.shape
    if scale == "down":
        return ((dy[:, :, None, :, None, :] * 0.25).expand(b, hh, 2, ww, 2, c)
                .reshape(b, hh * 2, ww * 2, c))
    if scale == "up":
        return dy.reshape(b, hh // 2, 2, ww // 2, 2, c).sum(dim=(2, 4))
    return dy


def backward_reference(x, w1, b1, w2, b2, w3, b3, w4, b4, dy,
                       residual: bool = True) -> tuple:
    """Plain version of the backward (what K3 computes): the gradients of
    reference_impl (no scaling) at x for the output gradient dy, as
    (dx, dw1, db1, dw2, db2, dw3, db3, dw4, db4), each in its input's
    dtype, by autograd."""
    inputs = [t.detach().requires_grad_() for t in
              (x, w1, b1, w2, b2, w3, b3, w4, b4)]
    with torch.enable_grad():
        y = reference_impl(*inputs, residual=residual)
        return torch.autograd.grad(y, inputs, dy.to(y.dtype))


def library(defines=()):
    """csrc/convres_fwd.cu's library (built with `defines`, see
    _build.load), its C entry typed."""
    lib = _build.load("convres_fwd", tuple(defines))
    if lib.convres_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.convres_fwd.argtypes = [vp] * 10 + [i] * 7 + [vp]
        lib.convres_fwd.restype = i
    return lib


def library_bwd(defines=()):
    """csrc/convres_bwd.cu's library (built with `defines`, see
    _build.load), its C entries typed."""
    lib = _build.load("convres_bwd", tuple(defines))
    if lib.convres_bwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.convres_bwd.argtypes = [vp] * 12 + [i] * 7 + [vp]
        lib.convres_bwd.restype = i
        lib.convres_bwd_partial_size.argtypes = [i]
        lib.convres_bwd_partial_size.restype = i
    return lib


def library_general():
    """csrc/convres_general.cu's library, its C entries typed."""
    lib = _build.load("convres_general")
    if lib.convres_fwd_general.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.convres_fwd_general.argtypes = [vp] * 11 + [i] * 8 + [vp]
        lib.convres_fwd_general.restype = i
        lib.convres_bwd_general.argtypes = [vp] * 14 + [i] * 7 + [vp]
        lib.convres_bwd_general.restype = i
        lib.convres_bwd_general_part.argtypes = [i] * 5
        lib.convres_bwd_general_part.restype = ll
        lib.convres_general_samples.argtypes = [i] * 3
        lib.convres_general_samples.restype = i
    return lib


def _check_block(x, w1, b1, w2, b2, w3, b3, w4, b4,
                 forward: bool = False) -> None:
    """Raises on what the kernels do not take; `forward`, also on what
    K2 does not take (a bfloat16 x that is not 16-byte aligned: its
    tensor-core path loads and stores 16-byte pieces; at the general
    route's widths any x that is not, in either dtype)."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    c, cm = x.shape[-1], w1.shape[-1]
    if c % CHANNEL_STEP or cm % CHANNEL_STEP or not c or not cm:
        raise ValueError(f"kernel takes cio and cm that are multiples of "
                         f"{CHANNEL_STEP}, got cio {c}, cm {cm}")
    if forward and x.data_ptr() % 16:
        if x.dtype == torch.bfloat16:
            raise ValueError("the forward kernel needs a 16-byte aligned "
                             "bfloat16 x")
        if not tuned(c, cm):
            raise ValueError("the general route needs a 16-byte aligned x")
    shapes = {"w1": (w1, (1, 1, c, cm)), "w2": (w2, (3, 3, cm, cm)),
              "w3": (w3, (3, 3, cm, cm)), "w4": (w4, (1, 1, cm, c)),
              "b1": (b1, (cm,)), "b2": (b2, (cm,)), "b3": (b3, (cm,)),
              "b4": (b4, (c,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want or t.device != x.device:
            raise ValueError(f"{name} must be {want} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _kernel(x, w1, b1, w2, b2, w3, b3, w4, b4, residual, scale):
    """K2: the forward kernel (the general route at untuned widths)."""
    _check_block(x, w1, b1, w2, b2, w3, b3, w4, b4, forward=True)
    bsz, h, w, c = x.shape
    if scale not in _SCALES:
        raise ValueError(f"scale must be None, 'up' or 'down', got {scale!r}")
    if scale == "down" and (h % 2 or w % 2):
        raise ValueError("scale='down' needs even H and W")
    out_hw = {None: (h, w), "up": (2 * h, 2 * w), "down": (h // 2, w // 2)}[scale]
    y = torch.empty((bsz, *out_hw, c), dtype=x.dtype, device=x.device)
    ws = [_build.aligned(t.to(x.dtype).contiguous()) for t in (w1, w2, w3, w4)]
    bs = [_build.aligned(t.float().contiguous()) for t in (b1, b2, b3, b4)]
    p = _build.ptr
    cm = w1.shape[-1]
    if not tuned(c, cm):
        lib = library_general()
        bc = lib.convres_general_samples(bsz, h, w)   # samples a chunk
        scratch = torch.empty((2 * bc * h * w * cm,), dtype=x.dtype,
                              device=x.device)
        LAUNCHES["convres_fwd_general"] += 1
        _build.check(lib.convres_fwd_general(
            p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]), p(bs[2]),
            p(ws[3]), p(bs[3]), p(y), p(scratch), bsz, h, w, c, cm,
            int(residual), _SCALES[scale], _DTYPES[x.dtype],
            _build.stream(x)), "convres_fwd_general")
        return y
    lib = library()
    LAUNCHES["convres_fwd"] += 1
    status = lib.convres_fwd(
        p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]), p(bs[2]),
        p(ws[3]), p(bs[3]), p(y), bsz, h, w, c, int(residual), _SCALES[scale],
        _DTYPES[x.dtype], _build.stream(x))
    _build.check(status, "convres_fwd")
    return y


def _bwd_tile(c: int, dtype) -> tuple:
    """K3's output tile (rows, columns): bf16 8 x 16 (4 x 16 at 128
    channels), f32 8 x 8 (csrc/convres_bwd.cu)."""
    if dtype == torch.bfloat16:
        return (4 if c == 128 else 8), 16
    return 8, 8


def _bwd_blocks(x) -> int:
    """Blocks of K3: one per SM (each holds ~200 KB of shared memory),
    never more than there are tiles."""
    bsz, h, w, c = x.shape
    th, tw = _bwd_tile(c, x.dtype)
    tiles = bsz * -(-h // th) * -(-w // tw)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return max(1, min(tiles, sms))


def _bwd_kernel(x, w1, b1, w2, b2, w3, b3, w4, b4, dy, residual) -> tuple:
    """K3: dx in x's dtype and the eight weight and bias gradients in
    float32, in the shapes of w1..b4 (b4's gradient is dy's sum).
    Raises on what it does not take, a bfloat16 x or dy that is not
    16-byte aligned included (its bands come in 16-byte pieces)."""
    _check_block(x, w1, b1, w2, b2, w3, b3, w4, b4)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("dy must be contiguous and match x")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or dy.data_ptr() % 16):
        raise ValueError("the backward kernel needs 16-byte aligned bfloat16 "
                         "x and dy")
    bsz, h, w, c = x.shape
    cm = w1.shape[-1]
    if not tuned(c, cm):
        return _bwd_general(x, w1, b1, w2, b2, w3, b3, w4, b4, dy, residual)
    lib = library_bwd()
    n = lib.convres_bwd_partial_size(c)
    nblk = _bwd_blocks(x)
    part = torch.empty((nblk, n), dtype=torch.float32, device=x.device)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ws = [t.to(x.dtype).contiguous() for t in (w1, w2, w3, w4)]
    bs = [t.float().contiguous() for t in (b1, b2, b3)]
    p = _build.ptr
    LAUNCHES["convres_bwd"] += 1
    status = lib.convres_bwd(
        p(x), p(dy), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]),
        p(bs[2]), p(ws[3]), p(dx), p(part), p(out), bsz, h, w, c,
        int(residual), nblk, _DTYPES[x.dtype], _build.stream(x))
    _build.check(status, "convres_bwd")
    sizes = [c * cm, cm, 9 * cm * cm, cm, 9 * cm * cm, cm, cm * c, c]
    grads = torch.split(out, sizes)
    return (dx, *(g.view(t.shape) for g, t in
                  zip(grads, (w1, b1, w2, b2, w3, b3, w4, b4))))


def _bwd_general(x, w1, b1, w2, b2, w3, b3, w4, b4, dy, residual) -> tuple:
    """K3's width-general route (csrc/convres_general.cu): what
    _bwd_kernel returns, at every width the tuned kernel does not take."""
    bsz, h, w, c = x.shape
    cm = w1.shape[-1]
    lib = library_general()
    pix = lib.convres_general_samples(bsz, h, w) * h * w * cm
    scratch = torch.empty((6 * pix,), dtype=x.dtype, device=x.device)
    scratch_f32 = torch.empty((3 * pix,), dtype=torch.float32, device=x.device)
    part = torch.empty((lib.convres_bwd_general_part(bsz, h, w, c, cm),),
                       dtype=torch.float32, device=x.device)
    sizes = [c * cm, cm, 9 * cm * cm, cm, 9 * cm * cm, cm, cm * c, c]
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ws = [_build.aligned(t.to(x.dtype).contiguous()) for t in (w1, w2, w3, w4)]
    bs = [_build.aligned(t.float().contiguous()) for t in (b1, b2, b3)]
    p = _build.ptr
    LAUNCHES["convres_bwd_general"] += 1
    _build.check(lib.convres_bwd_general(
        p(x), p(dy), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]),
        p(bs[2]), p(ws[3]), p(dx), p(out), p(scratch), p(scratch_f32),
        p(part), bsz, h, w, c, cm, int(residual), _DTYPES[x.dtype],
        _build.stream(x)), "convres_bwd_general")
    grads = torch.split(out, sizes)
    return (dx, *(g.view(t.shape) for g, t in
                  zip(grads, (w1, b1, w2, b2, w3, b3, w4, b4))))


class _ConvResBlockFn(torch.autograd.Function):
    """K2 forward and K3 backward on the card, the plain versions on the
    CPU.  Saves only x and the weights, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, w4, b4, residual, scale):
        ctx.residual, ctx.scale = residual, scale
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3, w4, b4)
        if x.device.type == "cpu":
            return reference_impl(x, w1, b1, w2, b2, w3, b3, w4, b4, residual,
                                  scale)
        return _kernel(x, w1, b1, w2, b2, w3, b3, w4, b4, residual, scale)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        x = saved[0]
        dy = unscale_grad(dy, ctx.scale).to(x.dtype).contiguous()
        if x.device.type == "cpu":
            grads = backward_reference(*saved, dy, ctx.residual)
        else:
            if dy.data_ptr() % 16:   # a view into another gradient
                dy = dy.clone()
            grads = _bwd_kernel(*saved, dy, ctx.residual)
        # each gradient in its input's dtype, in the input's (view's) shape
        grads = [g.to(t.dtype) for g, t in zip(grads, saved)]
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None, None)


def fused_convres_block(x, w1, b1, w2, b2, w3, b3, w4, b4,
                        residual: bool = True,
                        scale: Optional[str] = None) -> torch.Tensor:
    """The whole ConvResBlock on NHWC x: w1 (1,1,cio,cm), w2, w3
    (3,3,cm,cm), w4 (1,1,cm,cio), 1-D biases.  CPU tensors take the plain
    versions; CUDA tensors launch the forward kernel and, under autograd,
    the backward kernel, or raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return _ConvResBlockFn.apply(x, w1, b1, w2, b2, w3, b3, w4, b4, residual,
                                 scale)


def cost(bsz: int, h: int, w: int, c: int, itemsize: int,
         scale: Optional[str], cm: int = MID_CHANNELS) -> dict:
    """Bytes the forward must move (x once, y once, weights) and FLOPs it
    must do (the four convs; mish counted as 8 operations)."""
    pix = bsz * h * w
    out_pix = {None: pix, "up": 4 * pix, "down": pix // 4}[scale]
    weights = (2 * c * cm + 18 * cm * cm) * itemsize + (3 * cm + c) * 4
    return {
        "bytes": pix * c * itemsize + out_pix * c * itemsize + weights,
        "flops": pix * (2 * (2 * c * cm + 18 * cm * cm) + 8 * (c + 3 * cm)),
    }


def cost_bwd(bsz: int, h: int, w: int, c: int, itemsize: int,
             cm: int = MID_CHANNELS) -> dict:
    """Bytes the backward must move (x and dy read once, dx written once,
    the weights read, the eight float32 gradients written) and FLOPs it
    must do: the first three convs recomputed (p1..p3; the last 1x1's
    output p4 is never needed), the data gradient of every conv (the
    first one's included, as dx needs it) and the weight gradient of
    every conv, each as many products as the forward's conv; mish,
    mish' and the masks counted as 8 + 12 operations a channel."""
    pix = bsz * h * w
    conv = 2 * (2 * c * cm + 18 * cm * cm)
    n_w = 2 * c * cm + 18 * cm * cm + 3 * cm + c
    return {
        "bytes": 3 * pix * c * itemsize + (n_w - 3 * cm - c) * itemsize
        + 3 * cm * 4 + n_w * 4,
        "flops": pix * (3 * conv - 2 * c * cm + 20 * (c + 3 * cm)),
    }
