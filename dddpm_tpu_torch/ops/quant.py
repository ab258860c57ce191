"""Int8 (W8A8) quantized 3x3 convolution for the serving path (port of
dddpm_tpu/ops/quant.py).

An opt-in mode for sampling only (config["conv_quant"] = "int8",
generate_main --quant-conv int8), with no gradient:

- weights: symmetric per-output-channel s8, quantized from the float32
  parameters (`quantize_weight`; the module caches the result, so a
  sampling chain quantizes each weight once);
- activations: symmetric per-tensor s8 with a static scale from a
  calibrated absmax (`act_scale_from_amax`, `quantize_act`), which the
  module holds as a buffer and calibration raises with `observed_amax`;
- the product: s8 x s8 with exact integer sums, dequantized as
  float(acc) * (xs * ws[c]) in f32.  A skip operand (the UNet's
  concat-free skip connection) is quantized with its own scales and its
  dequantized result added in f32; the sum is rounded to x's dtype once.

`quant_conv_wins` is the JAX package's shape gate, kept as it is: it
decides which convs are quantized, and so what the model computes.

On a CUDA tensor `int8_conv` launches the hand-written kernel
(csrc/int8_conv.cu, Q1) or raises; on a CPU tensor `plain` runs.  Both
compute the same integers and round the same way (IEEE division,
round-half-to-even, one f32 multiply by the scale product formed first,
one f32 add, one rounding to x's dtype), so they agree bit for bit.
NCHW tensors, OIHW weights.  Q1 reads each operand in place, whether it
is NCHW-contiguous (what a Block's GroupNorm -> mish hands the next
conv) or channels_last, and writes y NCHW-contiguous, which the Block's
GroupNorm reads without a copy; `plain` returns the same format.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dddpm_tpu_torch.ops import _build

CIN_STEP = 32     # the packed weights' K: Cin rounded up to one k32 step
NPAD_STEP = 128   # the packed weights' rows: Cout rounded up to a wgmma n128 tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the C entry; chip_smoke.py reads it
LAUNCHES = {"int8_conv": 0}


def quant_conv_wins(kk: int, spatial: int, cin: int, cout: int,
                    stride: int = 1) -> bool:
    """The JAX package's gate (dddpm_tpu/ops/quant.py:quant_conv_wins):
    a conv is quantized when it is stride 1, keeps its width
    (cin == cout), has at least 128 channels and a 2x2 or 3x3 kernel.
    `spatial` is not read."""
    del spatial
    return (stride == 1 and cin == cout and cin >= 128
            and kk in (2, 3))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in f32 by IEEE division on every device: a
    Python-number divisor would make a CUDA tensor multiply by the
    rounded reciprocal, which is 1 ulp off for ~5% of amax values."""
    a = torch.clamp_min(amax.float(), 1e-12)
    return a / torch.full_like(a, 127.0)


def quantize_weight(w: torch.Tensor):
    """(wq int8 OIHW, scale f32 (Cout,)): symmetric per-output-channel s8
    of an OIHW kernel, its scale amax / 127 with amax floored at 1e-12."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=(1, 2, 3)))
    wq = torch.clamp(torch.round(wf / scale[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), scale


def act_scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    return _scale(amax)


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor s8 with a given scale: round half to even."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def observed_amax(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The running absmax calibration keeps (on x's device, no sync)."""
    return torch.maximum(prev.float(), x.float().abs().amax())


class QWeight(NamedTuple):
    """A quantized 3x3 kernel: `wq` (Cout, Cin, 3, 3) int8, `ws` (Cout,)
    f32, and `packed`, the kernel's layout: int8 (9, Kpad / 32, Npad / 8,
    2, 8, 16), Kpad = Cin rounded up to CIN_STEP and Npad = Cout rounded
    up to NPAD_STEP, with zero columns and rows; per tap and 32 input
    channels, the 8-row x 16-byte core matrices of wgmma's K-major B
    operand (csrc/int8_conv.cu)."""
    wq: torch.Tensor
    ws: torch.Tensor
    packed: Optional[torch.Tensor]


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """An OIHW int8 kernel in Q1's packed layout (see QWeight)."""
    cout, cin = wq.shape[:2]
    npad = -(-cout // NPAD_STEP) * NPAD_STEP
    kpad = -(-cin // CIN_STEP) * CIN_STEP
    taps = torch.zeros((9, npad, kpad), dtype=torch.int8, device=wq.device)
    taps[:, :cout, :cin] = wq.permute(2, 3, 0, 1).reshape(9, cout, cin)
    return (taps.reshape(9, npad // 8, 8, kpad // 32, 2, 16)
            .permute(0, 3, 1, 4, 2, 5).contiguous())


def prepare_weight(w: torch.Tensor) -> QWeight:
    wq, ws = quantize_weight(w)
    return QWeight(wq, ws, pack_weight(wq))


def _dequant_plain(x, qw: QWeight, amax) -> torch.Tensor:
    """float(conv(s8 x, s8 w)) * (xs * ws), f32 NCHW.  The integer sums
    run in float64, exact while |acc| < 2^53 (here < 2^31), with oneDNN
    and cuDNN off so that no transform-based algorithm is picked."""
    xs = act_scale_from_amax(amax)
    xq = quantize_act(x, xs)
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None), \
            torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.double(), qw.wq.double(), padding=1)
    return acc.float() * (xs * qw.ws)[None, :, None, None]


def plain(x, qw: QWeight, amax, skip=None, qw_skip: Optional[QWeight] = None,
          amax_skip=None, bias=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the JAX package's order:
    each operand's dequantized f32 product, their f32 sum, rounded to
    x's dtype, then + bias rounded to x's dtype."""
    y = _dequant_plain(x, qw, amax)
    if skip is not None:
        y = y + _dequant_plain(skip, qw_skip, amax_skip)
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)[None, :, None, None]
    return y.contiguous()


def bind(lib):
    """Q1's library with its C entry's argument types set."""
    if lib.int8_conv.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_conv.argtypes = [vp] * 10 + [i] * 8 + [vp]
        lib.int8_conv.restype = i
    return lib


def _lib():
    return bind(_build.load("int8_conv"))


def _layout(t: torch.Tensor) -> int:
    """Q1's layout code of an operand (B, C, H, W): 1 when it is
    NCHW-contiguous, 0 when it is channels_last; raises on any other
    strides.  Q1 reads either in place."""
    if t.is_contiguous():
        return 1
    if t.is_contiguous(memory_format=torch.channels_last):
        return 0
    raise ValueError(f"kernel takes NCHW-contiguous or channels_last "
                     f"operands, got strides {t.stride()}")


def _in_place(t: torch.Tensor) -> bool:
    """Whether Q1's TMA reads t as it lies: 16-byte aligned, and its
    rows (NCHW: W values) or pixels (channels_last: C values) a
    multiple of 16 bytes."""
    row = t.shape[3] if _layout(t) else t.shape[1]
    return t.data_ptr() % 16 == 0 and row * t.element_size() % 16 == 0


def _readable(ts: list) -> list:
    """The operands as Q1 reads them: each itself where its TMA can read
    it in place, else a channels_last copy; where C x the element size
    is not a multiple of 16 bytes (no channels_last pixel pitch the TMA
    takes) and an operand is not in place, every operand is copied
    channels_last with its channels zero-padded to a 16-byte pixel (the
    pad meets the packed weights' zero columns), so that they share one
    channel count.  Of a model's shapes only a bf16 NCHW map of W % 8
    != 0 is copied: a 32^2 DDPM with dims (1, 2, 2, 2) has 256 -> 256
    convs at 4^2, rows of 8 bytes."""
    c, es = ts[0].shape[1], ts[0].element_size()
    if c * es % 16 == 0:
        return [t if _in_place(t) else
                torch.empty_like(t, memory_format=torch.channels_last).copy_(t)
                for t in ts]
    if all(_in_place(t) for t in ts):
        return ts
    cpad = -(-c * es // 16) * 16 // es
    out = []
    for t in ts:
        b, _, h, w = t.shape
        v = torch.zeros((b, h, w, cpad), dtype=t.dtype,
                        device=t.device).permute(0, 3, 1, 2)
        v[:, :c].copy_(t)
        out.append(v)
    return out


def _kernel(x, qw, amax, skip, qw_skip, amax_skip, bias):
    """Q1 on CUDA tensors; raises on what it does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError("x must be (B, C, H, W)")
    bsz, cin, h, w = x.shape
    cout = qw.ws.numel()
    operands = [(x, qw, amax)]
    if skip is not None:
        if skip.shape != x.shape or skip.dtype != x.dtype:
            raise ValueError(f"skip must match x: {tuple(skip.shape)} "
                             f"{skip.dtype} vs {tuple(x.shape)} {x.dtype}")
        operands.append((skip, qw_skip, amax_skip))
    npad = -(-cout // NPAD_STEP) * NPAD_STEP
    want = (9, -(-cin // CIN_STEP), npad // 8, 2, 8, 16)
    for v, q, a in operands:
        if v.device != x.device:
            raise ValueError(f"operands on {v.device} and {x.device}")
        if q.packed is None or tuple(q.packed.shape) != want or \
                q.packed.dtype != torch.int8 or not q.packed.is_contiguous():
            raise ValueError(f"weights must be packed {want} int8 (prepare_weight)")
        for t in (q.packed, q.ws, a):
            if t.device != x.device:
                raise ValueError(f"weights and amax must be on {x.device}")
        if a.numel() != 1 or a.dtype != torch.float32:
            raise ValueError("amax must be one float32 value")
    if bias is not None and (bias.numel() != cout or bias.device != x.device):
        raise ValueError(f"bias must hold {cout} values on {x.device}")
    xs = _readable([v for v, _, _ in operands])
    layouts = [_layout(v) for v in xs]
    packed = [q.packed for _, q, _ in operands]
    ws = [q.ws.float().contiguous() for _, q, _ in operands]
    amaxes = [a.reshape(1).contiguous() for _, _, a in operands]
    y = torch.empty((bsz, cout, h, w), dtype=x.dtype, device=x.device)
    bias_f = None if bias is None else bias.float().contiguous()
    p = lambda t: ctypes.c_void_p(None) if t is None else _build.ptr(t)
    sk = (lambda lst: p(lst[1]) if len(lst) > 1 else ctypes.c_void_p(None))
    lib = _lib()
    LAUNCHES["int8_conv"] += 1
    _build.check(lib.int8_conv(
        p(xs[0]), p(packed[0]), p(ws[0]), p(amaxes[0]),
        sk(xs), sk(packed), sk(ws), sk(amaxes), p(bias_f), p(y),
        bsz, h, w, xs[0].shape[1], cout, _DTYPES[x.dtype], layouts[0],
        layouts[-1] if len(layouts) > 1 else 0, _build.stream(x)),
        "int8_conv")
    return y


class _Int8Conv(torch.autograd.Function):
    """Forward only: the JAX path has no VJP (round's derivative is 0
    almost everywhere), so the backward raises."""

    @staticmethod
    def forward(ctx, x, qw, amax, skip, qw_skip, amax_skip, bias):
        if x.device.type == "cpu":
            return plain(x, qw, amax, skip, qw_skip, amax_skip, bias)
        return _kernel(x, qw, amax, skip, qw_skip, amax_skip, bias)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the int8 conv has no gradient: it is a "
                           "sampling / serving mode")


def int8_conv_q(x, qw: QWeight, amax, skip=None,
                qw_skip: Optional[QWeight] = None, amax_skip=None,
                bias=None) -> torch.Tensor:
    """The W8A8 3x3 SAME stride-1 conv on prepared weights: NCHW x (B,
    Cin, H, W) in f32 or bf16, `amax` a one-value f32 tensor on x's
    device; optional skip operand (x's shape) with its own weights and
    amax, and a (Cout,) bias added after the rounding to x's dtype.
    Operands may be NCHW-contiguous or channels_last, each its own; the
    result (B, Cout, H, W) in x's dtype is NCHW-contiguous.  A CPU
    tensor takes `plain`; a CUDA tensor launches Q1 or raises."""
    if (skip is None) != (qw_skip is None) or (skip is None) != (amax_skip is None):
        raise ValueError("skip, qw_skip and amax_skip come together")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return _Int8Conv.apply(x, qw, amax, skip, qw_skip, amax_skip, bias)


def int8_conv(x, w, act_amax, skip=None, w_skip=None, amax_skip=None,
              bias=None) -> torch.Tensor:
    """`int8_conv_q` on float OIHW kernels, quantized here (the module
    caches them instead)."""
    return int8_conv_q(x, prepare_weight(w), act_amax, skip,
                       None if w_skip is None else prepare_weight(w_skip),
                       amax_skip, bias)


def cost(bsz: int, h: int, w: int, cin: int, cout: int, itemsize: int,
         operands: int = 1) -> dict:
    """Bytes Q1 must move (each operand's x once in its dtype, its s8
    weights and f32 scales, y once) and the s8 operations it must do
    (2 x 9 x Cin x Cout a pixel, per operand)."""
    pix = bsz * h * w
    return {"bytes": operands * (pix * cin * itemsize + 9 * cin * cout
                                 + cout * 4 + 4) + pix * cout * itemsize,
            "flops": operands * pix * 2 * 9 * cin * cout}
