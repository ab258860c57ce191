"""Fused 3x3 convolution with a folded-GroupNorm / mish prologue (port of
dddpm_tpu/ops/pallas/conv3x3.py), and the ResnetBlock seam it serves
(the counterpart of scripts/probe_block_fusion.py's seam).

    y = conv3x3(prologue(x), w) + b          stride 1, SAME, f32 sums
    prologue(x) = mish(x * scale + shift) [+ post_bias]   scale given
                = mish(x)                                 apply_mish
                = x                                       otherwise

`scale` and `shift` are per-(batch, channel) f32: a GroupNorm folded per
sample by `gn_fold`.  The prologue rounds to x's dtype after the mish
and again after adding `post_bias` (the time-embedding bias), so the
result matches the unfused Block -> (+ time bias) of the UNet.  SAME
padding is zero in operand space, after the prologue.  NHWC activations
and HWIO weights, the JAX package's layout.

On a CUDA tensor `conv3x3_fused` launches the hand-written kernel
(csrc/conv3x3.cu, K5) or raises; on a CPU tensor `plain` runs.  K5
takes Cin % 32 == 0 and Cout % 64 == 0; at any other width the wrapper
zero-pads the channels (ops/math.py:pad_conv_channels, exact) and slices
the padded output channels off.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops.math import mish, pad_conv_channels

GROUPS = 8
GN_EPS = 1e-5
CIN_STEP = 32     # the C entry of csrc/conv3x3.cu takes Cin % 32 == 0
COUT_STEP = 64    # and Cout % 64 == 0 (its blocks of 128 mask the rest);
                  # the wrapper pads other widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the C entry; chip_smoke.py reads it
LAUNCHES = {"conv3x3": 0}


def _per_bc(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B, C) per-(batch, channel) array, f32, broadcast over NHWC x."""
    return t.float().reshape(x.shape[0], 1, 1, x.shape[-1])


def prologue(x, *, apply_mish=False, scale=None, shift=None, post_bias=None):
    """The kernel's operand on NHWC x, rounded where the kernel rounds."""
    dt = x.dtype
    if scale is not None:
        v = mish(x.float() * _per_bc(scale, x) + _per_bc(shift, x)).to(dt)
        if post_bias is not None:
            v = (v.float() + _per_bc(post_bias, x)).to(dt)
        return v
    if apply_mish:
        return mish(x.float()).to(dt)
    return x


def plain(x, w, b, *, apply_mish=False, scale=None, shift=None,
          post_bias=None):
    """Plain PyTorch version of the kernel: the prologue, then a 3x3 SAME
    conv in f32 (operands of x's dtype widened, zero padding after the
    prologue), + b, rounded to x's dtype.  NHWC in and out."""
    a = prologue(x, apply_mish=apply_mish, scale=scale, shift=shift,
                 post_bias=post_bias)
    # on the CPU not through oneDNN, whose f32 conv, in a process that also
    # runs JAX, now and then lands ~1e-4 off (an f32 conv's sums differ by
    # ~1e-6); on a card this flag does nothing
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        y = F.conv2d(a.permute(0, 3, 1, 2).float(),
                     w.permute(3, 2, 0, 1).float(), padding=1)
    return (y.permute(0, 2, 3, 1) + b.float()).to(x.dtype).contiguous()


def _lib():
    lib = _build.load("conv3x3")
    if lib.conv3x3_fused.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_fused.argtypes = [vp] * 7 + [i] * 7 + [vp]
        lib.conv3x3_fused.restype = i
    return lib


def _kernel(x, w, b, apply_mish, scale, shift, post_bias):
    """K5 on a CUDA tensor, its channels zero-padded to CIN_STEP and
    COUT_STEP where they are not multiples of them; raises on what it
    does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout) or w.device != x.device:
        raise ValueError(f"w must be (3, 3, {cin}, Cout) on {x.device}")
    if tuple(b.shape) != (cout,) or b.device != x.device:
        raise ValueError(f"b must be ({cout},) on {x.device}")
    for t in (scale, shift, post_bias):
        if t is not None and (t.numel() != bsz * cin or t.device != x.device):
            raise ValueError(f"scale, shift, post_bias must hold ({bsz}, "
                             f"{cin}) values on {x.device}")
    if cin % CIN_STEP or cout % COUT_STEP:
        x, w, b, (scale, shift, post_bias) = pad_conv_channels(
            x, w, b, CIN_STEP, COUT_STEP, (scale, shift, post_bias))
        y = _kernel(x, w, b, apply_mish, scale, shift, post_bias)
        return y[..., :cout].contiguous()
    # mode (csrc/conv3x3.cu): 0 identity, 1 mish, 2 scale/shift, 3 with
    # post_bias; the per-(batch, channel) arrays go in f32, unused as null
    extra, mode = [], int(apply_mish)
    if scale is not None:
        extra = [t for t in (scale, shift, post_bias) if t is not None]
        extra = [_build.aligned(t.float().reshape(bsz, cin).contiguous())
                 for t in extra]
        mode = len(extra)
    extra += [None] * (3 - len(extra))
    x, wk = _build.aligned(x), _build.aligned(w.to(x.dtype).contiguous())
    bias = b.float().contiguous()
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    LAUNCHES["conv3x3"] += 1
    p = lambda t: ctypes.c_void_p(None) if t is None else _build.ptr(t)
    _build.check(lib.conv3x3_fused(p(x), p(wk), p(bias), *map(p, extra), p(y),
                                   bsz, h, wd, cin, cout, mode,
                                   _DTYPES[x.dtype], _build.stream(x)),
                 "conv3x3_fused")
    return y


def conv3x3_fused(x, w, b, *, apply_mish: bool = False, scale=None,
                  shift=None, post_bias=None) -> torch.Tensor:
    """y = conv3x3(prologue(x), w) + b on NHWC x (B, H, W, Cin), w (3, 3,
    Cin, Cout), b (Cout,); scale, shift, post_bias (B, Cin).  A CPU
    tensor takes `plain`; a CUDA tensor launches K5 or raises."""
    if post_bias is not None and scale is None:
        raise ValueError("post_bias requires scale and shift")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if x.device.type == "cpu":
        return plain(x, w, b, apply_mish=apply_mish, scale=scale, shift=shift,
                     post_bias=post_bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _kernel(x, w, b, apply_mish, scale, shift, post_bias)


def gn_fold(x, g, b, groups: int = GROUPS, eps: float = GN_EPS) -> tuple:
    """GroupNorm statistics of NHWC x folded into per-(batch, channel)
    f32 (scale, shift): GN(x) * g + b == x * scale + shift."""
    bsz, h, w, c = x.shape
    xf = x.float().reshape(bsz, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3))                                   # (B, G)
    var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
    rep = c // groups
    scale = torch.rsqrt(var + eps).repeat_interleave(rep, dim=1) * g.float()
    shift = b.float() - mean.repeat_interleave(rep, dim=1) * scale
    return scale, shift


def gn_mish(x, g, b, groups: int = GROUPS, eps: float = GN_EPS):
    """The Block's tail on NHWC x: f32 GroupNorm, mish, rounded to x's dtype."""
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), groups, g.float(),
                     b.float(), eps)
    return mish(y).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def seam_plain(x, p: dict) -> torch.Tensor:
    """A ResnetBlock's inner seam, unfused: conv1 -> GN+mish -> + time bias
    -> conv2 -> GN+mish.  p: w1, b1, g1, be1, tb (B, C) of x's dtype, w2,
    b2, g2, be2."""
    c1 = plain(x, p["w1"], p["b1"])
    h = gn_mish(c1, p["g1"], p["be1"]) + p["tb"].to(x.dtype)[:, None, None, :]
    return gn_mish(plain(h, p["w2"], p["b2"]), p["g2"], p["be2"])


def seam_fused(x, p: dict) -> torch.Tensor:
    """The same seam with conv2 through `conv3x3_fused`: GN1's statistics
    folded into the prologue's scale/shift, the time bias as post_bias,
    so the activated tensor is never formed."""
    c1 = plain(x, p["w1"], p["b1"])
    scale, shift = gn_fold(c1, p["g1"], p["be1"])
    c2 = conv3x3_fused(c1, p["w2"], p["b2"], scale=scale, shift=shift,
                       post_bias=p["tb"])
    return gn_mish(c2, p["g2"], p["be2"])


def cost(bsz: int, h: int, w: int, cin: int, cout: int, itemsize: int,
         prologue_arrays: int = 0) -> dict:
    """Bytes K5 must move (x once, y once, w, b and the per-(batch,
    channel) prologue arrays) and FLOPs it must do (the 9 taps; the
    prologue's few operations a value are not counted)."""
    pix = bsz * h * w
    return {"bytes": pix * (cin + cout) * itemsize + 9 * cin * cout * itemsize
            + cout * 4 + prologue_arrays * bsz * cin * 4,
            "flops": pix * 2 * 9 * cin * cout}
