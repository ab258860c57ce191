"""Winograd F(2x2, 3x3) 3x3 convolution (port of dddpm_tpu/ops/winograd.py
and dddpm_tpu/ops/pallas/winograd.py).

Each 2x2 output tile of a stride-1 'SAME' 3x3 convolution is

    Y = A^T [ (G g G^T) * (B^T d B) ] A

with d the overlapping 4x4 input tile (Lavin & Gray): 4 products a
pixel per input channel instead of 9.  The transforms are exact in f32
(entries 1, +-0.5).  NHWC activations and HWIO weights, the JAX
package's layout.

- `transform_weights` and `conv3x3_winograd_ref`: the f32 tiling
  reference (the counterparts of the JAX module's).
- `conv3x3_winograd`: on a CUDA tensor the hand-written kernel
  (csrc/winograd.cu, K6: its 16 products on the tensor cores, bf16
  operands and f32 sums); on a CPU tensor `plain`, which repeats the
  kernel's roundings: the transformed input tiles V = B^T d B and the
  transformed weights U = G g G^T are rounded to bf16 (whatever x's
  dtype, as the TPU kernel feeds its matrix unit), the 16 products sum
  in f32, and the inverse transform, the bias and the rounding to x's
  dtype follow in f32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops.math import mish, pad_conv_channels

# B^T: input transform; G: filter transform; A^T: output transform
BT = np.array([[1, 0, -1, 0],
               [0, 1, 1, 0],
               [0, -1, 1, 0],
               [0, 1, 0, -1]], np.float32)
G = np.array([[1, 0, 0],
              [0.5, 0.5, 0.5],
              [0.5, -0.5, 0.5],
              [0, 0, 1]], np.float32)
AT = np.array([[1, 1, 1, 0],
               [0, 1, -1, -1]], np.float32)

# CK in csrc/winograd.cu: input channels per stage, one mma k step
CIN_STEP = 16
# the Cout granule the C entry takes; a block's 64 output channels mask
# the channels past Cout.  The wrapper zero-pads other widths
# (ops/math.py:pad_conv_channels, exact) and slices the output
COUT_STEP = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the conv and of the weight transform; chip_smoke.py reads it
LAUNCHES = {"winograd": 0, "winograd_weights": 0}


_G_ON: dict = {}


def _g_on(device: torch.device) -> torch.Tensor:
    """G on `device`, copied there once: a copy from pageable host memory
    would wait on the device at every call (and cannot be captured in a
    CUDA graph)."""
    g = _G_ON.get(device)
    if g is None:
        g = _G_ON[device] = torch.from_numpy(G).to(device)
    return g


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (4, 4, Cin, Cout) f32: U = G g G^T per channel."""
    g = _g_on(w.device)
    u = torch.einsum("ij,jkcf->ikcf", g, w.float())
    return torch.einsum("ikcf,lk->ilcf", u, g)


def _tiles(xf: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the overlapping 4x4 tiles of the zero-padded input,
    (B, 4, 4, H/2, W/2, C): tile (m, n) covers image rows 2m-1..2m+2 and
    columns 2n-1..2n+2.  H and W must be even."""
    _, h, wd, _ = xf.shape
    if h % 2 or wd % 2:
        raise ValueError(f"H and W must be even, got {h}x{wd}")
    xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
    th, tw = h // 2, wd // 2
    d = torch.stack([xp[:, i:i + 2 * th:2] for i in range(4)], dim=1)
    return torch.stack([d[:, :, :, j:j + 2 * tw:2] for j in range(4)], dim=2)


def _untile(y: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2, H/2, W/2, C) output tiles -> (B, H, W, C)."""
    bsz, _, _, th, tw, c = y.shape
    return y.permute(0, 3, 1, 4, 2, 5).reshape(bsz, 2 * th, 2 * tw, c)


def conv3x3_winograd_ref(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor | None = None) -> torch.Tensor:
    """The Winograd conv by the transform matrices, f32 throughout (SAME
    padding).  x: (B, H, W, Cin) with H, W even; w: (3, 3, Cin, Cout)."""
    bt, at = (torch.from_numpy(m).to(x.device) for m in (BT, AT))
    u = transform_weights(w)
    d = _tiles(x.float())
    v = torch.einsum("ij,bjkmnc->bikmnc", bt, d)
    v = torch.einsum("bikmnc,lk->bilmnc", v, bt)
    m = torch.einsum("bijmnc,ijcf->bijmnf", v, u)
    y = torch.einsum("pi,bijmnf->bpjmnf", at, m)
    y = _untile(torch.einsum("bpjmnf,qj->bpqmnf", y, at))
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _bt(t: torch.Tensor, dim: int) -> torch.Tensor:
    """B^T along `dim` (of size 4), the kernel's sums in its order."""
    d0, d1, d2, d3 = t.unbind(dim)
    return torch.stack([d0 - d2, d1 + d2, d2 - d1, d1 - d3], dim=dim)


def _at(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A^T along `dim` (of size 4 -> 2), the kernel's sums in its order."""
    m0, m1, m2, m3 = t.unbind(dim)
    return torch.stack([m0 + m1 + m2, m1 - m2 - m3], dim=dim)


def plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          apply_mish: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its roundings: the input
    in f32 (mish in f32 when asked, not rounded), V = B^T d B (rows, then
    columns) and U = transform_weights(w) rounded to bf16, the products
    summed in f32, A^T M A in f32, + b, rounded to x's dtype."""
    xf = x.float()
    if apply_mish:
        xf = mish(xf)
    v = _bt(_bt(_tiles(xf), 1), 2).to(torch.bfloat16).float()
    u = transform_weights(w).to(torch.bfloat16).float()
    m = torch.einsum("bijmnc,ijcf->bijmnf", v, u)
    y = _untile(_at(_at(m, 1), 2)) + b.float()
    return y.to(x.dtype)


def library(defines=()):
    """csrc/winograd.cu's library (built with `defines`, see _build.load),
    its C entries typed."""
    lib = _build.load("winograd", tuple(defines))
    if lib.winograd_conv.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.winograd_conv.argtypes = [vp] * 4 + [i] * 7 + [vp]
        lib.winograd_conv.restype = i
        lib.winograd_weights.argtypes = [vp, vp, i, i, i, vp]
        lib.winograd_weights.restype = i
    return lib


def weights_kernel(w: torch.Tensor) -> torch.Tensor:
    """transform_weights(w) rounded to bf16, as (16, Cin, Cout), by one
    launch on w's card (the f32 sums in transform_weights' order)."""
    cin, cout = w.shape[2], w.shape[3]
    wt = (w if w.dtype in _DTYPES else w.float()).contiguous()
    u = torch.empty((16, cin, cout), dtype=torch.bfloat16, device=w.device)
    LAUNCHES["winograd_weights"] += 1
    _build.check(library().winograd_weights(_build.ptr(wt), _build.ptr(u), cin,
                                         cout, _DTYPES[wt.dtype],
                                         _build.stream(w)), "winograd_weights")
    return u


def _kernel(x, w, b, apply_mish):
    """K6 on a CUDA tensor (the weight transform, then the conv), its
    channels zero-padded to CIN_STEP and COUT_STEP where they are not
    multiples of them; raises on what it does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if h % 2 or wd % 2:
        raise ValueError(f"H and W must be even, got {h}x{wd}")
    if tuple(w.shape) != (3, 3, cin, cout) or w.device != x.device:
        raise ValueError(f"w must be (3, 3, {cin}, Cout) on {x.device}")
    if tuple(b.shape) != (cout,) or b.device != x.device:
        raise ValueError(f"b must be ({cout},) on {x.device}")
    if cin % CIN_STEP or cout % COUT_STEP:
        x, w, b, _ = pad_conv_channels(x, w, b, CIN_STEP, COUT_STEP)
        return _kernel(x, w, b, apply_mish)[..., :cout].contiguous()
    lib = library()
    p = _build.ptr
    u = weights_kernel(w)
    bias = b.float().contiguous()
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    LAUNCHES["winograd"] += 1
    _build.check(lib.winograd_conv(p(x), p(u), p(bias), p(y), bsz, h, wd, cin,
                                   cout, int(apply_mish), _DTYPES[x.dtype],
                                   _build.stream(x)), "winograd_conv")
    return y


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     apply_mish: bool = False) -> torch.Tensor:
    """Winograd 3x3 'SAME' conv of mish(x) (apply_mish) or x: x (B, H, W,
    Cin) with H and W even, w (3, 3, Cin, Cout), b (Cout,).  A CPU
    tensor takes `plain`; a CUDA tensor launches K6 or raises."""
    if x.device.type == "cpu":
        return plain(x, w, b, apply_mish)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _kernel(x, w, b, apply_mish)


def cost(bsz: int, h: int, w: int, cin: int, cout: int, itemsize: int) -> dict:
    """Bytes K6 must move (x once, y once, U in bf16 and b) and the
    operations of Winograd's own products: 16 (Cin x Cout) products per
    2x2 tile, 8 Cin Cout FLOPs a pixel (the transforms, ~0.5% more, are
    not counted)."""
    pix = bsz * h * w
    return {"bytes": pix * (cin + cout) * itemsize + 16 * cin * cout * 2
            + cout * 4,
            "flops": pix * 8 * cin * cout}
