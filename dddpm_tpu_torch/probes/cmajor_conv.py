"""P4: a 3x3 SAME conv, 32 -> 32 channels, in channel-major layout on
the card (counterpart of scripts/probe_cmajor_conv.py), through
csrc/probe_cmajor_conv.cu.

x is (B, C, H, W); wmat is (co, 9 * ci) with columns in (ky, kx, ci)
order, the probe's; products of bf16 values summed in f32, y rounded to
bf16.

    python -m dddpm_tpu_torch.probes.cmajor_conv [--bs 32] [--res 256]

It needs a card.  First main() shows, on its own inputs, that the check
fails two tap-shift faults (wmat's kx taps mirrored, the band read one
row off).  Then the kernel is held against its plain version (TOL of
the larger of 1 and the output's largest magnitude: sums in another
order, then one bf16 rounding) before it is timed; its error against an
f32 conv with the unrounded weights, what the TPU probe printed, is
printed too.  Library rows: cuDNN's bf16 F.conv2d on NCHW and on
channels_last.
"""
from __future__ import annotations

import argparse
import ctypes

import torch
import torch.nn.functional as F

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.probes import _util

CHANNELS = 32
TOL = 1e-2

# launches of the C entry; chip_smoke.py reads this
LAUNCHES = {"probe_cmajor_conv": 0}


def to_wmat(w):
    """HWIO weights (3, 3, ci, co) -> (co, 9 * ci), columns (ky, kx, ci)."""
    co = w.shape[-1]
    return w.permute(3, 0, 1, 2).reshape(co, -1)


def plain(x, wmat):
    """Plain version on channel-major x: the conv of x and wmat rounded to
    x's dtype, in f32, rounded to x's dtype."""
    co, ci = wmat.shape[0], x.shape[1]
    w = wmat.to(x.dtype).float().reshape(co, 3, 3, ci).permute(0, 3, 1, 2)
    return F.conv2d(x.float(), w, padding=1).to(x.dtype)


def inputs(bsz: int, res: int, gen: torch.Generator):
    """main()'s inputs on gen's device: x (bsz, 32, res, res) bf16, the HWIO
    weights w (f32, N(0, 1 / (9 * 32))) and wmat = to_wmat(w) in bf16."""
    c, dev = CHANNELS, gen.device
    x = torch.randn((bsz, c, res, res), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, c, c), generator=gen, device=dev) / (9 * c) ** 0.5
    return x, w, to_wmat(w).to(torch.bfloat16).contiguous()


def mirrored_kx(wmat):
    """wmat with its kx taps mirrored (kx 0 <-> 2): a conv whose band is
    shifted the wrong way in x."""
    co, k = wmat.shape
    return wmat.reshape(co, 3, 3, k // 9).flip(2).reshape(co, k)


def rows_off(x):
    """x moved up one row, zero below: a conv of it reads the band one row
    off."""
    return F.pad(x[:, :, 1:], (0, 0, 0, 1))


def check_sees_faults(x, wmat) -> tuple:
    """Raises unless, on these inputs, the check at TOL fails the plain
    conv with wmat's kx taps mirrored and the one that reads the band one
    row off; returns their two errors."""
    want = plain(x, wmat)
    tol = _util.scaled_tol(want, TOL)
    return (_util.check_fails("kx taps mirrored", plain(x, mirrored_kx(wmat)), want, tol),
            _util.check_fails("band one row off", plain(rows_off(x), wmat), want, tol))


def kernel(x, wmat):
    """probe_cmajor_conv on a CUDA bf16 (B, 32, H, W) x."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bfloat16, got {x.dtype}")
    if x.ndim != 4 or x.shape[1] != CHANNELS or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, {CHANNELS}, H, W) tensor")
    if tuple(wmat.shape) != (CHANNELS, 9 * CHANNELS) or wmat.device != x.device:
        raise ValueError(f"wmat must be ({CHANNELS}, {9 * CHANNELS}) on {x.device}")
    wm = wmat.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    bsz, _, h, w = x.shape
    lib = _build.load("probe_cmajor_conv")
    if lib.probe_cmajor_conv.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_cmajor_conv.argtypes = [vp] * 3 + [i] * 3 + [vp]
        lib.probe_cmajor_conv.restype = i
    LAUNCHES["probe_cmajor_conv"] += 1
    _build.check(lib.probe_cmajor_conv(_build.ptr(x), _build.ptr(wm), _build.ptr(y),
                                       bsz, h, w, _build.stream(x)),
                 "probe_cmajor_conv")
    return y


def cmajor_conv(x, wmat):
    """The conv: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return plain(x, wmat)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return kernel(x, wmat)


def cost(bsz: int, h: int, w: int, c: int = CHANNELS, itemsize: int = 2) -> dict:
    """x read and y written once, wmat read; 9 * c * c products a pixel."""
    pix = bsz * h * w
    return {"bytes": 2 * pix * c * itemsize + 9 * c * c * itemsize,
            "flops": pix * 2 * 9 * c * c}


def main(argv=None) -> dict:
    """Checks, then times, the kernel and the two cuDNN rows; returns the
    kernel's numbers (ms, plain_ms, library_ms = cuDNN on NCHW,
    library_cl_ms = cuDNN on channels_last, max_abs_err, cost) under its
    name."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--res", type=int, default=256)
    args = p.parse_args(argv)
    _util.require_card()
    torch.backends.cudnn.allow_tf32 = False
    bs, res, c = args.bs, args.res, CHANNELS
    x, w, wmat = inputs(bs, res, torch.Generator(device="cuda").manual_seed(0))
    cst = cost(bs, res, res)
    bnd, by = _util.bound_ms(cst)
    print(f"P4 channel-major 3x3 conv: B={bs} C={c} {res}x{res} bf16, bound "
          f"{bnd:.4f} ms ({by}) [{_util.card_line()}]")
    with torch.no_grad():
        errs = check_sees_faults(x, wmat)
        print(f"  the check fails kx taps mirrored (max abs err {errs[0]:.3e}) and "
              f"the band one row off ({errs[1]:.3e})")
        want = plain(x, wmat)
        got = kernel(x, wmat)
        err = _util.check("cmajor conv", got, want, _util.scaled_tol(want, TOL))
        ref = F.conv2d(x.float(), w.permute(3, 2, 0, 1), padding=1)
        err_f32 = float((got.float() - ref).abs().max())
        print(f"  max abs err: {err:.3e} vs its plain version, {err_f32:.3e} vs "
              f"an f32 conv with unrounded weights (the TPU probe's check)")
        del want, got, ref
        time = lambda fn: _util.cuda_ms(fn, iters=10, reps=3)
        w_oihw = wmat.reshape(c, 3, 3, c).permute(0, 3, 1, 2).contiguous()
        x_cl = x.contiguous(memory_format=torch.channels_last)
        w_cl = w_oihw.contiguous(memory_format=torch.channels_last)
        ms = time(lambda: kernel(x, wmat))
        plain_ms = time(lambda: plain(x, wmat))
        nchw_ms = time(lambda: F.conv2d(x, w_oihw, padding=1))
        cl_ms = time(lambda: F.conv2d(x_cl, w_cl, padding=1))
    for name, t in (("cmajor kernel", ms), ("plain version (f32 conv)", plain_ms),
                    ("cuDNN F.conv2d bf16 NCHW", nchw_ms),
                    ("cuDNN F.conv2d bf16 channels_last", cl_ms)):
        print(_util.row(name, t, cst))
    return {"probe_cmajor_conv": dict(ms=ms, plain_ms=plain_ms, library_ms=nchw_ms,
                                      library_cl_ms=cl_ms, max_abs_err=err, cost=cst)}


if __name__ == "__main__":
    main()
