"""P3: where the fused ConvResBlock forward spends its time on the card
(counterpart of scripts/probe_convres_variants.py): the forward with
one cost removed or changed at a time, through csrc/probe_convres.cu
(K2's bf16 tensor-core design, csrc/convres_fwd.cu), residual on, no
scaling, cio 64, cm 32.

  base      masks per element, im2col, mish in f32, TH = 8 rows a tile
            (the TPU probe's base, whose tile was 16 rows)
  rowmask   one mask predicate a pixel, K2's: zero selected at
            out-of-image rows
  nomask    no mask (WRONG at the top and bottom borders, as the
            probe's: halo rows keep mish(b1 ...), halo columns stay zero)
  ninedot   rowmask, with nine accumulated taps in place of im2col:
            K2's own route at this shape
  bf16mish  rowmask, with mish on bf16 pairs (other numerics, as the
            probe's)
  tile2x    rowmask, with 2 * TH = 16 rows a tile (the probe's th32)
  kitchen   nomask + ninedot + bf16mish + tile2x
What each removes in the kernel's terms, and the second changes that
shared memory forces (the im2col stage carved from the x band; one
group of warps a block at 16 rows), are in the source's note.

    python -m dddpm_tpu_torch.probes.convres_variants [--bs 32] [--res 256]

It needs a card.  It prints the shipped K2 (ops/convres.py:
fused_convres_block, residual, no scaling) at the same shape, then
every variant with its ratio to that K2, each held before it is timed
against the plain version of the same (wrong or bf16) function on the
full input: within TOL of the larger of 1 and the output's largest
magnitude (intermediates rounded to bf16 in other places, sums in other
orders), TOL_BF16_MISH for the bf16-mish variants (their approximate
transcendentals move some of the roundings an ulp).  The residual x
dominates that magnitude, so b1 and b2 are shifted by +1: unmasked halo
rows then hold mish(~1), and main() shows on its own inputs, before the
variants, that the masked variants' check fails the unmasked output.
"""
from __future__ import annotations

import argparse
import ctypes

import torch
import torch.nn.functional as F

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import convres as cr
from dddpm_tpu_torch.ops.math import mish
from dddpm_tpu_torch.probes import _util

CIO, CM = 64, 32
# name: (mask, conv, mish, rows a tile / TH); kernel code = position
VARIANTS = {"base": ("full", "im2col", "f32", 1),
            "rowmask": ("row", "im2col", "f32", 1),
            "nomask": ("none", "im2col", "f32", 1),
            "ninedot": ("row", "ninedot", "f32", 1),
            "bf16mish": ("row", "im2col", "bf16", 1),
            "tile2x": ("row", "im2col", "f32", 2),
            "kitchen": ("none", "ninedot", "bf16", 2)}
TOL = 3e-2
TOL_BF16_MISH = 6e-2

# launches of the C entry; chip_smoke.py reads this
LAUNCHES = {"probe_convres": 0}


def _mish_in(v, dt, bf16_mish: bool):
    """mish rounded to dt: computed in f32, or on dt data op by op."""
    if bf16_mish:
        v = v.to(dt)
        return v * torch.tanh(F.softplus(v))
    return mish(v.float()).to(dt)


def plain(x, w1, b1, w2, b2, w3, b3, w4, b4, variant: str = "base"):
    """Plain version of `variant` on NHWC x (what probe_convres computes),
    any dtype: the block on x padded with 2 zero rows above and below,
    its 3x3 convs VALID over those rows and SAME over the columns, with
    m1 and m2 zeroed at out-of-image rows unless the variant has no mask.
    Weights HWIO, rounded to x's dtype; products summed in f32."""
    mask, _, mish_dt, _ = VARIANTS[variant]
    dt = x.dtype
    bsz, h, w, c = x.shape
    cm = w1.shape[-1]
    m = lambda v: _mish_in(v, dt, mish_dt == "bf16")
    rows = torch.arange(-2, h + 2, device=x.device)
    inside = ((rows >= 0) & (rows < h)).to(dt)[None, :, None, None]

    def conv(v, wt, bias):
        y = F.conv2d(v.permute(0, 3, 1, 2).float(),
                     wt.to(dt).float().permute(3, 2, 0, 1), padding=(0, 1))
        return y.permute(0, 2, 3, 1) + bias

    xp = F.pad(x, (0, 0, 0, 0, 2, 2))
    m1 = m(m(xp).float() @ w1.reshape(c, cm).to(dt).float() + b1)
    if mask != "none":
        m1 = m1 * inside
    m2 = m(conv(m1, w2, b2))
    if mask != "none":
        m2 = m2 * inside[:, 1:-1]
    m3 = m(conv(m2, w3, b3))
    y = m3.float() @ w4.reshape(cm, c).to(dt).float() + b4
    return (y + x.float()).to(dt)


def _lib():
    lib = _build.load("probe_convres")
    if lib.probe_convres.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_convres.argtypes = [vp] * 10 + [i] * 4 + [vp]
        lib.probe_convres.restype = i
    return lib


def kernel(x, w1, b1, w2, b2, w3, b3, w4, b4, variant: str = "base"):
    """probe_convres: `variant` on a CUDA bf16 NHWC x with 64 channels."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bfloat16, got {x.dtype}")
    if x.ndim != 4 or x.shape[-1] != CIO or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor of {CIO} channels")
    shapes = {"w1": (w1, (1, 1, CIO, CM)), "w2": (w2, (3, 3, CM, CM)),
              "w3": (w3, (3, 3, CM, CM)), "w4": (w4, (1, 1, CM, CIO)),
              "b1": (b1, (CM,)), "b2": (b2, (CM,)), "b3": (b3, (CM,)),
              "b4": (b4, (CIO,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want or t.device != x.device:
            raise ValueError(f"{name} must be {want} on {x.device}")
    bsz, h, w, _ = x.shape
    ws = [t.to(x.dtype).contiguous() for t in (w1, w2, w3, w4)]
    bs = [t.float().contiguous() for t in (b1, b2, b3, b4)]
    y = torch.empty_like(x)
    p = _build.ptr
    lib = _lib()
    LAUNCHES["probe_convres"] += 1
    _build.check(lib.probe_convres(
        p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]), p(bs[2]), p(ws[3]),
        p(bs[3]), p(y), bsz, h, w, list(VARIANTS).index(variant),
        _build.stream(x)), "probe_convres")
    return y


def convres(x, w1, b1, w2, b2, w3, b3, w4, b4, variant: str = "base"):
    """The forward of `variant`: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {list(VARIANTS)}")
    if x.device.type == "cpu":
        return plain(x, w1, b1, w2, b2, w3, b3, w4, b4, variant)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return kernel(x, w1, b1, w2, b2, w3, b3, w4, b4, variant)


def inputs(bs: int, res: int, gen) -> tuple:
    """main()'s inputs on gen's device: x (bs, res, res, 64) ~ N(0, 1) in
    bf16; the weights N(0, 1) over the square root of their fan-in, the
    biases 0.1 N(0, 1), b1 and b2 shifted by +1."""
    r = lambda *s: torch.randn(*s, generator=gen, device=gen.device)
    x = r(bs, res, res, CIO).to(torch.bfloat16)
    ws = (r(1, 1, CIO, CM) / CIO ** 0.5, 0.1 * r(CM) + 1.0,
          r(3, 3, CM, CM) / (9 * CM) ** 0.5, 0.1 * r(CM) + 1.0,
          r(3, 3, CM, CM) / (9 * CM) ** 0.5, 0.1 * r(CM),
          r(1, 1, CM, CIO) / CM ** 0.5, 0.1 * r(CIO))
    return x, ws


def check_sees_faults(x, ws) -> None:
    """Raises unless, on these inputs, the check of a masked variant
    fails the output of the block without masks."""
    want = plain(x, *ws, variant="rowmask")
    _util.check_fails("nomask against rowmask", plain(x, *ws, variant="nomask"),
                      want, _util.scaled_tol(want, TOL))


def cost(bsz: int, h: int, w: int, itemsize: int = 2) -> dict:
    """The forward's bytes and FLOPs (ops/convres.py:cost, no scaling)."""
    return cr.cost(bsz, h, w, CIO, itemsize, None)


def main(argv=None) -> dict:
    """Checks, then times, the shipped K2 and every variant; returns the
    base variant's numbers (ms, plain_ms, library_ms, max_abs_err over
    every variant, cost) and the shipped K2's time alone (shipped_ms)
    under the kernel's name."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--res", type=int, default=256)
    args = p.parse_args(argv)
    _util.require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs, res = args.bs, args.res
    x, ws = inputs(bs, res, torch.Generator(device="cuda").manual_seed(0))
    cst = cost(bs, res, res)
    bnd, by = _util.bound_ms(cst)
    print(f"P3 ConvResBlock forward: B={bs} {res}x{res} cio {CIO} cm {CM} bf16, "
          f"bound {bnd:.4f} ms ({by}) [{_util.card_line()}]")
    time = lambda fn: _util.cuda_ms(fn, iters=3, reps=2)
    with torch.no_grad():
        k2 = lambda: cr.fused_convres_block(x, *ws, residual=True, scale=None)
        want = cr.reference_impl(x, *ws, residual=True, scale=None)
        _util.check("shipped K2", k2(), want, _util.scaled_tol(want, TOL))
        del want
        shipped_ms = time(k2)
        print(_util.row("shipped K2 (ops/convres.py)", shipped_ms, cst))
        check_sees_faults(x, ws)
        head, err_max = None, 0.0
        for name, (_, _, mish_dt, _) in VARIANTS.items():
            want = plain(x, *ws, variant=name)
            tol = TOL_BF16_MISH if mish_dt == "bf16" else TOL
            err = _util.check(name, kernel(x, *ws, variant=name), want,
                              _util.scaled_tol(want, tol))
            del want
            err_max = max(err_max, err)
            ms = time(lambda: kernel(x, *ws, variant=name))
            print(_util.row(name, ms, cst, f"err {err:.2e}, "
                            f"{ms / shipped_ms:.2f}x the shipped K2"))
            if head is None:
                plain_ms = time(lambda: plain(x, *ws, variant=name))
                head = dict(ms=ms, plain_ms=plain_ms, library_ms=None, cost=cst,
                            shipped_ms=shipped_ms)
                print(f"  plain version of {name}: {plain_ms:.3f} ms")
    head["max_abs_err"] = err_max
    return {"probe_convres": head}


if __name__ == "__main__":
    main()
