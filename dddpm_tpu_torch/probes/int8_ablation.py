"""What Q1's time is made of: csrc/int8_conv.cu with parts taken out,
timed at the x2 UNet's quantized shape classes at the bulk sampler's
batch on the card.

    python -m dddpm_tpu_torch.probes.int8_ablation [--bs 192]

Each variant is csrc/int8_conv.cu compiled with Q1_SKIP, which takes
parts out: the s8 products (wgmma), the quantize's arithmetic, the TMA
boxes of x, the weights' copies and y's stores.  The barriers, the
shared-memory traffic of the products' A fragments and the epilogue's
arithmetic stay in every variant, so "none" is the kernel's fixed cost.
A variant without a part computes garbage: it is only timed (Q1's checks
are the card tests and chip_smoke.py phase 12).  Each launch goes
through the wrapper, so operands are read in place as on the path.  It
needs a card and nvcc.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import quant as qt
from dddpm_tpu_torch.probes import _util

# Q1_SKIP's bits: 1 products, 2 quantize, 4 x boxes, 8 weights, 16 stores
VARIANTS = {"full": 0, "no products": 1, "no quantize": 2, "no x boxes": 4,
            "no weights": 8, "no stores": 16, "no quantize, stores": 18,
            "none (fixed cost)": 31}
# (H = W, C, skip operand, layout): the two largest one-operand classes
# on both layouts and a two-operand seam, on NCHW (the path's layout)
SHAPES = [(128, 128, False, "nchw"), (128, 128, False, "cl"),
          (64, 256, False, "nchw"), (32, 256, True, "nchw")]


def build(variants=VARIANTS) -> dict:
    """{name: loaded library}: one nvcc per Q1_SKIP variant, all at once."""
    def one(item):
        name, bits = item
        lib = _build.load("int8_conv", (f"Q1_SKIP={bits}",) if bits else ())
        return name, qt.bind(lib)
    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bs", type=int, default=192)
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the Q1 ablation needs a CUDA card")
    libs = build()
    print(_util.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for hw, c, skip, layout in SHAPES:
        fmt = torch.contiguous_format if layout == "nchw" else torch.channels_last
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        x = (2.0 * r(args.bs, c, hw, hw)).to(torch.bfloat16).contiguous(memory_format=fmt)
        qw = qt.prepare_weight(r(c, c, 3, 3) / (9 * c) ** 0.5)
        kw = {"bias": 0.1 * r(c)}
        if skip:
            kw.update(skip=x.clone(), qw_skip=qw, amax_skip=x.float().abs().amax())
        amax = x.float().abs().amax() * 0.9
        bound, by = _util.bound_ms(qt.cost(args.bs, hw, hw, c, c, 2, 2 if skip else 1),
                                   torch.int8)
        key = f"B={args.bs} {hw}^2 c{c}{' +skip' if skip else ''} {layout}"
        row = {}
        for name, lib in libs.items():
            with mock.patch.object(qt, "_lib", lambda lib=lib: lib):
                row[name] = _util.cuda_ms(lambda: qt.int8_conv_q(x, qw, amax, **kw),
                                          args.iters, reps=2)
        out[key] = {"bound_ms": bound, "bound_by": by, **row}
        print(f"Q1 ablation {key}: bound {bound:.3f} ms ({by}); "
              + ", ".join(f"{n} {ms:.3f}" for n, ms in row.items()), flush=True)
        del x, qw, kw
    return out


if __name__ == "__main__":
    main()
