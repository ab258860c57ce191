"""What K2's time is made of: csrc/convres_fwd.cu's bf16 kernel with
parts taken out, timed at the x2 decode's shapes and a x3 training
shape on the card.

    python -m dddpm_tpu_torch.probes.convres_ablation

Each variant is csrc/convres_fwd.cu compiled with CONVRES_SKIP, which
takes parts of the kernel out: the products (mma), the mish (made the
identity), and the producers' global traffic (the band loads and the
stores of o).  The ldmatrix loads, the epilogues' other work, the
shared-memory copies and the barriers stay in every variant, so "none"
is the kernel's fixed cost.  A variant without a part computes garbage:
nothing here is checked, only timed (the shipped kernel's checks are
the card tests and chip_smoke.py's K2 phases).  Each launch goes
through the C entry with weights already in bf16, so the times are the
kernel's, without the wrapper's casts.  It needs a card and nvcc.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import convres as cr
from dddpm_tpu_torch.probes import _util

# CONVRES_SKIP's bits: 1 products, 2 mish, 4 global traffic
VARIANTS = {"full": 0, "no products": 1, "no mish": 2, "no global traffic": 4,
            "products only": 6, "mish only": 5, "traffic only": 3,
            "none (fixed cost)": 7}
# (B, H, W, scale) at cio 64: the x2 decode's three launches, a x3 one
SHAPES = [(8, 128, 128, "up"), (8, 256, 256, None), (32, 128, 128, None)]
SCALES = {None: 0, "up": 1, "down": 2}


def build(variants=VARIANTS) -> dict:
    """{name: loaded library}, one nvcc per variant, all at once."""
    def one(item):
        name, bits = item
        return name, cr.library((f"CONVRES_SKIP={bits}",) if bits else ())

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.parse_args(argv)
    _util.require_card()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    c, cm = 64, cr.MID_CHANNELS
    ws = [(r(*s) / s[-2] ** 0.5).bfloat16()
          for s in ((c, cm), (9 * cm, cm), (9 * cm, cm), (cm, c))]
    bs = [0.1 * r(n) for n in (cm, cm, cm, c)]
    print(f"K2 ablation, cio {c}, bf16, us a launch [{_util.card_line()}]",
          flush=True)
    table = {}
    for bsz, h, w, scale in SHAPES:
        x = r(bsz, h, w, c).bfloat16()
        hh, ww = {None: (h, w), "up": (2 * h, 2 * w)}[scale]
        y = torch.empty((bsz, hh, ww, c), dtype=x.dtype, device="cuda")
        stream = _build.stream(x)
        p = _build.ptr
        for name, lib in libs.items():
            call = lambda: _build.check(lib.convres_fwd(
                p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]), p(bs[2]),
                p(ws[3]), p(bs[3]), p(y), bsz, h, w, c, 1, SCALES[scale], 1,
                stream), "convres_fwd")
            table[(name, (bsz, h, w, scale))] = _util.cuda_ms(call, 20, reps=3) * 1e3
    for name in libs:
        print(f"  {name:18s}" + "".join(
            f"  B={b} {h}^2 {s or 'none'}: {table[(name, (b, h, w, s))]:7.1f}"
            for b, h, w, s in SHAPES), flush=True)
    return table


if __name__ == "__main__":
    main()
