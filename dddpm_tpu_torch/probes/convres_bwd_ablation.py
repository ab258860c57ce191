"""What K3's time is made of: csrc/convres_bwd.cu's bf16 kernel with
parts taken out, timed at the x3 training shapes on the card.

    python -m dddpm_tpu_torch.probes.convres_bwd_ablation

Each variant is csrc/convres_bwd.cu compiled with CONVRES_SKIP, which
takes parts of the kernel out: stage A's seven products (mma), mish
and mish' (the identity and 1), the global traffic (the x and dy bands,
x at the tile, the stores of dx) and the whole of stage B (the weight
and bias sums: their ldmatrix loads and mma.sync products, dw1..dw4
and the column sums of db1..db4, and their updates of the block's
partial).  So "full" less "no weight sums" is stage B's time.  Stage
A's ldmatrix loads, the epilogues' other work, the shared-memory
writes, the barriers and the in-order reduce of the blocks' partials
stay in every variant, so "none" is the kernel's fixed cost.  A variant without a part computes
garbage: nothing here is checked, only timed (the shipped kernel's
checks are the card tests and chip_smoke.py's K3 phase).  Each launch
goes through the C entry with weights already in bf16, so the times are
the kernel's, without the wrapper's casts.  It needs a card and nvcc.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import convres as cr
from dddpm_tpu_torch.probes import _util

# CONVRES_SKIP's bits in K3: 1 stage A's products, 2 mish and mish', 4
# global traffic, 8 stage B (the weight and bias sums)
VARIANTS = {"full": 0, "no products": 1, "no mish": 2, "no global traffic": 4,
            "no weight sums": 8, "products only": 14, "mish only": 13,
            "traffic only": 11, "weight sums only": 7, "none (fixed cost)": 15}
# (B, H, W) at cio 64: the x3 training shapes at 3 recon rows
SHAPES = [(3, 256, 256), (3, 128, 128)]


def build(variants=VARIANTS) -> dict:
    """{name: loaded library}, one nvcc per variant, all at once."""
    def one(item):
        name, bits = item
        return name, cr.library_bwd((f"CONVRES_SKIP={bits}",) if bits else ())

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
    bs = [0.1 * r(cm) for _ in range(3)]
    n = libs["full"].convres_bwd_partial_size(c)
    print(f"K3 ablation, cio {c}, bf16, us a launch [{_util.card_line()}]",
          flush=True)
    table = {}
    for bsz, h, w in SHAPES:
        x = r(bsz, h, w, c).bfloat16()
        dy = r(bsz, h, w, c).bfloat16()
        dx = torch.empty_like(x)
        nblk = cr._bwd_blocks(x)
        part = torch.empty((nblk, n), dtype=torch.float32, device="cuda")
        out = torch.empty((n,), dtype=torch.float32, device="cuda")
        stream = _build.stream(x)
        p = _build.ptr
        for name, lib in libs.items():
            call = lambda: _build.check(lib.convres_bwd(
                p(x), p(dy), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]),
                p(bs[2]), p(ws[3]), p(dx), p(part), p(out), bsz, h, w, c, 1,
                nblk, 1, stream), "convres_bwd")
            table[(name, (bsz, h, w))] = _util.cuda_ms(call, 10, reps=3) * 1e3
    for name in libs:
        print(f"  {name:18s}" + "".join(
            f"  B={b} {h}^2: {table[(name, (b, h, w))]:8.1f}"
            for b, h, w in SHAPES), flush=True)
    for shape in SHAPES:
        full = table[("full", shape)]
        stage_b = full - table[("no weight sums", shape)]
        print(f"  stage B (full less no weight sums) B={shape[0]} {shape[1]}^2: "
              f"{stage_b:.1f} us, {stage_b / full:.1%} of a launch", flush=True)
    return table


if __name__ == "__main__":
    main()
