"""What K6's time is made of: csrc/winograd.cu with parts of its stage
loop taken out, timed at the three x2 3x3 convs on the card.

    python -m dddpm_tpu_torch.probes.winograd_ablation [--bs 8]

Each variant is csrc/winograd.cu compiled with WINOGRAD_SKIP, which
takes parts of the pipeline iteration out: the products (ldmatrix +
mma), the input transform of the next stage, and the cp.async loads of
the stages after the first.  The prologue (the first stage's loads and
V) and the write-out of y stay in every variant, so "none" is the
kernel's fixed cost.  A variant without a part computes garbage:
nothing here is checked, only timed (the shipped kernel's checks are
the card tests and chip_smoke.py's K6 phase).  It needs a card and nvcc.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import winograd as wg
from dddpm_tpu_torch.probes import _util

# WINOGRAD_SKIP's bits: 1 products, 2 transform, 4 loads
VARIANTS = {"full": 0, "no products": 1, "no transform": 2, "no loads": 4,
            "products only": 6, "transform only": 5, "loads only": 3,
            "none (fixed cost)": 7}
# the x2 UNet's 3x3 convs: (H = W, Cin = Cout)
SHAPES = [(128, 128), (64, 256), (32, 256)]


def build(variants=VARIANTS) -> dict:
    """{name: loaded library}, one nvcc per variant, all at once."""
    def one(item):
        name, bits = item
        return name, wg.library((f"WINOGRAD_SKIP={bits}",) if bits else ())

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bs", type=int, default=8)
    args = parser.parse_args(argv)
    _util.require_card()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"K6 ablation, B={args.bs}, bf16, us a launch "
          f"[{_util.card_line()}]", flush=True)
    table = {}
    for hw, c in SHAPES:
        x = torch.randn(args.bs, hw, hw, c, generator=gen,
                        device="cuda").bfloat16()
        u = torch.randn(16, c, c, generator=gen, device="cuda").bfloat16()
        b = torch.zeros(c, device="cuda")
        y = torch.empty_like(x)
        stream = _build.stream(x)
        p = _build.ptr
        for name, lib in libs.items():
            call = lambda: _build.check(lib.winograd_conv(
                p(x), p(u), p(b), p(y), args.bs, hw, hw, c, c, 0, 1, stream),
                "winograd_conv")
            table[(name, hw)] = _util.cuda_ms(call, 20, reps=3) * 1e3
    for name in libs:
        print(f"  {name:18s}" + "".join(
            f"  {hw}^2 c{c}: {table[(name, hw)]:7.1f}" for hw, c in SHAPES),
            flush=True)
    return table


if __name__ == "__main__":
    main()
