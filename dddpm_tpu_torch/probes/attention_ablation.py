"""What K1a's, K1b's and K1c's times are made of: csrc/attention_block.cu's
bf16 kernels with parts taken out, timed at the x2 sampling sites on
the card, and the two bf16 routes above 256 channels timed against each
other.

    python -m dddpm_tpu_torch.probes.attention_ablation

Each ablation variant is csrc/attention_block.cu compiled with
ATTN_SKIP, which takes parts of the bf16 kernels out: the row
statistics and LN, the kv / y products (mma), pass A's exp and s (pass
B's epilogue), pass A's A_h products, and the x tile loads.  The
weights' loads, the ldmatrix loads, the stores, the barriers and pass
A's in-order reduce stay in every variant, so "none" is the kernels'
fixed cost.  A variant without a part computes garbage: it is only
timed (the shipped kernels' checks are the card tests and
chip_smoke.py's attention phases).  The bf16 one-pass kernel (K1c)
runs the same item code as K1a and K1b, so the bits take the same parts
out of it; its gap to K1a + K1b in each variant is the cost of its grid
barriers, its in-kernel reduce and f32 fold, and the blocks idle while
a phase waits for its last item.  Built with ATTN_1P_PHASES = 1, 2, 3
it returns after pass A, the reduce or the fold, so each phase's time
is a difference.  The FMA one-pass kernel that bf16 took before the
tensor-core one (ATTN_BF16_FMA) is timed beside it.

Above 256 channels the tensor-core kernels stream their weights in
K-slabs (their WIDE body).  The FMA kernels that f32 takes also take
bf16 at every width; ATTN_BF16_FMA builds the library with the bf16
entries sent to them.  At WIDE_SITES both routes are checked against
the plain versions (scaled_tol(want, TOL)), then timed.  Each launch
goes through the C entry with the grid its route plans, so the times
are the kernels', without the wrapper's allocations.  It needs a card
and nvcc.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import attention_block as ab
from dddpm_tpu_torch.probes import _util

# ATTN_SKIP's bits: 1 LN, 2 kv / y products, 4 exp (B: epilogue),
# 8 A_h products, 16 x loads
VARIANTS = {"full": 0, "no LN": 1, "no kv/y products": 2, "no exp": 4,
            "no A products": 8, "no x loads": 16, "none (fixed cost)": 31}
# the bf16 K1c built to return after its first n phases (ATTN_1P_PHASES):
# pass A, the reduce, the fold (the full kernel adds pass B)
PHASES = {1: "pass A", 2: "reduce", 3: "fold"}
# the x2 sampling sites above 512 tokens, B = 8: (N, C)
SITES = [(16384, 128), (4096, 256), (1024, 256)]
# unet_chan 256 with unet_dims (1, 2, 2, 2) on a 128^2 latent: its
# 512-channel sites above 512 tokens, (N, C)
WIDE_SITES = [(4096, 512), (1024, 512)]
B = 8
# the card tests' bf16 tolerance: this fraction of max(1, max |want|)
TOL = 3e-2


def build(variants=VARIANTS) -> dict:
    """{name: loaded library}: the ATTN_SKIP variants and "bf16 FMA"
    (ATTN_BF16_FMA), one nvcc each, all at once."""
    defines = {name: (f"ATTN_SKIP={bits}",) if bits else ()
               for name, bits in variants.items()}
    defines["bf16 FMA"] = ("ATTN_BF16_FMA=1",)
    defines.update({f"phases {n}": (f"ATTN_1P_PHASES={n}",) for n in PHASES})
    with ThreadPoolExecutor(len(defines)) as pool:
        return dict(pool.map(lambda item: (item[0], ab.library(item[1])),
                             defines.items()))


def inputs(gen, n: int, c: int) -> dict:
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return dict(x=r(B, n, c).bfloat16(), g=1.0 + 0.1 * r(c), b=0.1 * r(c),
                b_out=0.1 * r(c),
                w_kv=(r(c, 2 * ab.HIDDEN) / c ** 0.5).bfloat16(),
                w_q=(r(c, ab.HIDDEN) / c ** 0.5).bfloat16(),
                w_out=(r(ab.HIDDEN, c) / ab.HIDDEN ** 0.5).bfloat16(),
                w_eff=(r(B, c, c) / c ** 0.5).bfloat16())


def calls(lib, t: dict, fma: bool) -> dict:
    """{"attn_ctx" | "attn_out" | "attn_1pass": (launch, its output)}
    through lib's C entries, with the grid of the route: the tensor-core
    kernels' plan (ab._grid, ab.plan_1pass), or the FMA kernels' block
    an item, two an SM."""
    x = t["x"]
    _, n, c = x.shape
    if fma:
        sms = ab._sms(torch.cuda.current_device())
        nchunks, tpc = ab.plan(B, -(-n // ab.TOKEN_TILE), 2 * sms)
        na, tpa, ga = nb, tpb, gb = nchunks, tpc, 0
    else:
        na, tpa, ga = ab._grid(x, 0)
        nb, tpb, gb = ab._grid(x, 1)
    part_a = torch.empty((B, na, 4, 32, 32), device="cuda")
    part_s = torch.empty((B, na, ab.HIDDEN), device="cuda")
    ctx = torch.empty((B, ab.HIDDEN, ab.HIDDEN), device="cuda")
    y = torch.empty_like(x)
    stream = _build.stream(x)
    p = _build.ptr
    n1, tp1, g1 = ab.plan_1pass(B, n, c, lib.attn_1p_resident(c, 1), not fma)
    scratch = (torch.empty((B, n1, 4, 32, 32), device="cuda"),
               torch.empty((B, n1, ab.HIDDEN), device="cuda"),
               torch.empty((B, 4, 32, 32), device="cuda"),
               torch.empty((B, c, c), dtype=x.dtype, device="cuda"))
    y1 = torch.empty_like(x)
    return {
        "attn_1pass": (lambda: _build.check(lib.attn_1p(
            p(x), p(t["g"]), p(t["b"]), p(t["w_kv"]), p(t["w_q"]), p(t["w_out"]),
            p(t["b_out"]), *map(p, scratch), p(y1), B, n, c, n1, tp1, g1,
            ab._vec(c, x, t["w_kv"], scratch[3], y1), 1, stream), "attn_1p"), y1),
        "attn_ctx": (lambda: _build.check(lib.attn_ctx(
            p(x), p(t["g"]), p(t["b"]), p(t["w_kv"]), p(part_a), p(part_s),
            p(ctx), B, n, c, na, tpa, ga, 1, 1, stream), "attn_ctx"), ctx),
        "attn_out": (lambda: _build.check(lib.attn_out(
            p(x), p(t["g"]), p(t["b"]), p(t["w_eff"]), p(t["b_out"]), p(y), B,
            n, c, nb, tpb, gb, 1, 1, stream), "attn_out"), y)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.parse_args(argv)
    _util.require_card()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"K1a / K1b / K1c ablation, B={B}, bf16, us a launch [{_util.card_line()}]",
          flush=True)
    table = {}
    for n, c in SITES:
        t = inputs(gen, n, c)
        for name in VARIANTS:
            for kernel, (call, _) in calls(libs[name], t, False).items():
                table[(kernel, name, (n, c))] = _util.cuda_ms(call, 20, reps=3) * 1e3
        for kernel, (call, _) in calls(libs["bf16 FMA"], t, True).items():
            if kernel == "attn_1pass":
                table[(kernel, "bf16 FMA", (n, c))] = _util.cuda_ms(call, 5, reps=2) * 1e3
        for k in PHASES:
            call = calls(libs[f"phases {k}"], t, False)["attn_1pass"][0]
            table[("attn_1pass", f"phases {k}", (n, c))] = _util.cuda_ms(call, 20, reps=3) * 1e3
    for kernel in ("attn_ctx", "attn_out", "attn_1pass"):
        for name in VARIANTS:
            print(f"  {kernel} {name:18s}" + "".join(
                f"  N={n} C={c}: {table[(kernel, name, (n, c))]:7.1f}"
                for n, c in SITES), flush=True)
    for name in VARIANTS:
        print(f"  attn_1pass - (attn_ctx + attn_out) {name:18s}" + "".join(
            f"  N={n} C={c}: " + format(table[("attn_1pass", name, (n, c))]
                                        - table[("attn_ctx", name, (n, c))]
                                        - table[("attn_out", name, (n, c))], "7.1f")
            for n, c in SITES), flush=True)
    # each phase's time: the kernel cut after it less the kernel cut before
    cut = {0: {site: 0.0 for site in SITES}, 4: {site: table[("attn_1pass", "full", site)]
                                                 for site in SITES}}
    cut.update({k: {site: table[("attn_1pass", f"phases {k}", site)] for site in SITES}
                for k in PHASES})
    for k, name in {**PHASES, 4: "pass B"}.items():
        print(f"  attn_1pass phase {k}, {name:8s} (with its barrier)" + "".join(
            f"  N={n} C={c}: {cut[k][(n, c)] - cut[k - 1][(n, c)]:7.1f}"
            for n, c in SITES), flush=True)
    print("  attn_1pass on the FMA pipes (ATTN_BF16_FMA)" + "".join(
        f"  N={n} C={c}: {table[('attn_1pass', 'bf16 FMA', (n, c))]:7.1f}"
        for n, c in SITES), flush=True)
    print(f"bf16 routes above {ab.COLUMN_SLAB} channels, B={B}, us a launch "
          f"(tensor cores: the shipped WIDE body; FMA: ATTN_BF16_FMA)", flush=True)
    for n, c in WIDE_SITES:
        t = inputs(gen, n, c)
        w_qkv = torch.stack([t["w_q"], *t["w_kv"].split(ab.HIDDEN, dim=1)],
                            dim=1).reshape(c, 3 * ab.HIDDEN)
        want = {"attn_ctx": ab.ctx_reference(t["x"], t["g"], t["b"], t["w_kv"]),
                "attn_out": ab.out_reference(t["x"], t["g"], t["b"], t["w_eff"],
                                             t["b_out"]),
                "attn_1pass": ab.one_pass_reference(t["x"], t["g"], t["b"], w_qkv,
                                                    t["w_out"], t["b_out"])}
        for route, name in (("tensor cores", "full"), ("FMA", "bf16 FMA")):
            for kernel, (call, got) in calls(libs[name], t, name != "full").items():
                call()
                err = _util.check(f"{kernel} {route} N={n} C={c}", got,
                                  want[kernel], _util.scaled_tol(want[kernel], TOL))
                us = _util.cuda_ms(call, 20, reps=3) * 1e3
                table[(kernel, route, (n, c))] = us
                print(f"  {kernel} N={n} C={c} {route:12s}: {us:7.1f} "
                      f"(max abs err {err:.3e})", flush=True)
    return table


if __name__ == "__main__":
    main()
