"""What K2/K3's width-general route spends its time on:
csrc/convres_general.cu's bf16 kernels with parts taken out, each
launch of the chain timed on the card at d_chans 128 (cm 64, cio 128).

    python -m dddpm_tpu_torch.probes.convres_general_ablation

Each variant is csrc/convres_general.cu compiled with GENERAL_SKIP,
which takes parts of the bf16 kernels out: 1 the products (mma), 2 the
epilogue (the staged sums and everything after them; the products then
feed nothing and the compiler drops them too, so "loads only" is 3), 4
the global loads into the ring.  The ldmatrix loads, the prologue's mish,
the barriers and the launches stay in every variant, so "none" is the
chain's fixed cost.  A variant without a part computes garbage: nothing
here is checked, only timed (the shipped kernels' checks are the card
tests and chip_smoke.py's phase 13).  Each call goes through the C entry
with weights already in bf16 and the scratch allocated once, so the
times are the kernels', without the wrapper's casts; each launch's
device time comes from torch.profiler, in chain order.  It needs a card
and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.profiler import ProfilerActivity, profile

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.probes import _util

# GENERAL_SKIP's bits: 1 products, 2 epilogue, 4 global loads
VARIANTS = {"full": 0, "no products": 1, "no loads": 4, "loads only": 3,
            "epilogue only": 5, "none (fixed cost)": 7}
# (B, H, W, scale, backward): the x2 decode's 256^2 block and its 128^2
# 'up' block (B = 8), a x3 step's recon-row backward at 256^2 (B = 4)
SHAPES = [(8, 256, 256, 0, False), (8, 128, 128, 1, False), (4, 256, 256, 0, True)]
C, CM = 128, 64
KERNELS = ("conv1x1_mma", "conv3x3_mma", "wgrad1x1_mma", "wgrad3x3_mma", "transpose_taps",
           "convres_reduce")


def library(bits: int) -> ctypes.CDLL:
    """csrc/convres_general.cu built with GENERAL_SKIP=bits, typed."""
    lib = _build.load("convres_general", (f"GENERAL_SKIP={bits}",) if bits else ())
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.convres_fwd_general.argtypes = [vp] * 11 + [i] * 8 + [vp]
    lib.convres_bwd_general.argtypes = [vp] * 14 + [i] * 7 + [vp]
    lib.convres_bwd_general_part.argtypes = [i] * 5
    lib.convres_bwd_general_part.restype = ll
    lib.convres_general_samples.argtypes = [i] * 3
    return lib


def launches_us(call) -> list:
    """Each kernel launch of one call, in order: (name, device us)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [(next((k for k in KERNELS if k in e.name), e.name), e.device_time_total)
            for e in prof.events() if e.device_time_total > 0]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.parse_args(argv)
    _util.require_card()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(library, VARIANTS.values())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    ws = [(r(*s) / s[-2] ** 0.5).bfloat16()
          for s in ((C, CM), (9 * CM, CM), (9 * CM, CM), (CM, C))]
    bs = [0.1 * r(n) for n in (CM, CM, CM, C)]
    grads = torch.empty(2 * C * CM + 18 * CM * CM + 3 * CM + C, device="cuda")
    p = _build.ptr
    print(f"K2/K3 general ablation, cm {CM}, cio {C}, bf16, ms a call and us "
          f"a launch in chain order [{_util.card_line()}]", flush=True)
    table = {}
    for bsz, h, w, scale, bwd in SHAPES:
        x, dy = r(bsz, h, w, C).bfloat16(), r(bsz, h, w, C).bfloat16()
        out_hw = (2 * h, 2 * w) if scale == 1 else (h, w)
        y = torch.empty((bsz, *out_hw, C), dtype=x.dtype, device="cuda")
        pix = libs["full"].convres_general_samples(bsz, h, w) * h * w * CM
        scratch = torch.empty(6 * pix, dtype=x.dtype, device="cuda")
        scratch_f32 = torch.empty(3 * pix, device="cuda")
        part = torch.empty(libs["full"].convres_bwd_general_part(bsz, h, w, C, CM),
                           device="cuda")
        stream = _build.stream(x)
        what = (f"B={bsz} {h}^2 {'backward' if bwd else 'forward'}"
                f"{' up' if scale == 1 else ''}")
        for name, lib in libs.items():
            if bwd:
                call = lambda: _build.check(lib.convres_bwd_general(
                    p(x), p(dy), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]),
                    p(bs[2]), p(ws[3]), p(y), p(grads), p(scratch), p(scratch_f32),
                    p(part), bsz, h, w, C, CM, 1, 1, stream), "convres_bwd_general")
            else:
                call = lambda: _build.check(lib.convres_fwd_general(
                    p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]), p(bs[2]),
                    p(ws[3]), p(bs[3]), p(y), p(scratch), bsz, h, w, C, CM, 1, scale,
                    1, stream), "convres_fwd_general")
            ms = _util.cuda_ms(call, 10, reps=3)
            each = launches_us(call)
            table[(name, what)] = {"ms": ms, "launches_us": each}
            print(f"  {what:24s} {name:18s} {ms:7.3f} ms: " + " ".join(
                f"{n} {t:.0f}" for n, t in each), flush=True)
    return table


if __name__ == "__main__":
    main()
