"""P2: the write rate the card reaches for the fused attention block's
output pass (counterpart of scripts/probe_attention_writeback.py):
identity copies of x (B, N, C) through csrc/probe_copy.cu.

  base-<tn>    copy_kernel on tiles of tn tokens (8192, 4096, 2048,
               1024) cut into 32 KB chunks: whole waves of the blocks
               the SMs hold at once, one or two chunks a block, a row of
               blocks a sample; 16-byte loads and streamed stores, eight
               in flight a thread
  flat-8192    the same chunks split by one row of blocks over all the
               tiles
  alias-8192   in place: y is x (the probe's input_output_aliases)
  manual-<tn>  copy_async_kernel: a ring of shared-memory stages loaded
               and stored by the copy engine (TMA bulk copies), several
               loads and stores in flight, on a persistent grid that
               splits the bytes evenly; chunks are cut from tiles of tn
               tokens (8192, 4096, 2048)
The probe's par-8192 and arb-8192 set TPU dimension semantics, which
have no Hopper counterpart (blocks always run in parallel, in no
order); main() prints that line in their place.  Library rows: x + 1
and torch.empty_like(x).copy_(x).

    python -m dddpm_tpu_torch.probes.attention_writeback [--bs 96]
        [--shape 128 128] [--c 128]

It needs a card.  Every variant is held against x bit for bit before it
is timed.  An identity copy in place leaves nothing a check could see,
so alias-8192 is checked only through base-8192, the same kernel on the
same path with out = x; main() holds x against a copy taken before.
"""
from __future__ import annotations

import argparse
import ctypes

import torch

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.probes import _util

# (name, kernel, tokens a block, grid flat, in place)
VARIANTS = [("base-8192", "copy", 8192, False, False),
            ("base-4096", "copy", 4096, False, False),
            ("base-2048", "copy", 2048, False, False),
            ("base-1024", "copy", 1024, False, False),
            ("flat-8192", "copy", 8192, True, False),
            ("alias-8192", "copy", 8192, False, True),
            ("manual-8192", "async", 8192, False, False),
            ("manual-4096", "async", 4096, False, False),
            ("manual-2048", "async", 2048, False, False)]
NO_COUNTERPART = ("par-8192, arb-8192: TPU dimension semantics; no Hopper "
                  "counterpart (blocks always run in parallel, in no order)")

# launches of each C entry; chip_smoke.py reads these
LAUNCHES = {"probe_copy": 0, "probe_copy_async": 0}


def _lib():
    lib = _build.load("probe_copy")
    if lib.probe_copy.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.probe_copy.argtypes = [vp, vp, i, ll, i, i, i, i, vp]
        lib.probe_copy.restype = i
        lib.probe_copy_async.argtypes = [vp, vp, i, ll, i, i, i, vp]
        lib.probe_copy_async.restype = i
    return lib


def _check(x, tn):
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.ndim != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned (B, N, C) tensor")
    _, n, c = x.shape
    if tn < 1 or n % tn or (tn * c * x.element_size()) % 16:
        raise ValueError(f"tn={tn} must divide N={n} into 16-byte multiples")


def copy_kernel(x, tn: int, flat: bool = False, out=None):
    """probe_copy: y = x in blocks of tn tokens; out may be x (in place)."""
    _check(x, tn)
    y = torch.empty_like(x) if out is None else out
    if y.shape != x.shape or y.dtype != x.dtype or not y.is_contiguous():
        raise ValueError("out must be contiguous and match x")
    bsz, n, c = x.shape
    lib = _lib()
    LAUNCHES["probe_copy"] += 1
    _build.check(lib.probe_copy(_build.ptr(x), _build.ptr(y), bsz, n, c,
                                x.element_size(), tn, int(flat), _build.stream(x)),
                 "probe_copy")
    return y


def copy_async_kernel(x, tn: int):
    """probe_copy_async: y = x through a ring of bulk copies."""
    _check(x, tn)
    y = torch.empty_like(x)
    bsz, n, c = x.shape
    lib = _lib()
    LAUNCHES["probe_copy_async"] += 1
    _build.check(lib.probe_copy_async(_build.ptr(x), _build.ptr(y), bsz, n, c,
                                      x.element_size(), tn, _build.stream(x)),
                 "probe_copy_async")
    return y


def copy(x, variant: str = "base-8192"):
    """The copy of `variant` (a name of VARIANTS): the kernel on a CUDA
    tensor; the plain version, x.clone() (x itself for alias), on a CPU
    tensor."""
    _, kind, tn, flat, alias = next(v for v in VARIANTS if v[0] == variant)
    if x.device.type == "cpu":
        return x if alias else x.clone()
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if kind == "async":
        return copy_async_kernel(x, tn)
    return copy_kernel(x, tn, flat, out=x if alias else None)


def cost(bsz: int, n: int, c: int, itemsize: int = 2) -> dict:
    """A copy reads x once and writes y once, and computes nothing."""
    return {"bytes": 2 * bsz * n * c * itemsize, "flops": 0}


def main(argv=None) -> dict:
    """Checks, then times, the library rows and every variant; returns,
    per kernel, its first variant (ms, plain_ms = x.clone(), library_ms =
    empty_like + copy_, max_abs_err over its variants, cost)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bs", type=int, default=96)
    p.add_argument("--shape", type=int, nargs=2, default=[128, 128])
    p.add_argument("--c", type=int, default=128)
    args = p.parse_args(argv)
    _util.require_card()
    bs, n, c = args.bs, args.shape[0] * args.shape[1], args.c
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((bs, n, c), generator=gen, device="cuda").to(torch.bfloat16)
    cst = cost(bs, n, c, x.element_size())
    bnd, _ = _util.bound_ms(cst)
    print(f"P2 write path: B={bs} N={n} C={c} bf16, {cst['bytes'] / 2e9:.3f} GB "
          f"each way, bound {bnd:.4f} ms [{_util.card_line()}]")
    time = lambda fn: _util.cuda_ms(fn, iters=10, reps=3)
    lib = {"x + 1": lambda: x + 1,
           "empty_like(x).copy_(x)": lambda: torch.empty_like(x).copy_(x),
           "x.clone() (plain version)": lambda: x.clone()}
    lib_ms = {}
    for name, fn in lib.items():
        lib_ms[name] = time(fn)
        print(_util.row(name, lib_ms[name], cst))
    print(NO_COUNTERPART)

    heads = {}
    keep = x.clone()
    for name, kind, tn, flat, alias in VARIANTS:
        run = lambda: copy(x, name)
        got = run()
        err = _util.check(name, got, keep, 0.0)
        ms = time(run)
        print(_util.row(name, ms, cst, f"{bs * (n // tn)} tiles"))
        key = "probe_copy" if kind == "copy" else "probe_copy_async"
        if key not in heads:
            heads[key] = dict(ms=ms, plain_ms=lib_ms["x.clone() (plain version)"],
                              library_ms=lib_ms["empty_like(x).copy_(x)"],
                              max_abs_err=err, cost=cst)
        heads[key]["max_abs_err"] = max(heads[key]["max_abs_err"], err)
    _util.check("x after the in-place variant", x, keep, 0.0)
    return heads


if __name__ == "__main__":
    main()
