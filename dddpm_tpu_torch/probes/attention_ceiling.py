"""P1: what each part of the fused attention block's two passes costs on
the card (counterpart of scripts/probe_attention_ceiling.py).

Pass A variants, ctx = A / max(s, 1) with A the FULL 128 x 128 p^T v
(the probe forms no head mask, unlike the shipped pass A, K1a):
  full     LN -> kv -> p = exp(min(k, 60)) -> s, A   (the probe's A-full)
  noexp    p = min(k, 60): the cost of exp
  noln     x into the kv product: the cost of LN
  payload  p = k, no s: the kv product and A alone
  dma      every byte of x read, ctx = 0: the read floor
Pass B variants:
  full     y = x + LN(x) @ W_eff[b] + b_out
  noln     y = x + x @ W_eff[b] + b_out
  dma      y = x: the read + write floor
Each runs with G in {1, 4, 8} samples a block and token tiles of
pick_tile(N, max(tn_target // G, 512)), the probe's own rule, so every
G gives the same block count at the default size (192: 1.45 waves on
132 SMs).  The kernels are csrc/probe_attention.cu: the products on the
tensor cores (mma.sync), as in the shipped K1a / K1b, whose times alone
at the same shape main() prints beside the full variants (K1a forms
only the four heads' 32 x 32 blocks of A, a quarter of pass A's second
product; K1b computes what pass B full computes).

Pass A is timed alone.  The TPU probe chained it into B-noln and
subtracted B-noln's time only because its lax.scan needed an x-shaped
carry; CUDA events around the launches need none.

    python -m dddpm_tpu_torch.probes.attention_ceiling [--bs 96]
        [--shape 128 128] [--c 128] [--groups 1 4 8]

It needs a card.  It prints the shipped route at the same shape
(ops/attention_block.py:attention_block: K1a + the fold + K1b) and
x + 1, then every variant, each held against its plain version on the
full input before it is timed: pass B (bf16) within TOL of the larger
of 1 and the output's largest magnitude (y rounded to bf16, an ulp
apart at most, LN's rounding in other places), pass A (f32 ctx) within
TOL_CTX of ctx's own largest magnitude (the same bf16 roundings of LN,
p and v, sums in another order; looser for noexp, whose s can cancel),
the dma variants exactly.  LN's g and b are far from 1 and 0, so that
LN moves both outputs; before the variants, main() shows on its own
inputs that these checks fail a pass without LN, a reduce that keeps
one token tile, and a pass A whose A is K1a's (the heads' blocks alone)
or transposed.
"""
from __future__ import annotations

import argparse
import ctypes

import torch

from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import attention_block as ab
from dddpm_tpu_torch.probes import _util

HIDDEN = 128
LN_EPS = 1e-5
K_CLAMP = 60.0
PASS_A = ("full", "noexp", "noln", "payload", "dma")   # kernel codes 0..4
PASS_B = ("full", "noln", "dma")                       # kernel codes 0..2
GROUPS = (1, 4, 8)
OUT_WIDTHS = (128, 256)          # the widths pass B's kernel is built for
TOL = 3e-2        # pass B, of the larger of 1 and max |y|
# pass A, of max |ctx|, no floor; noexp's p = min(k, 60) takes both
# signs, so its s can cancel to near 1, where an LN value rounded one
# bf16 ulp apart moves ctx = A / s by a few 1e-3 of it
TOL_CTX = {"full": 1e-3, "noexp": 1e-2, "noln": 1e-3, "payload": 1e-3}

# launches of each C entry; chip_smoke.py reads these
LAUNCHES = {"probe_attn_ctx": 0, "probe_attn_out": 0}
# the shipped kernel main() times beside each entry's full variant
SHIPPED = {"probe_attn_ctx": "K1a", "probe_attn_out": "K1b"}


def pick_tile(n: int, target: int = 4096) -> int:
    """The largest power-of-two fraction of target that divides n (the
    JAX package's _pick_tile)."""
    tile = min(n, target)
    while n % tile:
        tile //= 2
    return max(tile, 1)


def token_tile(n: int, c: int, group: int, tn_target=None) -> int:
    """Tokens a block takes per sample: the probe's tn_target (8192 at
    C <= 128, else 4096) shared by the group's samples, at least 512."""
    if tn_target is None:
        tn_target = 8192 if c <= 128 else 4096
    return pick_tile(n, max(tn_target // group, 512))


def layer_norm_mxu(x, g, b):
    """Channel LN with the statistics of the JAX package's
    _layer_norm_mxu: var = max(E[x^2] - E[x]^2, 0), and at C <= 128 the
    squares in x's dtype (its dot(x * x, ones)) summed in f32."""
    n = x.shape[-1]
    xf = x.float()
    m1 = xf.mean(dim=-1, keepdim=True)
    sq = (x * x).float() if n <= 128 else xf * xf
    var = (sq.mean(dim=-1, keepdim=True) - m1 * m1).clamp(min=0.0)
    return (xf - m1) / (torch.sqrt(var) + LN_EPS) * g + b


def ctx_plain(x, g, b, w_kv, variant: str = "full"):
    """Plain version of pass A (what probe_attn_ctx computes), any dtype:
    (B, hidden, hidden) f32."""
    if variant == "dma":
        hidden = w_kv.shape[1] // 2
        return torch.zeros((x.shape[0], hidden, hidden), dtype=torch.float32,
                           device=x.device)
    a, s = ctx_parts(x, g, b, w_kv, variant)
    return a / s.clamp(min=1.0)[..., None]


def ctx_parts(x, g, b, w_kv, variant: str = "full"):
    """Pass A's plain sums before the division, any variant but dma: A =
    p^T v (B, hidden, hidden) and s = sum of p (B, hidden), f32."""
    bsz = x.shape[0]
    hidden = w_kv.shape[1] // 2
    dt = x.dtype
    ln = x if variant in ("noln", "payload") else layer_norm_mxu(x, g, b).to(dt)
    kv = ln.float() @ w_kv.to(dt).float()
    k = kv[..., :hidden]
    if variant == "payload":
        p, s = k, torch.zeros((bsz, hidden), device=x.device)
    else:
        p = k.clamp(max=K_CLAMP)
        if variant != "noexp":
            p = torch.exp(p)
        s = p.sum(dim=1)
    a = torch.einsum("bnh,bne->bhe", p.to(dt).float(), kv[..., hidden:].to(dt).float())
    return a, s


def out_plain(x, g, b, w_eff, b_out, variant: str = "full"):
    """Plain version of pass B (what probe_attn_out computes), any dtype."""
    if variant == "dma":
        return x.clone()
    dt = x.dtype
    ln = x if variant == "noln" else layer_norm_mxu(x, g, b).to(dt)
    y = ln.float() @ w_eff.to(dt).float() + b_out
    return (x.float() + y).to(dt)


def _lib():
    lib = _build.load("probe_attention")
    if lib.probe_attn_ctx.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_attn_ctx.argtypes = [vp] * 7 + [i] * 6 + [vp]
        lib.probe_attn_ctx.restype = i
        lib.probe_attn_out.argtypes = [vp] * 6 + [i] * 6 + [vp]
        lib.probe_attn_out.restype = i
    return lib


def _check(x, g, b, mats, group, tn, widths=None):
    """Raises on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, C) tensor")
    bsz, n, c = x.shape
    if c % 32 or c > 256 or (widths is not None and c not in widths):
        raise ValueError(f"channel width {c} unsupported")
    if group not in GROUPS or bsz % group or n % tn:
        raise ValueError(f"group {group} must be in {GROUPS} and divide B={bsz}, "
                         f"tn={tn} divide N={n}")
    for v in (g, b):
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError("g, b must be float32 (C,) tensors on x's device")
    for m, shape in mats:
        if (tuple(m.shape) != shape or m.dtype != x.dtype or m.device != x.device
                or not m.is_contiguous()):
            raise ValueError(f"weights must be contiguous {shape} {x.dtype} on "
                             f"{x.device}, got {tuple(m.shape)} {m.dtype}")


def ctx_kernel(x, g, b, w_kv, variant: str, group: int, tn: int):
    """probe_attn_ctx: pass A of `variant`, `group` samples a block, tn
    tokens a block; (B, 128, 128) f32."""
    c = x.shape[-1]
    _check(x, g, b, [(w_kv, (c, 2 * HIDDEN))], group, tn)
    x, w_kv = _build.aligned(x), _build.aligned(w_kv)   # 16-byte loads
    bsz, n, _ = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    part_a = torch.empty((bsz, n // tn, HIDDEN, HIDDEN), **f32)
    part_s = torch.empty((bsz, n // tn, HIDDEN), **f32)
    ctx = torch.empty((bsz, HIDDEN, HIDDEN), **f32)
    lib = _lib()
    LAUNCHES["probe_attn_ctx"] += 1
    p = _build.ptr
    _build.check(lib.probe_attn_ctx(p(x), p(g), p(b), p(w_kv), p(part_a), p(part_s),
                                    p(ctx), bsz, n, c, tn, PASS_A.index(variant),
                                    group, _build.stream(x)), "probe_attn_ctx")
    return ctx


def out_kernel(x, g, b, w_eff, b_out, variant: str, group: int, tn: int):
    """probe_attn_out: pass B of `variant`, out of place."""
    bsz, n, c = x.shape
    _check(x, g, b, [(w_eff, (bsz, c, c))], group, tn, OUT_WIDTHS)
    if b_out.shape != (c,) or b_out.dtype != torch.float32 or b_out.device != x.device:
        raise ValueError("b_out must be a float32 (C,) tensor on x's device")
    x, w_eff = _build.aligned(x), _build.aligned(w_eff)   # 16-byte loads
    y = torch.empty_like(x)
    lib = _lib()
    LAUNCHES["probe_attn_out"] += 1
    p = _build.ptr
    _build.check(lib.probe_attn_out(p(x), p(g), p(b), p(w_eff), p(b_out), p(y), bsz,
                                    n, c, tn, PASS_B.index(variant), group,
                                    _build.stream(x)), "probe_attn_out")
    return y


def _args(x, variant, variants, group):
    if variant not in variants:
        raise ValueError(f"variant {variant!r} not in {variants}")
    if group not in GROUPS or x.shape[0] % group:
        raise ValueError(f"group {group} must be in {GROUPS} and divide B")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def pass_a(x, g, b, w_kv, variant: str = "full", group: int = 1, tn_target=None):
    """Pass A of `variant` on (B, N, C) x: the kernel on a CUDA tensor,
    the plain version on a CPU tensor (group and tiles change nothing
    there)."""
    _args(x, variant, PASS_A, group)
    if x.device.type == "cpu":
        return ctx_plain(x, g, b, w_kv, variant)
    _, n, c = x.shape
    return ctx_kernel(x, g, b, w_kv, variant, group, token_tile(n, c, group, tn_target))


def pass_b(x, g, b, w_eff, b_out, variant: str = "full", group: int = 1,
           tn_target=None):
    """Pass B of `variant` on (B, N, C) x, as pass_a."""
    _args(x, variant, PASS_B, group)
    if x.device.type == "cpu":
        return out_plain(x, g, b, w_eff, b_out, variant)
    _, n, c = x.shape
    return out_kernel(x, g, b, w_eff, b_out, variant, group,
                      token_tile(n, c, group, tn_target))


def cost(bsz: int, n: int, c: int, itemsize: int = 2) -> dict:
    """Bytes each pass must move and FLOPs it must do, per variant: pass
    A reads x and w_kv and writes ctx, pass B reads x and W_eff and
    writes y; the products (kv, the full A, x @ W_eff) and LN (8
    operations a channel) where the variant has them."""
    tokens = bsz * n
    x_bytes = tokens * c * itemsize
    a_bytes = x_bytes + c * 2 * HIDDEN * itemsize + bsz * HIDDEN * HIDDEN * 4
    b_bytes = 2 * x_bytes + bsz * c * c * itemsize
    prod_a = tokens * (2 * c * 2 * HIDDEN + 2 * HIDDEN * HIDDEN)
    prod_b = tokens * 2 * c * c
    ln = tokens * 8 * c
    return {
        "pass_a": {v: {"bytes": a_bytes,
                       "flops": 0 if v == "dma" else
                       prod_a + (ln if v in ("full", "noexp") else 0)}
                   for v in PASS_A},
        "pass_b": {v: {"bytes": b_bytes,
                       "flops": 0 if v == "dma" else
                       prod_b + (ln if v == "full" else 0)}
                   for v in PASS_B},
    }


def ctx_tol(want: torch.Tensor, variant: str = "full") -> float:
    """Pass A's tolerance: TOL_CTX of ctx's largest magnitude (0 for
    dma: exact)."""
    return TOL_CTX.get(variant, 0.0) * float(want.abs().max())


def inputs(bs, n, c, gen):
    """main()'s inputs on gen's device: x ~ N(0, 1) in bf16, g = 1 +
    0.5 N(0, 1) and b = 0.5 N(0, 1), so that LN(x) is far from x; the
    weights 0.05 N(0, 1) in bf16.  (x, g, b, w_qkv, w_out, b_out, w_kv,
    w_eff), w_kv the k and v columns of w_qkv."""
    r = lambda *s: torch.randn(*s, generator=gen, device=gen.device)
    x = r(bs, n, c).to(torch.bfloat16)
    g, b, b_out = 1.0 + 0.5 * r(c), 0.5 * r(c), 0.1 * r(c)
    w_qkv = (r(c, 3 * HIDDEN) * 0.05).to(torch.bfloat16)
    w_out = (r(HIDDEN, c) * 0.05).to(torch.bfloat16)
    w_k, w_v = (w_qkv.reshape(c, 3, HIDDEN)[:, i] for i in (1, 2))
    w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
    w_eff = (r(bs, c, c) * 0.05).to(torch.bfloat16)
    return x, g, b, w_qkv, w_out, b_out, w_kv, w_eff


def ctx_faults(ctx, s):
    """Two wrong pass A's made from a ctx = A / max(s, 1) (B, 128, 128)
    and its s (B, 128): K1a's A (the heads' 32 x 32 diagonal blocks
    alone) and A transposed, each divided by max(s, 1) by A's row."""
    den = s.clamp(min=1.0)[..., None]
    a = ctx * den
    mask = torch.block_diag(*[torch.ones(32, 32, device=a.device)] * (HIDDEN // 32))
    return {"pass A with K1a's head mask": a * mask / den,
            "pass A with A transposed": a.transpose(-1, -2) / den}


def check_sees_faults(x, g, b, w_kv, w_eff, b_out, tn):
    """Raises unless, on these inputs, the full variants' checks fail a
    pass A without LN, a pass A whose reduce keeps only the first token
    tile of tn (when there are more), a pass A whose A is head-masked
    (K1a's) or transposed, and a pass B without LN."""
    a, s = ctx_parts(x, g, b, w_kv)
    want = a / s.clamp(min=1.0)[..., None]
    del a
    tol = ctx_tol(want)
    _util.check_fails("pass A without LN", ctx_plain(x, g, b, w_kv, "noln"),
                      want, tol)
    if tn < x.shape[1]:
        _util.check_fails("pass A over one token tile",
                          ctx_plain(x[:, :tn], g, b, w_kv), want, tol)
    for name, wrong in ctx_faults(want, s).items():
        _util.check_fails(name, wrong, want, tol)
    del want
    want = out_plain(x, g, b, w_eff, b_out)
    _util.check_fails("pass B without LN", out_plain(x, g, b, w_eff, b_out, "noln"),
                      want, _util.scaled_tol(want, TOL))


def main(argv=None) -> dict:
    """Checks, then times, the shipped route, K1a and K1b alone, x + 1
    and every variant; returns, per kernel, its full variant at the
    first G (ms, plain_ms, library_ms, max_abs_err over every variant,
    cost) and the shipped kernel of the same pass alone (shipped_ms)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bs", type=int, default=96)
    p.add_argument("--shape", type=int, nargs=2, default=[128, 128],
                   help="H W of the latent map")
    p.add_argument("--c", type=int, default=128)
    p.add_argument("--groups", type=int, nargs="*", default=list(GROUPS))
    args = p.parse_args(argv)
    _util.require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    bs, n, c = args.bs, args.shape[0] * args.shape[1], args.c
    x, g, b, w_qkv, w_out, b_out, w_kv, w_eff = inputs(
        bs, n, c, torch.Generator(device="cuda").manual_seed(0))
    costs = cost(bs, n, c)
    tol = lambda want: _util.scaled_tol(want, TOL)
    tols = {"pass_a": ctx_tol, "pass_b": lambda want, v: tol(want)}
    print(f"P1 attention passes: B={bs} N={n} ({args.shape[0]}x{args.shape[1]}) "
          f"C={c} bf16 [{_util.card_line()}]")
    for name in ("pass_a", "pass_b"):
        bnd, by = _util.bound_ms(costs[name]["full"])
        print(f"  {name} full: bound {bnd:.4f} ms ({by})")

    with torch.no_grad():
        route = "K1c" if ab.FORCE_ONE_PASS else "K1a + fold + K1b"
        shipped = lambda: ab.attention_block(x, g, b, w_qkv, w_out, b_out)
        want = ab.one_pass_reference(x, g, b, w_qkv, w_out, b_out)
        _util.check("shipped block", shipped(), want, tol(want))
        del want
        ms = _util.cuda_ms(shipped, iters=5, reps=2)
        print(_util.row(f"shipped block ({route})", ms, costs["pass_b"]["full"],
                        "bytes of pass B"))
        # the shipped passes alone at this shape: K1a (pass A with the
        # heads' blocks of A alone) and K1b (pass B full's function)
        shipped_ms = {}
        for name, kind, run, ref in (
                ("probe_attn_ctx", "pass_a", lambda: ab.attention_ctx(x, g, b, w_kv),
                 lambda: ab.ctx_reference(x, g, b, w_kv)),
                ("probe_attn_out", "pass_b",
                 lambda: ab.attention_out(x, g, b, w_eff, b_out),
                 lambda: ab.out_reference(x, g, b, w_eff, b_out))):
            label = f"{SHIPPED[name]} alone (shipped pass {kind[-1].upper()})"
            want = ref()
            _util.check(label, run(), want, tol(want))
            del want
            shipped_ms[name] = _util.cuda_ms(run, iters=5, reps=2)
            print(_util.row(label, shipped_ms[name], costs[kind]["full"],
                            f"bytes and operations of {kind} full"))
        ms = _util.cuda_ms(lambda: x + 1, iters=5, reps=2)
        print(_util.row("x + 1 (read/write baseline)", ms, costs["pass_b"]["dma"]))
        check_sees_faults(x, g, b, w_kv, w_eff, b_out, token_tile(n, c, 1))

    errs = {"probe_attn_ctx": 0.0, "probe_attn_out": 0.0}
    heads = {}
    for grp in args.groups:
        if bs % grp:
            continue
        tn = token_tile(n, c, grp)
        blocks = (bs // grp) * (n // tn)
        for kind, variants, kern, plain, name in (
                ("pass_b", PASS_B,
                 lambda v: pass_b(x, g, b, w_eff, b_out, v, grp),
                 lambda v: out_plain(x, g, b, w_eff, b_out, v), "probe_attn_out"),
                ("pass_a", PASS_A,
                 lambda v: pass_a(x, g, b, w_kv, v, grp),
                 lambda v: ctx_plain(x, g, b, w_kv, v), "probe_attn_ctx")):
            for v in variants:
                want = plain(v)
                err = _util.check(f"{kind} {v} G={grp}", kern(v), want,
                                  0.0 if v == "dma" else tols[kind](want, v))
                del want
                errs[name] = max(errs[name], err)
                ms = _util.cuda_ms(lambda: kern(v), iters=5, reps=2)
                label = f"{kind[-1].upper()}-{v} G={grp}"
                print(_util.row(label, ms, costs[kind][v],
                                f"tn {tn}, {blocks} blocks, err {err:.2e}"))
                if v == "full":
                    print(f"  {kind} full / {SHIPPED[name]} alone "
                          f"({shipped_ms[name]:.3f} ms): {ms / shipped_ms[name]:.2f}x")
                if v == "full" and grp == args.groups[0]:
                    plain_ms = _util.cuda_ms(lambda: plain(v), iters=2, reps=1,
                                             warmup=1)
                    heads[name] = dict(ms=ms, plain_ms=plain_ms,
                                       cost=costs[kind][v], library_ms=None,
                                       shipped_ms=shipped_ms[name])
                    print(f"  plain version of {kind} full: {plain_ms:.3f} ms")
    for name, head in heads.items():
        head["max_abs_err"] = errs[name]
    return heads


if __name__ == "__main__":
    main()
