"""Fused residual pre-norm linear-attention block (port of
dddpm_tpu/ops/pallas/attention_block.py).

On (B, N, C) tokens:  y = x + LinearAttention(LN(x)) with LN a channel
LayerNorm (biased variance, eps added to the std), 4 heads of 32, and a
softmax over tokens of k clamped at K_CLAMP with no max subtraction.

On a CUDA tensor with more than PLAIN_PATH_MAX_TOKENS tokens it runs as
two hand-written kernels (csrc/attention_block.cu), at any channel
width C:

  pass A  (attention_ctx):  ctx = blockdiag(exp(k)^T v / sum exp(k))
  fold    (PyTorch):        W_eff = Wq . ctx . Wout, one batched einsum,
                            as the JAX package leaves it to XLA
  pass B  (attention_out):  y = x + LN(x) @ W_eff + b_out

(in bfloat16 on the tensor cores, in float32 on the FMA pipes), or, when
FORCE_ONE_PASS is set (the JAX package's own selector,
DDDPM_ATTN_ONE_PASS=1 at import), as one cooperative launch of the same
work, the fold included (attention_1pass, K1c: in bfloat16 the two
passes' own tensor-core item code with the fold in f32 between them, in
float32 the FMA items), which writes y out of place.  At or below PLAIN_PATH_MAX_TOKENS tokens, and for
every tensor on the CPU, the plain version `reference_impl` runs instead.
The backward of the kernel path is autograd through `reference_impl`, as
the JAX custom VJP does.  The kernels take heads of DIM_HEAD only (4 x 32,
the one shape every UNet of the repo builds), where JAX's function takes
any dim_head.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from dddpm_tpu_torch.ops import _build

LN_EPS = 1e-5
# exp overflow guard; LN-bounded logits never get near it, and
# exp(60) leaves ~3e12 tokens of f32 headroom for the unshifted sum
K_CLAMP = 60.0
# token count at or below which the plain version runs on the card too
# (the 16^2 sites), the same gate as the JAX package's
PLAIN_PATH_MAX_TOKENS = 512
HIDDEN = 128
DIM_HEAD = 32
TOKEN_TILE = 64           # TN in csrc/attention_block.cu
FOLD_ROWS = 16            # FOLD_ROWS in csrc/attention_block.cu
# NS in csrc/attention_block.cu: pass B forms its output in column slabs
# of this width, so it may write y over x only up to it (a later slab
# still reads the tile's x)
COLUMN_SLAB = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the one-pass route instead of the two passes, as the JAX package's
# _FORCE_ONE_PASS (dddpm_tpu/ops/pallas/attention_block.py:75): read from
# the environment at import; callers may set the module global
FORCE_ONE_PASS = os.environ.get("DDDPM_ATTN_ONE_PASS", "") == "1"

# launches of each C entry; chip_smoke.py reads these
LAUNCHES = {"attn_ctx": 0, "attn_out": 0, "attn_1pass": 0}


def layer_norm_f32(x, g, b):
    """Channel LayerNorm over the last dim in f32:
    (x - mean) / (std + eps) * g + b, with the biased variance."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mean) / (torch.sqrt(var) + LN_EPS) * g + b


def reference_impl(x, g, b, w_qkv, w_out, b_out, dim_head: int = DIM_HEAD):
    """Plain PyTorch version of the whole block on (B, N, C) tokens.

    w_qkv: (C, 3*hidden) with columns ordered (3, heads, dim_head);
    w_out: (hidden, C); g, b, b_out: (C,) f32."""
    bsz, n, _ = x.shape
    hidden = w_out.shape[0]
    heads = hidden // dim_head
    ln = layer_norm_f32(x, g, b).to(x.dtype)
    qkv = (ln @ w_qkv.to(x.dtype)).reshape(bsz, n, 3, heads, dim_head)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    # the kernels' clamp, so both compute the same function everywhere
    k = torch.softmax(k.float().clamp(max=K_CLAMP), dim=1).to(x.dtype)
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    out = torch.einsum("bhde,bnhd->bnhe", ctx, q).reshape(bsz, n, hidden)
    return x + (out @ w_out.to(x.dtype) + b_out).to(x.dtype)


def ctx_reference(x, g, b, w_kv):
    """Plain version of pass A (what attention_ctx computes):
    blockdiag over heads of exp(min(k, K_CLAMP))^T v / sum exp(min(k,
    K_CLAMP)), with [k | v] = LN(x) @ w_kv accumulated in f32."""
    bsz, n, _ = x.shape
    heads = HIDDEN // DIM_HEAD
    ln = layer_norm_f32(x, g, b).to(x.dtype).float()
    kv = ln @ w_kv.float()
    p = torch.exp(kv[..., :HIDDEN].clamp(max=K_CLAMP))
    s = p.sum(dim=1)                                   # (B, hidden)
    pm = p.to(x.dtype).float().reshape(bsz, n, heads, DIM_HEAD)
    v = kv[..., HIDDEN:].to(x.dtype).float().reshape(bsz, n, heads, DIM_HEAD)
    a = torch.einsum("bnhd,bnhe->bhde", pm, v)
    a = a / s.reshape(bsz, heads, DIM_HEAD, 1)
    return torch.stack([torch.block_diag(*a[i]) for i in range(bsz)])


def out_reference(x, g, b, w_eff, b_out):
    """Plain version of pass B: x + LN(x) @ w_eff[b] + b_out in f32."""
    ln = layer_norm_f32(x, g, b).to(x.dtype).float()
    return (x.float() + ln @ w_eff.float() + b_out).to(x.dtype)


def _check(x, g, b, *mats):
    c = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, C) tensor")
    for v in (g, b):
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError("g, b must be float32 (C,) tensors on x's device")
    for m in mats:
        if m.dtype != x.dtype or m.device != x.device or not m.is_contiguous():
            raise ValueError("weights must be contiguous, of x's dtype and device")


@functools.lru_cache(maxsize=None)
def plan(bsz: int, ntiles: int, slots: int) -> tuple:
    """(nchunks, tiles_per_chunk) for bsz samples of ntiles token tiles
    on `slots` blocks.  Items (sample, chunk) are dealt out to the blocks
    in turn; the busiest block's tiles (the span) should be near the
    least any chunking gives, and the chunks few (each writes a partial
    of pass A, and pass B loads W_eff once an item): the fewest chunks
    whose span is within 5% of the least."""
    spans = {tpc: -(-bsz * -(-ntiles // tpc) // slots) * tpc
             for tpc in range(1, ntiles + 1)}
    least = min(spans.values())
    tpc = max(t for t, span in spans.items() if span <= 1.05 * least)
    return -(-ntiles // tpc), tpc


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _per_sm(index: int, kind: int, c: int) -> int:
    """Blocks a SM holds of the tensor-core kernel of pass A (kind 0) or
    B (kind 1) at width c."""
    with torch.cuda.device(index):
        n = library().attn_mma_per_sm(kind, c)
    if n < 0:
        _build.check(-n, "attn_mma_per_sm")
    if n == 0:
        raise RuntimeError(f"no block of pass {'AB'[kind]}'s kernel fits an SM "
                           f"at C = {c}")
    return n


def _grid(x, kind: int) -> tuple:
    """(nchunks, tiles_per_chunk, grid) of a pass over x: the bf16 kernels
    are persistent (as many blocks as fit on the card, each walking
    items); the f32 kernels take a block per item, two an SM."""
    bsz, n, c = x.shape
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    per_sm = _per_sm(index, kind, c) if x.dtype == torch.bfloat16 else 2
    slots = per_sm * _sms(index)
    nchunks, tpc = plan(bsz, -(-n // TOKEN_TILE), slots)
    return nchunks, tpc, min(bsz * nchunks, slots)


def _vec(c: int, *tensors) -> int:
    """1 when the kernels may copy rows by 16 bytes: C % 8 == 0 and
    every tensor 16-byte aligned."""
    return int(c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def attention_ctx(x, g, b, w_kv):
    """Pass A kernel: ctx (B, 128, 128) f32 = blockdiag(A_h / s_h) with
    A_h = exp(min(k_h, K_CLAMP))^T v_h, [k | v] = LN(x) @ w_kv."""
    _check(x, g, b, w_kv)
    bsz, n, c = x.shape
    if w_kv.shape != (c, 2 * HIDDEN):
        raise ValueError(f"w_kv must be ({c}, {2 * HIDDEN}), got {tuple(w_kv.shape)}")
    nchunks, tpc, grid = _grid(x, 0)
    part_a = torch.empty((bsz, nchunks, 4, DIM_HEAD, DIM_HEAD),
                         dtype=torch.float32, device=x.device)
    part_s = torch.empty((bsz, nchunks, HIDDEN), dtype=torch.float32,
                         device=x.device)
    ctx = torch.empty((bsz, HIDDEN, HIDDEN), dtype=torch.float32,
                      device=x.device)
    lib = library()
    LAUNCHES["attn_ctx"] += 1
    p = _build.ptr
    _build.check(lib.attn_ctx(p(x), p(g), p(b), p(w_kv), p(part_a), p(part_s),
                              p(ctx), bsz, n, c, nchunks, tpc, grid,
                              _vec(c, x, w_kv), _DTYPES[x.dtype],
                              _build.stream(x)), "attn_ctx")
    return ctx


def attention_out(x, g, b, w_eff, b_out, out=None):
    """Pass B kernel: x + LN(x) @ w_eff[b] + b_out, written to `out`
    (a new tensor when None; `out` may be x itself: above COLUMN_SLAB
    channels the kernel then writes a new tensor, copied into x)."""
    _check(x, g, b, w_eff)
    bsz, n, c = x.shape
    if w_eff.shape != (bsz, c, c):
        raise ValueError(f"w_eff must be ({bsz}, {c}, {c})")
    if (b_out.shape != (c,) or b_out.dtype != torch.float32
            or b_out.device != x.device):
        raise ValueError("b_out must be a float32 (C,) tensor on x's device")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be contiguous and match x")
    y = (torch.empty_like(x) if c > COLUMN_SLAB and out.data_ptr() == x.data_ptr()
         else out)
    nchunks, tpc, grid = _grid(x, 1)
    lib = library()
    LAUNCHES["attn_out"] += 1
    p = _build.ptr
    _build.check(lib.attn_out(p(x), p(g), p(b), p(w_eff), p(b_out), p(y),
                              bsz, n, c, nchunks, tpc, grid,
                              _vec(c, x, w_eff, y), _DTYPES[x.dtype],
                              _build.stream(x)), "attn_out")
    if y is not out:
        out.copy_(y)
    return out


def attention_1pass(x, g, b, w_kv, w_q, w_out, b_out):
    """K1c: the whole block in one cooperative launch, out of place:
    x + LN(x) @ (Wq . blockdiag(A / s) . Wout) + b_out, with [k | v] =
    LN(x) @ w_kv and the fold in f32, rounded to x's dtype."""
    _check(x, g, b, w_kv, w_q, w_out)
    bsz, n, c = x.shape
    for name, m, shape in (("w_kv", w_kv, (c, 2 * HIDDEN)),
                           ("w_q", w_q, (c, HIDDEN)), ("w_out", w_out, (HIDDEN, c))):
        if tuple(m.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(m.shape)}")
    if (b_out.shape != (c,) or b_out.dtype != torch.float32
            or b_out.device != x.device):
        raise ValueError("b_out must be a float32 (C,) tensor on x's device")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    nchunks, tpc, grid = plan_1pass(bsz, n, c, _resident_1p(index, c, _DTYPES[x.dtype]),
                                    x.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_a = torch.empty((bsz, nchunks, 4, DIM_HEAD, DIM_HEAD), **f32)
    part_s = torch.empty((bsz, nchunks, HIDDEN), **f32)
    ctx4 = torch.empty((bsz, 4, DIM_HEAD, DIM_HEAD), **f32)
    w_eff = torch.empty((bsz, c, c), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lib = library()
    LAUNCHES["attn_1pass"] += 1
    p = _build.ptr
    _build.check(lib.attn_1p(p(x), p(g), p(b), p(w_kv), p(w_q), p(w_out),
                             p(b_out), p(part_a), p(part_s), p(ctx4), p(w_eff),
                             p(y), bsz, n, c, nchunks, tpc, grid,
                             _vec(c, x, w_kv, w_eff, y), _DTYPES[x.dtype],
                             _build.stream(x)), "attn_1p")
    return y


def plan_1pass(bsz: int, n: int, c: int, resident: int, tensor_cores: bool) -> tuple:
    """(nchunks, tiles_per_chunk, grid) of the one-pass kernel on at most
    `resident` blocks.  The tensor-core kernel chunks pass A's and B's
    items as the two-pass kernels do (`plan`); the FMA kernel takes a
    chunk a block.  The grid covers the largest phase: the chunks, the
    fold's row blocks or the reduce's heads."""
    ntiles = -(-n // TOKEN_TILE)
    folds = -(-c // FOLD_ROWS)
    if tensor_cores:
        nchunks, tpc = plan(bsz, ntiles, resident)
        return nchunks, tpc, min(resident, max(bsz * nchunks, bsz * folds, bsz * 4))
    grid = min(resident, max(bsz * ntiles, bsz * folds))
    want = min(ntiles, max(1, grid // bsz))
    tpc = -(-ntiles // want)
    return -(-ntiles // tpc), tpc, grid


@functools.lru_cache(maxsize=None)
def _resident_1p(index: int, c: int, dtype: int) -> int:
    """Blocks of the one-pass kernel for (c, dtype) that fit on card
    `index` at once: its grid's largest size."""
    with torch.cuda.device(index):
        resident = library().attn_1p_resident(c, dtype)
    if resident < 0:
        _build.check(-resident, "attn_1p_resident")
    if resident == 0:
        raise RuntimeError("the card cannot hold a block of the one-pass kernel "
                           "(or launch cooperatively)")
    return resident


def library(defines=()):
    """csrc/attention_block.cu's library built with `defines` (the
    ablation probe's ATTN_SKIP), its C entries typed."""
    lib = _build.load("attention_block", tuple(defines))
    if lib.attn_ctx.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_ctx.argtypes = [vp] * 7 + [i] * 8 + [vp]
        lib.attn_ctx.restype = i
        lib.attn_out.argtypes = [vp] * 6 + [i] * 8 + [vp]
        lib.attn_out.restype = i
        lib.attn_mma_per_sm.argtypes = [i, i]
        lib.attn_mma_per_sm.restype = i
        lib.attn_1p_resident.argtypes = [i, i]
        lib.attn_1p_resident.restype = i
        lib.attn_1p.argtypes = [vp] * 12 + [i] * 8 + [vp]
        lib.attn_1p.restype = i
    return lib


def fold_w_eff(w_q, ctx, w_out, dtype):
    """W_eff[b] = Wq . ctx[b] . Wout in f32, cast to the token dtype."""
    return torch.einsum("ch,bhg,gf->bcf", w_q.float(), ctx,
                        w_out.float()).to(dtype).contiguous()


def one_pass_reference(x, g, b, w_qkv, w_out, b_out):
    """Plain version of the one-pass kernel (and of the two passes with
    the fold between them): ctx_reference, fold_w_eff, out_reference."""
    c = x.shape[-1]
    w_q, w_k, w_v = (w_qkv.reshape(c, 3, HIDDEN)[:, i] for i in range(3))
    ctx = ctx_reference(x, g, b, torch.cat([w_k, w_v], dim=1).to(x.dtype))
    return out_reference(x, g, b, fold_w_eff(w_q, ctx, w_out, x.dtype), b_out)


def _fused_forward(x, g, b, w_qkv, w_out, b_out, inplace: bool):
    c = x.shape[-1]
    w_q, w_k, w_v = (w_qkv.reshape(c, 3, HIDDEN)[:, i] for i in range(3))
    w_kv = torch.cat([w_k, w_v], dim=1).to(x.dtype).contiguous()
    if FORCE_ONE_PASS:    # out of place whatever `inplace` says, as JAX's
        return attention_1pass(x, g, b, w_kv, w_q.to(x.dtype).contiguous(),
                               w_out.to(x.dtype).contiguous(), b_out)
    ctx = attention_ctx(x, g, b, w_kv)
    w_eff = fold_w_eff(w_q, ctx, w_out, x.dtype)
    return attention_out(x, g, b, w_eff, b_out, out=x if inplace else None)


class _AttentionBlockFn(torch.autograd.Function):
    """Kernel forward; backward is autograd through `reference_impl`."""

    @staticmethod
    def forward(ctx, x, g, b, w_qkv, w_out, b_out):
        ctx.save_for_backward(x, g, b, w_qkv, w_out, b_out)
        return _fused_forward(x, g, b, w_qkv, w_out, b_out, inplace=False)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = reference_impl(*inputs)
            want = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(y, want, grad))
        return tuple(next(got) if t.requires_grad else None for t in inputs)


def attention_block(x, g, b, w_qkv, w_out, b_out, dim_head: int = DIM_HEAD,
                    inplace: bool = False):
    """Fused residual pre-norm linear-attention block on (B, N, C).

    g, b: (C,) LayerNorm params; w_qkv: (C, 3*hidden); w_out: (hidden, C);
    b_out: (C,) f32.  On a CPU tensor the plain version runs.  On a CUDA
    tensor with N > PLAIN_PATH_MAX_TOKENS the kernels run at any width C
    (the one-pass kernel when FORCE_ONE_PASS is set); any input they do
    not take raises.
    inplace=True lets pass B write y over x (the one-pass kernel always
    writes a new tensor); it is allowed only when no gradient is recorded
    (torch.no_grad()), since autograd would need the x that it
    overwrites."""
    if x.device.type == "cpu" or x.shape[1] <= PLAIN_PATH_MAX_TOKENS:
        return reference_impl(x, g, b, w_qkv, w_out, b_out, dim_head)
    if w_out.shape[0] != HIDDEN or dim_head != DIM_HEAD:
        raise ValueError(f"kernel takes hidden {HIDDEN} as heads of {DIM_HEAD}")
    if w_qkv.shape != (x.shape[-1], 3 * HIDDEN):
        raise ValueError(f"w_qkv must be (C, {3 * HIDDEN})")
    grads = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, g, b, w_qkv, w_out, b_out))
    if grads:
        if inplace:
            raise ValueError("inplace=True only under torch.no_grad()")
        return _AttentionBlockFn.apply(x, g, b, w_qkv, w_out, b_out)
    return _fused_forward(x, g, b, w_qkv, w_out, b_out, inplace)


def cost(bsz: int, n: int, c: int, itemsize: int) -> dict:
    """Bytes each route must move and FLOPs it must do (for bounds):
    pass A reads x and w_kv and writes ctx; pass B reads x and W_eff and
    writes y; the one-pass kernel reads x and the three weights once and
    writes y, and does pass A's, the fold's and pass B's products.  Only
    the block diagonal of A is needed."""
    return {
        "attn_1pass": {
            "bytes": 2 * bsz * n * c * itemsize + 4 * c * HIDDEN * itemsize
            + 3 * c * 4,
            "flops": bsz * n * (2 * c * 2 * HIDDEN + 2 * HIDDEN * DIM_HEAD
                                + 2 * c * c + 18 * c)
            + bsz * (2 * c * HIDDEN * DIM_HEAD + 2 * c * HIDDEN * c),
        },
        "attn_ctx": {
            "bytes": bsz * n * c * itemsize + c * 2 * HIDDEN * itemsize
            + bsz * HIDDEN * HIDDEN * 4,
            "flops": bsz * n * (2 * c * 2 * HIDDEN        # kv product
                                + 2 * HIDDEN * DIM_HEAD    # blockdiag A
                                + 8 * c),                  # LN
        },
        "attn_out": {
            "bytes": 2 * bsz * n * c * itemsize + bsz * c * c * itemsize,
            "flops": bsz * n * (2 * c * c + 10 * c),
        },
    }

