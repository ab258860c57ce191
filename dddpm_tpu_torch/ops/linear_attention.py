"""Linear attention over (B, N, heads * dim_head) tensors (port of
dddpm_tpu/ops/pallas/linear_attention.py).

    ctx = blockdiag over heads of softmax_tokens(k)^T v       (f32)
    out = q @ ctx

No model of either package calls it: the UNets' attention is the fused
block of ops/attention_block.py, whatever the JAX module's docstring
says of the UNet.  Its callers are the tests and chip_smoke.py.

On a CUDA tensor the forward is two hand-written kernels
(csrc/linear_attention.cu, K4): `linear_attention_ctx`, per-chunk
softmax partials with their own running max, merged in chunk order,
and `linear_attention_out`, the q product with ctx rounded to q's
dtype, as the TPU kernel rounds it.  In bfloat16 both run their
products on the tensor cores; the ctx kernel splits p into a bf16 pair
(hi = bf16(p), lo = bf16(p - hi)) and multiplies both, so ctx keeps
f32's accuracy, as the TPU kernel's f32 product does.  In float32 they
are FMA loops.  The kernels take heads of any multiple of 32
dimensions; `linear_attention` takes any dim_head and zero-pads each
head to the next multiple of 32 (`pad_heads`), which is exact: a padded
k dimension's softmax is uniform over the tokens but meets a zero q
dimension, and a padded v dimension gives a zero column, sliced off.
On a CPU tensor `plain` runs, which repeats the kernels' roundings.
The backward is autograd through `reference_impl`, as the JAX custom
VJP does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dddpm_tpu_torch.ops import _build

DIM_HEAD = 32
HEAD_STEP = 32            # the kernels' heads: multiples of 32 dimensions
TOKEN_TILE = 64           # TN in csrc/linear_attention.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each C entry; chip_smoke.py reads these
LAUNCHES = {"lin_ctx": 0, "lin_out": 0}


def _split(t, dim_head):
    b, n, hd = t.shape
    return t.reshape(b, n, hd // dim_head, dim_head)


def reference_impl(q, k, v, dim_head: int = DIM_HEAD):
    """The JAX package's _reference_impl: softmax over tokens in f32,
    ctx and out in f32, rounded to q's dtype."""
    b, n, hd = q.shape
    kh = torch.softmax(_split(k, dim_head).float(), dim=1)
    ctx = torch.einsum("bnhd,bnhe->bhde", kh, _split(v, dim_head).float())
    out = torch.einsum("bhde,bnhd->bnhe", ctx, _split(q, dim_head).float())
    return out.reshape(b, n, hd).to(q.dtype)


def ctx_plain(k, v, dim_head: int = DIM_HEAD):
    """The kernel's ctx (B, heads, d, d) f32: exp(k - max) summed over
    tokens, the products with v in f32, row d divided by s_d."""
    kf = _split(k, dim_head).float()
    p = torch.exp(kf - kf.amax(dim=1, keepdim=True))
    a = torch.einsum("bnhd,bnhe->bhde", p, _split(v, dim_head).float())
    return a / p.sum(dim=1)[..., None]


def out_plain(q, ctx):
    """The kernel's out from ctx (B, heads, d, d): q @ ctx rounded to q's
    dtype, f32 sums, rounded to q's dtype."""
    b, n, hd = q.shape
    c = ctx.to(q.dtype).float()
    out = torch.einsum("bhde,bnhd->bnhe", c, _split(q, c.shape[-1]).float())
    return out.reshape(b, n, hd).to(q.dtype)


def plain(q, k, v, dim_head: int = DIM_HEAD):
    """Plain PyTorch version of the kernels: out_plain(q, ctx_plain)."""
    return out_plain(q, ctx_plain(k, v, dim_head))


def blocks_of(ctx, dim_head: int = DIM_HEAD):
    """The heads' diagonal blocks (B, heads, d, d) of the kernel's ctx
    (B, HD, HD)."""
    b, hd, _ = ctx.shape
    heads = hd // dim_head
    c = ctx.reshape(b, heads, dim_head, heads, dim_head)
    return torch.stack([c[:, h, :, h] for h in range(heads)], dim=1)


def pad_heads(t, dim_head: int):
    """(B, N, heads * dim_head) -> (B, N, heads * dp), each head's
    dimensions zero-padded to dp, the next multiple of HEAD_STEP; t
    itself where dim_head is one."""
    dp = -(-dim_head // HEAD_STEP) * HEAD_STEP
    if dp == dim_head:
        return t
    b, n, hd = t.shape
    out = t.new_zeros((b, n, hd // dim_head, dp))
    out[..., :dim_head] = _split(t, dim_head)
    return out.reshape(b, n, -1)


def unpad_heads(t, dim_head: int):
    """The inverse of pad_heads: each head's first dim_head dimensions."""
    dp = -(-dim_head // HEAD_STEP) * HEAD_STEP
    if dp == dim_head:
        return t
    b, n, _ = t.shape
    return _split(t, dp)[..., :dim_head].reshape(b, n, -1).contiguous()


def _lib():
    lib = _build.load("linear_attention")
    if lib.lin_ctx.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.lin_ctx.argtypes = [vp] * 6 + [i] * 7 + [vp]
        lib.lin_ctx.restype = i
        lib.lin_out.argtypes = [vp] * 3 + [i] * 5 + [vp]
        lib.lin_out.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _chunks(bsz: int, n: int, device) -> tuple:
    """(nchunks, tiles_per_chunk): token tiles of a sample are spread
    over enough blocks that every SM gets about two."""
    ntiles = -(-n // TOKEN_TILE)
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _sms(index)
    want = min(ntiles, max(1, -(-2 * sms // bsz)))
    tpc = -(-ntiles // want)
    return -(-ntiles // tpc), tpc


def _check(ts, dim_head):
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 3:
        raise ValueError("q, k, v must be (B, N, heads * dim_head)")
    for t in ts:
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError("q, k, v must be contiguous and match in shape, "
                             "dtype and device")
    hd = q.shape[-1]
    if dim_head < 1 or hd % dim_head:
        raise ValueError(f"q, k, v's width {hd} is not heads of {dim_head}")


def _check_kernel(ts, dim_head):
    """_check, and the kernels' own head width: a multiple of HEAD_STEP."""
    _check(ts, dim_head)
    if dim_head % HEAD_STEP:
        raise ValueError(f"the kernels take heads of a multiple of "
                         f"{HEAD_STEP} dimensions, got {dim_head} (pad_heads)")


def linear_attention_ctx(k, v, dim_head: int = DIM_HEAD):
    """K4, the ctx kernel: (B, HD, HD) f32, blockdiag over heads of
    (exp(k - m)^T v) / sum exp(k - m), m the max over tokens; dim_head
    a multiple of HEAD_STEP."""
    _check_kernel((k, v), dim_head)
    k, v = _build.aligned(k), _build.aligned(v)   # 16-byte loads
    bsz, n, hd = k.shape
    nchunks, tpc = _chunks(bsz, n, k.device)
    # the partials (m, s, the heads' blocks of A) in one scratch tensor
    slots = bsz * nchunks
    scratch = torch.empty(slots * (2 * hd + hd * dim_head), dtype=torch.float32,
                          device=k.device)
    part_m, part_s, part_a = scratch.split([slots * hd, slots * hd,
                                            slots * hd * dim_head])
    ctx = torch.empty((bsz, hd, hd), dtype=torch.float32, device=k.device)
    lib = _lib()
    LAUNCHES["lin_ctx"] += 1
    p = _build.ptr
    _build.check(lib.lin_ctx(p(k), p(v), p(part_m), p(part_s), p(part_a), p(ctx),
                             bsz, n, hd, dim_head, nchunks, tpc, _DTYPES[k.dtype],
                             _build.stream(k)), "lin_ctx")
    return ctx


def linear_attention_out(q, ctx, dim_head: int = DIM_HEAD):
    """K4, the out kernel: q @ ctx (B, HD, HD, f32) over each head's
    block, ctx rounded to q's dtype, f32 sums, rounded to q's dtype;
    dim_head a multiple of HEAD_STEP."""
    _check_kernel((q,), dim_head)
    bsz, n, hd = q.shape
    if (ctx.shape != (bsz, hd, hd) or ctx.dtype != torch.float32
            or ctx.device != q.device or not ctx.is_contiguous()):
        raise ValueError(f"ctx must be a contiguous float32 ({bsz}, {hd}, {hd}) "
                         f"tensor on q's device")
    q = _build.aligned(q)
    out = torch.empty_like(q)
    lib = _lib()
    LAUNCHES["lin_out"] += 1
    p = _build.ptr
    _build.check(lib.lin_out(p(q), p(ctx), p(out), bsz, n, hd, dim_head,
                             _DTYPES[q.dtype],
                             _build.stream(q)), "lin_out")
    return out


def _kernel(q, k, v, dim_head):
    """K4 on CUDA tensors, each head zero-padded to a multiple of
    HEAD_STEP dimensions where it is not one; raises on what it does not
    take."""
    _check((q, k, v), dim_head)
    dp = -(-dim_head // HEAD_STEP) * HEAD_STEP
    qp, kp, vp = (pad_heads(t, dim_head) for t in (q, k, v))
    out = linear_attention_out(qp, linear_attention_ctx(kp, vp, dp), dp)
    return unpad_heads(out, dim_head)


class _LinearAttentionFn(torch.autograd.Function):
    """Kernel (or plain, on the CPU) forward; backward is autograd through
    `reference_impl`."""

    @staticmethod
    def forward(ctx, q, k, v, dim_head):
        ctx.dim_head = dim_head
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return plain(q, k, v, dim_head)
        return _kernel(q, k, v, dim_head)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = reference_impl(*inputs, ctx.dim_head)
            want = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(y, want, grad))
        return (*(next(got) if t.requires_grad else None for t in inputs), None)


def linear_attention(q, k, v, dim_head: int = DIM_HEAD) -> torch.Tensor:
    """Linear attention over (B, N, heads * dim_head) tensors.  A CPU
    tensor takes `plain`; a CUDA tensor launches K4 or raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return _LinearAttentionFn.apply(q, k, v, dim_head)


def cost(bsz: int, n: int, hd: int, itemsize: int,
         dim_head: int = DIM_HEAD) -> dict:
    """Bytes each K4 kernel must move and FLOPs it must do: the ctx
    kernel reads k and v once and writes ctx (exp, max and sum ~4 a
    value, the diagonal blocks of p^T v 2 x dim_head); the out kernel
    reads q and ctx once and writes out (2 x dim_head a value)."""
    ctx_bytes = bsz * hd * hd * 4
    return {"lin_ctx": {"bytes": 2 * bsz * n * hd * itemsize + ctx_bytes,
                        "flops": bsz * n * hd * (4 + 2 * dim_head)},
            "lin_out": {"bytes": 2 * bsz * n * hd * itemsize + ctx_bytes,
                        "flops": bsz * n * hd * 2 * dim_head}}
