"""UNet building blocks (port of dddpm_tpu/models/blocks.py).

Modules take and return NCHW tensors; the UNet keeps them in
torch.channels_last memory, so cuDNN runs NHWC convolutions and the
attention kernel gets its (B, N, C) tokens by a permute with no copy.
Parameters stay float32; `compute_dtype` (bf16 on the main path) is the
type the convolutions and the attention block run in, while GroupNorm
statistics and the time embedding stay float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dddpm_tpu_torch.ops.attention_block import (
    DIM_HEAD,
    attention_block,
    reference_impl,
)
from dddpm_tpu_torch.ops.math import mish
from dddpm_tpu_torch.ops.quant import (
    int8_conv_q,
    observed_amax,
    prepare_weight,
    quant_conv_wins,
)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in `compute_dtype` with float32 parameters,
    as a flax nn.Conv with dtype= does.  The counterpart of the JAX
    package's nn.Conv, Conv3x3Params and ConvParams1x1 (the last two
    take the concat-free skip operand).

    With quant='int8' (the opt-in W8A8 serving mode, ops/quant.py) each
    operand of a 3x3 conv that `quant_conv_wins` admits runs as the s8
    conv, with a calibrated absmax held in the buffer `amax_x` (x, or
    the first `split` input channels when the conv takes a skip operand)
    or `amax_skip` (the skip operand, the channels after them): 0 until
    calibrated, saved in the state_dict.  `quant_mode` is 'serve', or
    'calibrate' (raise the amax with each input first, then run the s8
    conv with it) or 'off' (the float path on the same weights); see
    `quant_mode` below.  The s8 weights are made once and kept until the
    weight changes.  Forward only: the s8 conv has no gradient."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, bias: bool = True,
                 compute_dtype=torch.float32, quant: Optional[str] = None,
                 split: Optional[int] = None):
        super().__init__(in_features, features, kernel, stride,
                         (kernel - 1) // 2, bias=bias)
        self.compute_dtype = compute_dtype
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be 'int8' or None, got {quant!r}")
        self.split = split
        self.quant_mode = "serve"
        self.quant_sites = []
        if quant == "int8" and kernel == 3:
            halves = ([("amax_x", in_features)] if split is None else
                      [("amax_x", split), ("amax_skip", in_features - split)])
            gated = [quant_conv_wins(3, 0, cin, features, stride)
                     for _, cin in halves]
            if any(gated) and not all(gated):
                raise ValueError(
                    f"a {in_features} -> {features} conv split at {split} "
                    f"quantizes one operand only, which is not supported")
            if all(gated):
                self.quant_sites = [name for name, _ in halves]
        for name in self.quant_sites:
            self.register_buffer(name, torch.zeros((), dtype=torch.float32))
        self._qweights = None

    def _quant_weights(self) -> list:
        """(QWeight per operand), rebuilt when the weight changes."""
        key = (self.weight._version, self.weight.data_ptr(), self.weight.device)
        if self._qweights is None or self._qweights[0] != key:
            with torch.no_grad():
                w = self.weight.detach()
                parts = ([w] if self.split is None else
                         [w[:, :self.split], w[:, self.split:]])
                self._qweights = (key, [prepare_weight(p) for p in parts])
        return self._qweights[1]

    def _forward_int8(self, x, skip):
        dt = self.compute_dtype
        ops = [x.to(dt)] + ([] if skip is None else [skip.to(dt)])
        if self.quant_mode == "calibrate":
            with torch.no_grad():
                for name, v in zip(self.quant_sites, ops):
                    getattr(self, name).copy_(observed_amax(v, getattr(self, name)))
        amaxes = [getattr(self, name) for name in self.quant_sites]
        qws = self._quant_weights()
        bias = None if self.bias is None else self.bias.detach()
        if skip is None:
            return int8_conv_q(ops[0], qws[0], amaxes[0], bias=bias)
        return int8_conv_q(ops[0], qws[0], amaxes[0], ops[1], qws[1],
                           amaxes[1], bias=bias)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`skip` is concatenated onto x's channels without forming the
        concat: conv(cat(x, s), W) == conv(x, W[:, :Cx]) + conv(s, W[:, Cx:])."""
        if self.quant_sites and self.quant_mode != "off":
            if (skip is None) != (self.split is None):
                raise ValueError("a quantized conv takes a skip operand "
                                 "exactly when it was built with split")
            return self._forward_int8(x, skip)
        dt = self.compute_dtype
        x = x.to(dt)
        w = self.weight.to(dt)
        if skip is None:
            y = self._conv_forward(x, w, None)
        else:
            cx = x.shape[1]
            y = (self._conv_forward(x, w[:, :cx], None)
                 + self._conv_forward(skip.to(dt), w[:, cx:], None))
        if self.bias is not None:
            y = y + self.bias.to(dt)[None, :, None, None]
        return y


@contextlib.contextmanager
def quant_mode(net: nn.Module, mode: str) -> Iterator[None]:
    """Sets every quantized conv of `net` to `mode` ('serve', 'calibrate'
    or 'off') inside the block and back after it."""
    if mode not in ("serve", "calibrate", "off"):
        raise ValueError(f"unknown quant mode {mode!r}")
    convs = [m for m in net.modules() if isinstance(m, Conv2d) and m.quant_sites]
    saved = [m.quant_mode for m in convs]
    for m in convs:
        m.quant_mode = mode
    try:
        yield
    finally:
        for m, old in zip(convs, saved):
            m.quant_mode = old


def quant_buffers(net: nn.Module) -> dict:
    """{state_dict key: amax buffer} of every quantized conv operand."""
    return {name: buf for name, buf in net.named_buffers()
            if name.rsplit(".", 1)[-1] in ("amax_x", "amax_skip")}


class ConvTranspose4x4(nn.ConvTranspose2d):
    """4x4 stride-2 transposed conv doubling H and W (flax
    ConvTranspose((4, 4), (2, 2), 'SAME')), run in `compute_dtype`."""

    def __init__(self, in_features: int, features: int,
                 compute_dtype=torch.float32):
        super().__init__(in_features, features, 4, 2, 1)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), 2, 1)


class SinusoidalPosEmb(nn.Module):
    """Transformer-style timestep embedding, always float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        scale = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=t.device) * -scale)
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimeMLP(nn.Module):
    """SinusoidalPosEmb -> Linear(4*dim) -> Mish -> Linear(dim), float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.pos = SinusoidalPosEmb(dim)
        self.dense0 = nn.Linear(dim, 4 * dim)
        self.dense1 = nn.Linear(4 * dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.dense1(mish(self.dense0(self.pos(t))))


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels (dim 1) with the biased variance and eps
    added to the std: (x - mean) / (std + eps) * g + b, in float32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, keepdim=True, unbiased=False)
        out = ((xf - mean) / (torch.sqrt(var) + self.eps)
               * self.g[None, :, None, None] + self.b[None, :, None, None])
        return out.to(x.dtype)


class Block(nn.Module):
    """Conv3x3 -> GroupNorm(groups) with float32 statistics -> Mish."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8,
                 compute_dtype=torch.float32, quant: Optional[str] = None,
                 split: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = Conv2d(dim, dim_out, 3, compute_dtype=compute_dtype,
                           quant=quant, split=split)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, skip=None):
        x = self.norm(self.conv(x, skip).float())
        return mish(x).to(self.compute_dtype)


class ResnetBlock(nn.Module):
    """Two Blocks with a time-embedding channel bias between them and a
    residual (a 1x1 conv where the width changes).  `skip` is the
    expansive path's skip connection, logically concatenated onto x;
    `skip_dim` is its width where the block takes one (the x half of the
    input is then dim - skip_dim channels).  `quant` goes to the two
    Blocks' 3x3 convs; the residual 1x1 stays in compute_dtype."""

    def __init__(self, dim: int, dim_out: int, time_dim: int,
                 groups: int = 8, dropout: float = 0.0,
                 compute_dtype=torch.float32, quant: Optional[str] = None,
                 skip_dim: int = 0):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block0 = Block(dim, dim_out, groups, compute_dtype, quant,
                            split=dim - skip_dim if skip_dim else None)
        self.time_proj = nn.Linear(time_dim, dim_out)
        self.drop = nn.Dropout(dropout)
        self.block1 = Block(dim_out, dim_out, groups, compute_dtype, quant)
        self.res_conv = (Conv2d(dim, dim_out, 1, compute_dtype=compute_dtype)
                         if dim != dim_out else None)

    def forward(self, x, time_emb, skip=None):
        h = self.block0(x, skip)
        t = self.time_proj(mish(time_emb))
        h = h + t[:, :, None, None].to(self.compute_dtype)
        h = self.block1(self.drop(h))
        if self.res_conv is not None:
            return h + self.res_conv(x, skip)
        return h + (x if skip is None else torch.cat([x, skip], dim=1))


class LinearAttention(nn.Module):
    """Parameters of the linear attention: the qkv projection (columns
    ordered (3, heads, dim_head)) and the output projection."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = DIM_HEAD,
                 compute_dtype=torch.float32):
        super().__init__()
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, 3 * hidden, 1, bias=False,
                             compute_dtype=compute_dtype)
        self.to_out = Conv2d(hidden, dim, 1, compute_dtype=compute_dtype)

    def matrices(self, dtype):
        """(w_qkv (C, 3*hidden), w_out (hidden, C)) in `dtype`."""
        return (self.to_qkv.weight[:, :, 0, 0].t().to(dtype),
                self.to_out.weight[:, :, 0, 0].t().to(dtype))


class PreNormLinearAttention(nn.Module):
    """x + LinearAttention(ChannelLayerNorm(x)) as one fused block
    (ops/attention_block.py): the two kernels on the card above 512
    tokens, the plain version otherwise.  Under torch.no_grad() on the
    card the result is written over x's storage (in the UNet nothing
    reads x after the block), as the JAX kernel aliases its output.
    With use_pallas False (the config's use_pallas_attention, as the
    JAX module's flag) the plain version runs on the card too."""

    def __init__(self, dim: int, compute_dtype=torch.float32,
                 use_pallas: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
        self.norm = ChannelLayerNorm(dim)
        self.attn = LinearAttention(dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        # no copy when x is channels_last
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()
        w_qkv, w_out = self.attn.matrices(self.compute_dtype)
        args = (tokens, self.norm.g, self.norm.b, w_qkv, w_out,
                self.attn.to_out.bias.float(), self.attn.dim_head)
        if self.use_pallas:
            # without autograd the block owns its input and writes over it
            out = attention_block(*args, inplace=not torch.is_grad_enabled())
        else:
            out = reference_impl(*args)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Downsample(Conv2d):
    """Stride-2 conv3x3 halving H and W."""

    def __init__(self, dim: int, compute_dtype=torch.float32):
        super().__init__(dim, dim, 3, stride=2, compute_dtype=compute_dtype)


class Upsample(ConvTranspose4x4):
    """4x4 stride-2 transposed conv doubling H and W."""

    def __init__(self, dim: int, compute_dtype=torch.float32):
        super().__init__(dim, dim, compute_dtype)
