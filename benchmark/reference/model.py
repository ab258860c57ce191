"""The dDDPM networks in plain PyTorch, NCHW, float32 parameters.

Written from the model's published description (the lucidrains-style
UNet with linear attention at each resolution, the pre-activation
ConvResNet resamplers of simonamtoft/downsampled-diffusion), with the
quirks the benchmarked program keeps:

- the expansive path has len(dim_mults) - 1 levels, so the first skip
  is computed and never read, and every expansive level ends in an
  upsample;
- the attention is x + to_out(ctx^T q) over LN(x), with k softmaxed over
  the tokens (k clamped at 60 first) and no softmax on q;
- LayerNorm divides by std + eps with the biased variance.

Parameter names equal the program's, so one set of drawn weights loads
into both.  Every convolution and matmul takes its operands through
`precision.operand` at the module's `prec` ('f32' unless a control sets
another, see `set_precision`).  Dropout (the contracting path's
ResnetBlocks, `unet_dropout`) takes the masks the benchmark hands it
(`ResnetBlock.mask`): the reference draws none of its own, and without
masks it runs as in eval mode.

The int8 serving mode (W8A8, `mark_int8`) quantizes each 3x3 conv of
the UNet's Blocks whose every operand keeps its width of 128 channels
or more: the weights per output channel and each operand (x, and the
skip concatenated onto it) per tensor, symmetric, round half to even,
with the scale of an absmax held in `amax` (raised by each input while
`mode` is 'observe'); y is the sum of each operand's integer product
times its two scales, plus the bias.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import operand

HEADS, DIM_HEAD, K_CLAMP, LN_EPS, GROUPS = 4, 32, 60.0, 1e-5, 8


def mish(x):
    return x * torch.tanh(F.softplus(x))


class _Op(nn.Module):
    prec = "f32"

    def q(self, x):
        return operand(x, self.prec)


class Conv(_Op):
    """A conv over x and, where `split` is set, a skip concatenated onto
    x's channels after the first `split`."""

    levels = 0      # 127 (int8) or 7 (int4) once mark_int8 gates it
    mode = "serve"  # or 'observe' (raise amax first) or 'off' (float)

    def __init__(self, cin, cout, k, stride=1, bias=True, split=None):
        super().__init__()
        self.stride, self.pad, self.split = stride, (k - 1) // 2, split
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x, skip=None):
        if self.levels and self.mode != "off":
            return self._quantized([x] if skip is None else [x, skip])
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return F.conv2d(self.q(x), self.q(self.weight), self.bias,
                        self.stride, self.pad)

    def _quantized(self, ops):
        lv, y = float(self.levels), 0.0
        ws_parts = ([self.weight] if len(ops) == 1 else
                    [self.weight[:, :self.split], self.weight[:, self.split:]])
        for v, w, amax in zip(ops, ws_parts, self.amax):
            if self.mode == "observe":
                amax.copy_(torch.maximum(amax, v.abs().amax()))
            ws = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / lv
            wq = torch.clamp(torch.round(w / ws[:, None, None, None]), -lv, lv)
            xs = amax.clamp_min(1e-12) / lv
            xq = torch.clamp(torch.round(v / xs), -lv, lv)
            y = y + F.conv2d(xq, wq, None, 1, 1) * (xs * ws)[None, :, None, None]
        return y + self.bias[None, :, None, None]


class ConvT(_Op):
    """4x4 stride-2 transposed conv doubling H and W."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias,
                                  2, 1)


class Linear(_Op):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class GroupNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.group_norm(x, GROUPS, self.weight, self.bias, 1e-5)


class Block(nn.Module):
    """conv3x3 (over x and the skip, concatenated) -> GroupNorm -> mish."""

    def __init__(self, cin, cout, split=None):
        super().__init__()
        self.conv = Conv(cin, cout, 3, split=split)
        self.norm = GroupNorm(cout)

    def forward(self, x, skip=None):
        return mish(self.norm(self.conv(x, skip)))


class ResnetBlock(nn.Module):
    """`skip_dim`: the width of the skip the block takes, if any (its
    input is then x's cin - skip_dim channels and the skip's)."""

    def __init__(self, cin, cout, time_dim, skip_dim=0, dropout=0.0):
        super().__init__()
        self.dropout, self.mask = dropout, None
        self.block0 = Block(cin, cout, split=cin - skip_dim if skip_dim else None)
        self.time_proj = Linear(time_dim, cout)
        self.block1 = Block(cout, cout)
        self.res_conv = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, t_emb, skip=None):
        h = self.block0(x, skip) + self.time_proj(mish(t_emb))[:, :, None, None]
        if self.mask is not None:   # the kept elements, scaled up
            h = h * self.mask * (1.0 / (1.0 - self.dropout))
        h = self.block1(h)
        if self.res_conv is not None:
            return h + self.res_conv(x, skip)
        return h + (x if skip is None else torch.cat([x, skip], dim=1))


class ChannelNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.g = nn.Parameter(torch.empty(dim))
        self.b = nn.Parameter(torch.empty(dim))


class LinearAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.to_qkv = Conv(dim, 3 * HEADS * DIM_HEAD, 1, bias=False)
        self.to_out = Conv(HEADS * DIM_HEAD, dim, 1)


class PreNormLinearAttention(_Op):
    def __init__(self, dim):
        super().__init__()
        self.norm = ChannelNorm(dim)
        self.attn = LinearAttention(dim)

    def forward(self, x):
        b, c, h, w = x.shape
        tok = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        mean = tok.mean(-1, keepdim=True)
        std = tok.var(-1, keepdim=True, unbiased=False).sqrt()
        ln = (tok - mean) / (std + LN_EPS) * self.norm.g + self.norm.b
        w_qkv = self.attn.to_qkv.weight[:, :, 0, 0].t()
        qkv = (self.q(ln) @ self.q(w_qkv)).reshape(b, h * w, 3, HEADS,
                                                   DIM_HEAD)
        q, k, v = qkv.unbind(2)
        k = torch.softmax(k.clamp(max=K_CLAMP), dim=1)
        ctx = torch.einsum("bnhd,bnhe->bhde", self.q(k), self.q(v))
        out = torch.einsum("bhde,bnhd->bnhe", self.q(ctx), self.q(q))
        w_out = self.attn.to_out.weight[:, :, 0, 0].t()
        y = (self.q(out.reshape(b, h * w, HEADS * DIM_HEAD)) @ self.q(w_out)
             + self.attn.to_out.bias)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class TimeMLP(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.dense0 = Linear(dim, 4 * dim)
        self.dense1 = Linear(4 * dim, dim)

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=t.device)
                          * -(math.log(10000.0) / (half - 1)))
        args = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
        return self.dense1(mish(self.dense0(emb)))


class Unet(nn.Module):
    def __init__(self, dim, in_channels, dim_mults, dropout=0.0):
        super().__init__()
        dims = [in_channels] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.levels = len(in_out)
        self.time_mlp = TimeMLP(dim)
        resnets, attns, downs, ups = [], [], [], []
        for ind, (d_in, d_out) in enumerate(in_out):
            resnets += [ResnetBlock(d_in, d_out, dim, dropout=dropout),
                        ResnetBlock(d_out, d_out, dim, dropout=dropout)]
            attns.append(PreNormLinearAttention(d_out))
            if ind < self.levels - 1:
                downs.append(Conv(d_out, d_out, 3, stride=2))
        mid = dims[-1]
        resnets += [ResnetBlock(mid, mid, dim)]
        attns.append(PreNormLinearAttention(mid))
        resnets += [ResnetBlock(mid, mid, dim)]
        for d_in, d_out in reversed(in_out[1:]):
            resnets += [ResnetBlock(d_out * 2, d_in, dim, skip_dim=d_out),
                        ResnetBlock(d_in, d_in, dim)]
            attns.append(PreNormLinearAttention(d_in))
            ups.append(ConvT(d_in, d_in))
        self.resnets = nn.ModuleList(resnets)
        self.attns = nn.ModuleList(attns)
        self.downsamples = nn.ModuleList(downs)
        self.upsamples = nn.ModuleList(ups)
        self.final_block = Block(dim, dim)
        self.final_conv = Conv(dim, in_channels, 1)

    def forward(self, x, t):
        t_emb = self.time_mlp(t)
        res, attn = iter(self.resnets), iter(self.attns)
        downs, ups = iter(self.downsamples), iter(self.upsamples)
        skips = []
        for ind in range(self.levels):
            x = next(res)(x, t_emb)
            x = next(attn)(next(res)(x, t_emb))
            skips.append(x)
            if ind < self.levels - 1:
                x = next(downs)(x)
        x = next(res)(x, t_emb)
        x = next(res)(next(attn)(x), t_emb)
        for _ in range(self.levels - 1):
            x = next(res)(x, t_emb, skips.pop())
            x = next(ups)(next(attn)(next(res)(x, t_emb)))
        return self.final_conv(self.final_block(x))


class ConvResBlock(nn.Module):
    """x + (1x1 -> 3x3 -> 3x3 -> 1x1, each after a mish), then a 2x2 mean
    pool ('down') or a 2x nearest upsample ('up')."""

    def __init__(self, mid, dim, scale):
        super().__init__()
        self.scale = scale
        self.convs = nn.ModuleList([Conv(dim, mid, 1), Conv(mid, mid, 3),
                                    Conv(mid, mid, 3), Conv(mid, dim, 1)])

    def forward(self, x):
        h = x
        for conv in self.convs:
            h = conv(mish(h))
        out = x + h
        if self.scale == "down":
            return F.avg_pool2d(out, 2)
        if self.scale == "up":
            return F.interpolate(out, scale_factor=2, mode="nearest")
        return out


class ConvResNet(nn.Module):
    def __init__(self, dim, cin, cout, n_scale, up, n_blocks):
        super().__init__()
        self.explode = Conv(cin, dim, 1)
        blocks = []
        for _ in range(n_scale):
            blocks.append(ConvResBlock(dim // 2, dim, "up" if up else "down"))
            blocks += [ConvResBlock(dim // 2, dim, None)
                       for _ in range(n_blocks - 1)]
        self.blocks = nn.ModuleList(blocks)
        self.condense = Conv(dim, cout, 1)

    def forward(self, x):
        x = self.explode(x)
        for block in self.blocks:
            x = block(x)
        return self.condense(x)


class DDDPMNet(nn.Module):
    """The UNet and the two resamplers of a dDDPM configuration."""

    def __init__(self, config: dict):
        super().__init__()
        self.unet = Unet(config["unet_chan"], config["unet_in"],
                         tuple(config["unet_dims"]), config["unet_dropout"])
        n, d = config["n_downsamples"], config["d_chans"]
        self.downsample = ConvResNet(d, 3, config["unet_in"], n, False,
                                     config["d_n_blocks"])
        self.upsample = ConvResNet(d, config["unet_in"], 3, n, True,
                                   config["u_n_blocks"])


def set_precision(net: nn.Module, prec: str) -> nn.Module:
    for m in net.modules():
        if isinstance(m, _Op):
            m.prec = prec
    return net


def mark_int8(net: nn.Module, levels: int = 127) -> list:
    """Gates the int8 mode's convs of the UNet (see the module's
    docstring); returns them.  Each gets a zero absmax per operand."""
    gated = []
    for block in net.unet.modules():
        if not isinstance(block, Block):
            continue
        conv = block.conv
        cout, cin = conv.weight.shape[:2]
        parts = [cin] if conv.split is None else [conv.split, cin - conv.split]
        if all(p == cout and p >= 128 for p in parts) and conv.stride == 1:
            conv.levels = levels
            conv.amax = [torch.zeros((), device=conv.weight.device)
                         for _ in parts]
            gated.append(conv)
    return gated


def set_mode(convs, mode: str) -> None:
    for conv in convs:
        conv.mode = mode


def check_config(config: dict) -> None:
    """Raises for a configuration this reference does not describe."""
    want = {"model": "dddpm", "d_mode": "convolutional_res",
            "u_mode": "convolutional_res", "loss_type": "simple",
            "beta_schedule": "linear", "loss_flat": "sum", "ae_loss": True,
            "force_latent": True, "d_dropout": 0}
    bad = {k: config.get(k) for k, v in want.items() if config.get(k) != v}
    if bad:
        raise ValueError(f"the reference does not cover {bad}")
