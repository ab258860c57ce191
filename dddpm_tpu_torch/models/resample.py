"""Down/upsampling networks for dDDPM (port of
dddpm_tpu/models/resample.py).

Three modes: 'deterministic' (bicubic interpolation), 'convolutional'
(stacked strided convs / transposed convs) and 'convolutional_res' (the
pre-activation bottleneck ConvResNet, the default).  Modules take and
return NCHW tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dddpm_tpu_torch.models.blocks import Conv2d, ConvTranspose4x4
from dddpm_tpu_torch.ops.convres import fused_convres_block, scale_ref
from dddpm_tpu_torch.ops.math import mish

# The JAX package's gate for its fused kernel: at least 128^2 pixels, and
# shapes its row tile of 16 covers.  Module-level so tests can lower it.
FUSED_MIN_PIXELS = 128 * 128
FUSED_ROW_TILE = 16


class Interpolate(nn.Module):
    """Bicubic resize to a fixed size, torch's align_corners=True form
    (the reference's 'deterministic' mode)."""

    def __init__(self, size: Tuple[int, int]):
        super().__init__()
        self.size = tuple(size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.interpolate(x.float(), size=self.size, mode="bicubic",
                          align_corners=True)
        return y.to(x.dtype)


class SimpleDownConv(nn.Module):
    """n_downsamples stacked stride-2 3x3 convs: in_channels -> dim."""

    def __init__(self, dim: int = 8, in_channels: int = 3,
                 n_downsamples: int = 1, compute_dtype=torch.float32):
        super().__init__()
        dims = [in_channels] + [dim] * n_downsamples
        self.convs = nn.ModuleList(
            Conv2d(d_in, d_out, 3, stride=2, compute_dtype=compute_dtype)
            for d_in, d_out in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return x


class SimpleUpConv(nn.Module):
    """n_downsamples stacked 4x4/2 transposed convs: dim -> in_channels."""

    def __init__(self, dim: int = 8, in_channels: int = 3,
                 n_downsamples: int = 1, compute_dtype=torch.float32):
        super().__init__()
        dims = [in_channels] + [dim] * n_downsamples
        io = list(zip(dims[:-1], dims[1:]))[::-1]
        self.convs = nn.ModuleList(
            ConvTranspose4x4(d_in, d_out, compute_dtype) for d_out, d_in in io)

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return x


class ConvResBlock(nn.Module):
    """Pre-activation 1x1 -> 3x3 -> 3x3 -> 1x1 bottleneck with optional
    residual and 2x up/down scaling (nearest upsample / 2x2 mean pool).

    Where `fused_shape_ok` holds, the conv core runs as one call of
    ops/convres.fused_convres_block (the kernels on the card, forward
    and backward).  With no dropout active the residual and the scaling
    run inside that call too; with dropout active the call computes the
    core alone and dropout, residual and scaling follow outside, as the
    JAX module dispatches (resample.py:203-252).  use_pallas False (the
    config's use_pallas_resample, as the JAX module's flag) closes the
    gate: the plain path runs on the card too."""

    def __init__(self, dim: int, in_channels: int, out_channels: int,
                 upsample: bool = False, downsample: bool = False,
                 dropout: float = 0.0, residual: bool = False,
                 compute_dtype=torch.float32, use_pallas: bool = True):
        super().__init__()
        self.use_pallas = use_pallas
        if upsample and downsample:
            raise ValueError("a block scales up or down, not both")
        self.dim, self.in_channels = dim, in_channels
        self.out_channels = out_channels
        self.upsample, self.downsample = upsample, downsample
        self.residual = residual
        dt = dict(compute_dtype=compute_dtype)
        self.convs = nn.ModuleList([
            Conv2d(in_channels, dim, 1, **dt), Conv2d(dim, dim, 3, **dt),
            Conv2d(dim, dim, 3, **dt), Conv2d(dim, out_channels, 1, **dt)])
        self.drop = nn.Dropout2d(dropout)

    @property
    def scale(self) -> Optional[str]:
        return "down" if self.downsample else "up" if self.upsample else None

    def fused_shape_ok(self, hh: int, ww: int) -> bool:
        """The JAX package's gate (use_pallas and the shapes), as it is:
        the kernels take every width it admits (ops/convres.py)."""
        th = min(FUSED_ROW_TILE, hh)
        return (self.use_pallas
                and self.in_channels == self.out_channels
                and (4 * self.in_channels) % 128 == 0
                and (4 * self.dim) % 128 == 0
                and ww % 4 == 0
                and hh % th == 0
                and hh * ww >= FUSED_MIN_PIXELS
                and not (self.downsample and (ww % 8 or th % 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        whole_block = not (self.training and self.drop.p > 0)
        if self.fused_shape_ok(x.shape[2], x.shape[3]):
            dt = self.convs[0].compute_dtype
            hwio = [(c.weight.permute(2, 3, 1, 0), c.bias) for c in self.convs]
            x = x.to(dt)
            h = fused_convres_block(
                x.permute(0, 2, 3, 1).contiguous(),
                *(t for pair in hwio for t in pair),
                residual=self.residual and whole_block,
                scale=self.scale if whole_block else None).permute(0, 3, 1, 2)
            if whole_block:
                return h
        else:
            h = x
            for conv in self.convs:
                h = conv(mish(h))
        h = self.drop(h)
        out = x + h if self.residual else h
        return scale_ref(out.permute(0, 2, 3, 1), self.scale).permute(0, 3, 1, 2)


class ConvResNet(nn.Module):
    """1x1 explode -> n_downsamples x [scaling block + (n_blocks-1) plain
    blocks] -> 1x1 condense."""

    def __init__(self, dim: int, in_channels: int, out_channels: int,
                 n_downsamples: int = 1, upsample: bool = False,
                 dropout: float = 0.0, n_blocks: int = 1,
                 compute_dtype=torch.float32, use_pallas: bool = True):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.explode = Conv2d(in_channels, dim, 1, **dt)
        blocks = []
        for _ in range(n_downsamples):
            blocks.append(ConvResBlock(dim // 2, dim, dim, upsample=upsample,
                                       downsample=not upsample,
                                       dropout=dropout, residual=True,
                                       use_pallas=use_pallas, **dt))
            blocks += [ConvResBlock(dim // 2, dim, dim, dropout=dropout,
                                    residual=True, use_pallas=use_pallas, **dt)
                       for _ in range(n_blocks - 1)]
        self.blocks = nn.ModuleList(blocks)
        self.condense = Conv2d(dim, out_channels, 1, **dt)

    def forward(self, x):
        x = self.explode(x)
        for block in self.blocks:
            x = block(x)
        return self.condense(x)


def _use_pallas(config: dict) -> bool:
    """The JAX package's use_pallas_resample selector (default True)."""
    return bool(config.get("use_pallas_resample", True))


def get_downsampling(config: dict, x_shape: Tuple[int, int, int],
                     compute_dtype=torch.float32) -> nn.Module:
    """x (H, W, C) -> z (H/2^n, W/2^n, unet_in)."""
    h, w, c = x_shape
    if h != w:
        raise ValueError(f"square images only, got {h}x{w}")
    mode, n_down = config["d_mode"], config["n_downsamples"]
    if mode == "deterministic":
        size = h // 2 ** n_down
        if size % 2:
            raise ValueError("downsampled dims should be even")
        return Interpolate((size, size))
    if mode == "convolutional":
        return SimpleDownConv(config["unet_in"], c, n_down, compute_dtype)
    if mode == "convolutional_res":
        return ConvResNet(config["d_chans"], c, config["unet_in"], n_down,
                          upsample=False, dropout=config["d_dropout"],
                          n_blocks=config["d_n_blocks"],
                          compute_dtype=compute_dtype,
                          use_pallas=_use_pallas(config))
    raise NotImplementedError(f'Downsampling method for "{mode}" not implemented!')


def get_upsampling(config: dict, x_shape: Tuple[int, int, int],
                   compute_dtype=torch.float32) -> nn.Module:
    """z (H/2^n, W/2^n, unet_in) -> x (H, W, C)."""
    h, w, c = x_shape
    if h != w:
        raise ValueError(f"square images only, got {h}x{w}")
    mode, n_down = config["u_mode"], config["n_downsamples"]
    if mode == "deterministic":
        return Interpolate((h, w))
    if mode == "convolutional":
        return SimpleUpConv(config["unet_in"], c, n_down, compute_dtype)
    if mode == "convolutional_res":
        return ConvResNet(config["d_chans"], config["unet_in"], c, n_down,
                          upsample=True, dropout=config["d_dropout"],
                          n_blocks=config["u_n_blocks"],
                          compute_dtype=compute_dtype,
                          use_pallas=_use_pallas(config))
    raise NotImplementedError(f'Upsampling method for "{mode}" not implemented!')
