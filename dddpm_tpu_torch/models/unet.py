"""The UNet epsilon-predictor (port of dddpm_tpu/models/unet.py).

The lucidrains-style 4-level UNet with linear attention at every
resolution, with the JAX package's quirks kept:

- the expansive path has len(dim_mults)-1 levels, so the first (highest
  resolution) skip connection is computed but never consumed;
- every expansive level ends in an Upsample;
- only the contracting path's ResnetBlocks get dropout.

With `remat` (the config key of that name) every ResnetBlock runs
through torch.utils.checkpoint when grad is enabled: its activations are
recomputed in the backward instead of kept, as the JAX module wraps its
ResnetBlocks in nn.remat.  The parameters, their names, the outputs and
the gradients are those of the plain UNet; the recompute replays the
dropout masks (the RNG state is preserved).

Blocks are held in flat ModuleLists in the order the JAX module creates
them (ResnetBlock_i <-> resnets[i], PreNormLinearAttention_i <->
attns[i], ...), which is what convert.py relies on.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dddpm_tpu_torch.models.blocks import (
    Block,
    Conv2d,
    Downsample,
    PreNormLinearAttention,
    ResnetBlock,
    TimeMLP,
    Upsample,
)


def compute_dtype_of(config: dict) -> torch.dtype:
    return (torch.bfloat16 if config.get("compute_dtype") == "bfloat16"
            else torch.float32)


def resolve_use_pallas(config: dict, device: torch.device) -> bool:
    """use_pallas_attention as a bool: 'auto' (the default) is True for a
    model built on a CUDA card and False on the CPU, as the JAX package
    resolves it by its backend (dddpm_tpu/models/unet.py:34-48).
    build_model writes the result back into the config."""
    use_pallas = config.get("use_pallas_attention", "auto")
    if use_pallas == "auto":
        return torch.device(device).type == "cuda"
    return bool(use_pallas)


class Unet(nn.Module):
    """UNet(dim, dim_mults) predicting eps(x_t, t) in x_t's shape (NCHW)."""

    def __init__(self, dim: int = 128, in_channels: int = 3,
                 dim_mults: Sequence[int] = (1, 2, 2, 2),
                 dropout: float = 0.0, compute_dtype=torch.float32,
                 use_pallas: bool = True, quant_conv: Optional[str] = None,
                 remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        dims = [in_channels] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.levels = len(in_out)
        at = dict(compute_dtype=compute_dtype, use_pallas=use_pallas)
        # the 3x3 convs of the ResnetBlocks and the final Block take the
        # opt-in int8 serving mode (ops/quant.py); the rest stays float
        dt = dict(compute_dtype=compute_dtype, quant=quant_conv)

        self.time_mlp = TimeMLP(dim)
        resnets, attns, downs, ups = [], [], [], []
        for ind, (dim_in, dim_out) in enumerate(in_out):
            resnets += [ResnetBlock(dim_in, dim_out, dim, dropout=dropout, **dt),
                        ResnetBlock(dim_out, dim_out, dim, dropout=dropout, **dt)]
            attns.append(PreNormLinearAttention(dim_out, **at))
            if ind < self.levels - 1:
                downs.append(Downsample(dim_out, compute_dtype=compute_dtype))
        mid = dims[-1]
        resnets.append(ResnetBlock(mid, mid, dim, **dt))
        attns.append(PreNormLinearAttention(mid, **at))
        resnets.append(ResnetBlock(mid, mid, dim, **dt))
        for dim_in, dim_out in reversed(in_out[1:]):
            resnets += [ResnetBlock(dim_out * 2, dim_in, dim, skip_dim=dim_out,
                                    **dt),
                        ResnetBlock(dim_in, dim_in, dim, **dt)]
            attns.append(PreNormLinearAttention(dim_in, **at))
            ups.append(Upsample(dim_in, compute_dtype=compute_dtype))
        self.resnets = nn.ModuleList(resnets)
        self.attns = nn.ModuleList(attns)
        self.downsamples = nn.ModuleList(downs)
        self.upsamples = nn.ModuleList(ups)
        self.final_block = Block(dim, dim, **dt)
        self.final_conv = Conv2d(dim, in_channels, 1,
                                 compute_dtype=compute_dtype)

    @classmethod
    def from_config(cls, config: dict) -> "Unet":
        """The config's UNet; use_pallas_attention must be resolved
        already (build_model pins it).  conv_quant (None or 'int8')
        selects the int8 serving mode, as the JAX module's from_config."""
        use_pallas = config.get("use_pallas_attention", "auto")
        if use_pallas == "auto":
            raise ValueError("use_pallas_attention='auto' is resolved by "
                             "build_model (resolve_use_pallas)")
        quant = config.get("conv_quant") or None
        if quant not in (None, "int8"):
            raise ValueError(f"conv_quant must be 'int8' or unset, got {quant!r}")
        return cls(dim=config["unet_chan"], in_channels=config["unet_in"],
                   dim_mults=tuple(config["unet_dims"]),
                   dropout=config["unet_dropout"],
                   compute_dtype=compute_dtype_of(config),
                   use_pallas=bool(use_pallas), quant_conv=quant,
                   remat=bool(config.get("remat", False)))

    def _resnet(self, block: ResnetBlock, x, t_emb, skip=None):
        """block(x, t_emb, skip), rematerialized under grad with remat."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, t_emb, skip, use_reentrant=False,
                              preserve_rng_state=True)
        return block(x, t_emb, skip)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) in [-1, 1]; t: (B,) integer timesteps."""
        t_emb = self.time_mlp(t)
        orig_dtype = x.dtype
        x = x.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)
        resnets, attns = iter(self.resnets), iter(self.attns)
        downs, ups = iter(self.downsamples), iter(self.upsamples)

        skips = []
        for ind in range(self.levels):
            x = self._resnet(next(resnets), x, t_emb)
            x = self._resnet(next(resnets), x, t_emb)
            x = next(attns)(x)
            skips.append(x)
            if ind < self.levels - 1:
                x = next(downs)(x)

        x = self._resnet(next(resnets), x, t_emb)
        x = next(attns)(x)
        x = self._resnet(next(resnets), x, t_emb)

        for _ in range(self.levels - 1):
            x = self._resnet(next(resnets), x, t_emb, skip=skips.pop())
            x = self._resnet(next(resnets), x, t_emb)
            x = next(attns)(x)
            x = next(ups)(x)

        x = self.final_conv(self.final_block(x))
        return x.to(orig_dtype)
