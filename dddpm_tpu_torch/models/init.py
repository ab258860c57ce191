"""Parameter init matching PyTorch's default distributions (port of
dddpm_tpu/models/init.py).

Every conv, transposed conv and linear weight and bias is drawn from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norms start at scale 1 / shift 0.
All values are drawn on the CPU from one explicit torch.Generator, in
parameter order, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _fan_in(module: nn.Module) -> int:
    w = module.weight
    if isinstance(module, nn.ConvTranspose2d):
        # torch computes the transposed conv's fan_in on dim 1: out*kh*kw
        return w.shape[1] * w[0, 0].numel()
    return w[0].numel()


@torch.no_grad()
def init_params_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of `net` in place; returns `net`."""
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(_fan_in(module))
            for p in (module.weight, module.bias):
                if p is None:
                    continue
                u = torch.rand(p.shape, generator=generator,
                               dtype=torch.float32)
                p.copy_((u * 2.0 - 1.0) * bound)
        elif isinstance(module, nn.GroupNorm):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
    return net
