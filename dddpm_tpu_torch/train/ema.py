"""Exponential moving average of parameters (port of
dddpm_tpu/train/ema.py).

Before `start_step` the EMA is reset to the raw params every step;
afterwards it lerps ema * decay + (1 - decay) * params every
`update_every` steps and otherwise stays unchanged.  The tensors are
updated in place.
"""
from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               step: int, decay: float, start_step: int = 2000,
               update_every: int = 10) -> None:
    """One EMA step; `step` is the (0-based) optimizer step just taken."""
    ema, params = list(ema), list(params)
    if step < start_step:
        torch._foreach_copy_(ema, params)
    elif step % update_every == 0:
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))
