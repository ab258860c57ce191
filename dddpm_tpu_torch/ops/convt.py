"""Subpixel (phase-decomposed) 2x transposed convolution (port of
dddpm_tpu/ops/convt.py).

The UNet's Upsample is a 4x4 stride-2 transposed conv (padding 1).  This
computes the same function as four dense 2x2 convs, one per output
parity phase, and an interleave:

    out[2m + pi, 2n + pj] = phase_conv[pi, pj](x)[m, n]

Per spatial dim, with torch's kernel w (k = 4, stride 2, padding 1):

    out[2m]     = w[3] x[m - 1] + w[1] x[m]
    out[2m + 1] = w[2] x[m]     + w[0] x[m + 1]

so the even phase correlates the flipped kernel's even taps over the
window (m - 1, m) and the odd phase its odd taps over (m, m + 1).

Plain PyTorch, on no path: models/blocks.py:Upsample keeps
F.conv_transpose2d (the JAX package picks between the two forms by a
size gate tuned for the TPU; they compute the same numbers).
chip_smoke.py times both on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv_transpose_2x_subpixel(x: torch.Tensor, weight: torch.Tensor,
                               bias: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """F.conv_transpose2d(x, weight, bias, stride=2, padding=1) for a 4x4
    kernel, by phase decomposition.

    x: (B, Cin, H, W); weight: (Cin, Cout, 4, 4), torch's transposed-conv
    layout; bias: optional (Cout,).  Returns (B, Cout, 2H, 2W)."""
    if tuple(weight.shape[2:]) != (4, 4):
        raise ValueError(f"the subpixel form takes a 4x4 kernel, got "
                         f"{tuple(weight.shape[2:])}")
    b, _, h, w = x.shape
    cout = weight.shape[1]
    # the flipped kernel as a correlation's (Cout, Cin, 4, 4)
    k = weight.flip(2, 3).transpose(0, 1)
    phases = []
    for pi in range(2):
        for pj in range(2):
            # even phase: window (m - 1, m); odd: (m, m + 1)
            xp = F.pad(x, (1 - pj, pj, 1 - pi, pi))
            phases.append(F.conv2d(xp, k[:, :, pi::2, pj::2]))
    y = torch.stack(phases, dim=-1).reshape(b, cout, h, w, 2, 2)
    y = y.permute(0, 1, 2, 4, 3, 5).reshape(b, cout, 2 * h, 2 * w)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None, None]
    return y
