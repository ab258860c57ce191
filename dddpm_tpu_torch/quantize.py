"""Calibration for the opt-in int8 (W8A8) conv serving mode (port of
dddpm_tpu/quantize.py).

ops/quant.py quantizes the gated 3x3 convs with static per-tensor
activation scales held in the `amax_x` / `amax_skip` buffers of each
quantized Conv2d (models/blocks.py).  This module fills them for a
trained model:

  1. run a reverse chain with quantization off on the same weights
     (`quant_mode(net, 'off')`) from a seeded N(0, 1) start and snapshot
     the latent state every T // n_points steps;
  2. run the quantized eps-predictor on each (x_t, t) snapshot in
     calibration mode: every gated conv first raises its amax with its
     input, then runs the s8 conv with that amax, so the convs after it
     see quantized activations, as in the JAX package.

mode='noise' skips the chain and observes N(0, 1) latents spread over
t (a cheap bootstrap).

`maybe_calibrate` calibrates unless EVERY amax is already > 0.  The JAX
package skips calibration when ANY is (dddpm_tpu/quantize.py:120); a
partly filled set then leaves the convs without a scale at 0, which
clamps their every input to +-127 (ROADMAP section 3).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dddpm_tpu_torch.models.blocks import quant_buffers, quant_mode


def load_float_weights(net: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Loads a checkpoint's weights into `net`; the amax buffers of the
    int8 mode may be absent from `state` (they keep their values, 0 on
    a fresh model), any other missing or unknown key raises."""
    missing, unexpected = net.load_state_dict(state, strict=False)
    missing = sorted(set(missing) - set(quant_buffers(net)))
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the model: missing "
                       f"{missing[:5]}, unexpected {list(unexpected)[:5]}")


@torch.no_grad()
def observe(net: nn.Module, process,
            snapshots: Iterable[Tuple[torch.Tensor, int]]) -> None:
    """Runs the eps-predictor on each (x_t NHWC, t) in calibration mode,
    raising every gated conv's amax with what it sees."""
    with quant_mode(net, "calibrate"):
        for x_t, t in snapshots:
            x_t = x_t.to(process.device, torch.float32)
            t_b = torch.full((x_t.shape[0],), int(t), dtype=torch.int64,
                             device=process.device)
            process.eps_fn(x_t, t_b)


def calibration_snapshots(net: nn.Module, process, batch_size: int = 8,
                          n_points: int = 16, mode: str = "trajectory",
                          seed: int = 0) -> list:
    """The (x_t, t) pairs calibration observes, as the JAX package picks
    them: x_init ~ N(0, 1) at t = T - 1, then either the states of a
    chain with quantization off after every max(1, T // n_points) steps,
    each at t_last - 1 (skipping t < 0), or fresh N(0, 1) latents at
    linspace(0, T - 1, n_points)."""
    t_max = int(process.timesteps) - 1
    shape = (batch_size, *process.sample_shape)
    gen = torch.Generator().manual_seed(seed)
    x_init = torch.randn(shape, generator=gen).to(process.device)
    snaps = [(x_init, t_max)]
    if mode == "trajectory":
        every = max(1, (t_max + 1) // max(1, n_points))
        ts = list(range(t_max, -1, -1))
        with quant_mode(net, "off"):
            _, states = process.p_sample_chain_snapshots(x_init, ts, every,
                                                         seed=seed)
        # snapshot i is the state after the chunk ending at t_last, i.e.
        # x_{t_last - 1}, which the eps net takes at t_last - 1
        rem = len(ts) % every
        last_t = np.asarray(ts)[rem:].reshape(-1, every)[:, -1]
        snaps += [(img, int(t) - 1) for img, t in zip(states, last_t)
                  if int(t) - 1 >= 0]
    elif mode == "noise":
        for t in np.linspace(0, t_max, max(2, n_points), dtype=np.int64):
            snaps.append((torch.randn(shape, generator=gen).to(process.device),
                          int(t)))
    else:
        raise ValueError(f"calibration mode must be 'trajectory' or 'noise', "
                         f"got {mode!r}")
    return snaps


def calibrate_conv_quant(config: dict, net: nn.Module, process,
                         batch_size: int = 8, n_points: int = 16,
                         mode: str = "trajectory", seed: int = 0) -> nn.Module:
    """Fills the amax buffers of `net` (built with config['conv_quant']
    = 'int8'; `process` drives it) and returns it; a model without the
    int8 mode is returned as it is."""
    if config.get("conv_quant") not in ("int8",):
        return net
    observe(net, process, calibration_snapshots(net, process, batch_size,
                                                n_points, mode, seed))
    return net


def maybe_calibrate(config: dict, net: nn.Module, process,
                    batch_size: Optional[int] = None,
                    mode: str = "trajectory", seed: int = 0) -> nn.Module:
    """Calibrates iff the int8 mode is on and not every amax is > 0
    (e.g. scales restored from disk are kept when all are set)."""
    if config.get("conv_quant") not in ("int8",):
        return net
    bufs = quant_buffers(net)
    if bufs and all(float(b) > 0.0 for b in bufs.values()):
        return net
    return calibrate_conv_quant(config, net, process,
                                batch_size=batch_size or 4, mode=mode,
                                seed=seed)
