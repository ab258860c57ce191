"""Weights drawn on the device from the seed, in one call.

The layout comes from the reference's networks, whose parameter names
are the program's: every convolution, transposed convolution and linear
weight and bias is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's default
init, which the program's own init draws too), every norm's scale 1 and
shift 0.  One torch.rand over all of them, then a scale per tensor.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness.seeds import WEIGHTS, generator
from benchmark.reference import model as ref_model


def draw(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{parameter name: float32 tensor on device}."""
    net = ref_model.DDDPMNet(config)
    spec = []   # (name, shape, bound, fill): a norm has no bound
    for mname, m in net.named_modules():
        if isinstance(m, (ref_model.Conv, ref_model.ConvT, ref_model.Linear)):
            w = m.weight
            fan_in = (w.shape[1] * w[0, 0].numel()
                      if isinstance(m, ref_model.ConvT) else w[0].numel())
            for pname, p in m.named_parameters(recurse=False):
                spec.append((f"{mname}.{pname}", p.shape,
                             1.0 / math.sqrt(fan_in), None))
        elif isinstance(m, (ref_model.GroupNorm, ref_model.ChannelNorm)):
            for pname, p in m.named_parameters(recurse=False):
                fill = 1.0 if pname in ("weight", "g") else 0.0
                spec.append((f"{mname}.{pname}", p.shape, None, fill))
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    u = torch.rand(sum(sizes), generator=generator(device, seed, WEIGHTS),
                   device=device)
    out = {}
    for (name, shape, bound, fill), part in zip(spec, torch.split(u, sizes)):
        if bound is None:
            out[name] = torch.full(shape, fill, device=device)
        else:
            out[name] = ((part * 2.0 - 1.0) * bound).reshape(shape)
    names = {n for n, _ in net.named_parameters()}
    if names != set(out):
        raise KeyError(f"parameters without a draw: {sorted(names - set(out))[:3]}")
    return out


def load_into(net: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Loads the drawn weights into the program's net; every parameter
    must be drawn, and only its calibration buffers may be left."""
    missing, unexpected = net.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith(("amax_x", "amax_skip"))]
    if missing or unexpected:
        raise KeyError(f"the program's net does not fit the drawn weights: "
                       f"missing {missing[:3]}, unexpected {unexpected[:3]}")
