"""Model FLOPs a configuration's work needs, counted from its shapes: the
reference's networks run on the meta device under PyTorch's FLOP
counter (convolutions and matmuls, each multiply-add two), whatever
implements them in the program.  The same counts hold for every run of
a configuration, so the step's share of the peak (mfu) moves only with
the time.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.diffusion import nchw
from benchmark.reference.model import DDDPMNet


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def per_image(config: dict) -> Dict[str, int]:
    """FLOPs for one image: 'unet_fwd' (one eps evaluation), 'up_fwd' (the
    decode), 'down_fwd' (the latent of a training row, no gradient),
    'unet_train' (an eps evaluation with its backward to the weights)
    and 'recon_train' (a row under the recon gate: down, up and their
    backward)."""
    net = DDDPMNet(config).to("meta")
    size = config["image_size"]
    zs = size // 2 ** config["n_downsamples"]
    x = torch.empty(1, size, size, 3, device="meta")
    z = torch.empty(1, zs, zs, config["unet_in"], device="meta")
    t = torch.zeros(1, dtype=torch.int64, device="meta")

    def unet_train():
        net.unet(nchw(z), t).sum().backward()

    def recon_train():
        net.upsample(torch.tanh(net.downsample(nchw(x)))).sum().backward()

    with torch.no_grad():
        out = {"unet_fwd": _count(lambda: net.unet(nchw(z), t)),
               "up_fwd": _count(lambda: net.upsample(nchw(z))),
               "down_fwd": _count(lambda: net.downsample(nchw(x)))}
    with torch.enable_grad():
        out["unet_train"] = _count(unet_train)
        out["recon_train"] = _count(recon_train)
    return out
