"""Model factory (port of dddpm_tpu/models/factory.py).

build_model(config) wires the network and the diffusion process: plain
DDPM runs the UNet at image resolution; dDDPM wraps it with the down/up
samplers and runs the chain in latent space; config['ae_loss'] selects
the autoencoder variant, whose training objective detaches z.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from dddpm_tpu_torch.data.datasets import get_color_channels
from dddpm_tpu_torch.models.ddpm import GaussianDiffusion
from dddpm_tpu_torch.models.dddpm import (
    DownsampleDiffusion,
    DownsampleDiffusionAutoencoder,
)
from dddpm_tpu_torch.models.init import init_params_
from dddpm_tpu_torch.models.resample import get_downsampling, get_upsampling
from dddpm_tpu_torch.models.schedule import DiffusionSchedule
from dddpm_tpu_torch.models.unet import (
    Unet,
    compute_dtype_of,
    resolve_use_pallas,
)
from dddpm_tpu_torch.utils.device import DeviceLike, resolve_device


class DDDPMNet(nn.Module):
    """UNet eps-predictor plus the down/up samplers (NCHW modules)."""

    def __init__(self, config: dict):
        super().__init__()
        c = get_color_channels(config["dataset"])
        size = config["image_size"]
        dt = compute_dtype_of(config)
        self.unet = Unet.from_config(config)
        self.downsample = get_downsampling(config, (size, size, c), dt)
        self.upsample = get_upsampling(config, (size, size, c), dt)


def _nhwc(fn: Callable) -> Callable:
    """Wraps an NCHW module call as NHWC -> NHWC (no copy for NHWC input)."""
    def call(x, *args):
        return fn(x.permute(0, 3, 1, 2), *args).permute(0, 2, 3, 1)
    return call


def build_model(config: dict, device: DeviceLike = None):
    """Returns (net, process, init_fn, config), config with model_size.

    The net is built on `device` (the CUDA card when None; pass 'cpu'
    for the plain path) in eval mode; the returned config holds
    use_pallas_attention resolved to a bool.  init_fn(seed) re-draws every
    parameter from a torch.Generator seeded with `seed`."""
    dev = resolve_device(device)
    config = dict(config)
    # pin the attention path into the config (and so the checkpoint), as
    # dddpm_tpu/models/factory.py:98 does: 'auto' resolved here
    config["use_pallas_attention"] = resolve_use_pallas(config, dev)
    color_channels = get_color_channels(config["dataset"])
    size = config["image_size"]
    schedule = DiffusionSchedule.create(config["beta_schedule"], config["T"],
                                        device=dev)

    if config["model"] == "ddpm":
        config["unet_in"] = color_channels
        net = Unet.from_config(config).to(dev).eval()
        process = GaussianDiffusion(schedule, _nhwc(net),
                                    (size, size, color_channels),
                                    loss_type=config["loss_type"],
                                    loss_flat=config["loss_flat"])
    elif config["model"] == "dddpm":
        unet_in = config["unet_in"]
        if unet_in < color_channels:
            raise ValueError(f"unet_in {unet_in} < color channels {color_channels}")
        reduc = 2 ** config["n_downsamples"]
        if size % reduc:
            raise ValueError(f"image_size {size} is not divisible by the "
                             f"downsample factor {reduc}")
        z_size = size // reduc
        net = DDDPMNet(config).to(dev).eval()
        cls = (DownsampleDiffusionAutoencoder if config["ae_loss"]
               else DownsampleDiffusion)
        process = cls(
            schedule, _nhwc(net.unet), _nhwc(net.downsample),
            _nhwc(net.upsample), x_shape=(size, size, color_channels),
            sample_shape=(z_size, z_size, unet_in),
            loss_type=config["loss_type"], loss_flat=config["loss_flat"],
            t_rec_max=config["t_rec_max"],
            force_latent=config["force_latent"],
            # the compact recon branch: AE variant only, and only with
            # deterministic resamplers (factory.py:150-152)
            recon_compact=(bool(config.get("recon_compact", True))
                           and bool(config["ae_loss"])
                           and config.get("d_dropout", 0) == 0))
    else:
        raise NotImplementedError(f"model {config['model']} not implemented")

    def init_fn(seed: int) -> nn.Module:
        return init_params_(net, torch.Generator().manual_seed(seed))

    config["model_size"] = param_count(net)
    return net, process, init_fn, config


def param_count(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())
