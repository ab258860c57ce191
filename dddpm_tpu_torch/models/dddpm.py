"""Downsampled DDPM, sampling half (port of dddpm_tpu/models/dddpm.py).

The reverse chain runs in the latent space of a learned downsampler;
one learned upsample maps the final latent to image space.  Both spaces
are tanh-squashed into [-1, 1] when force_latent is set.  Tensors at
this level are NHWC.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dddpm_tpu_torch.models.ddpm import INIT_KEY, GaussianDiffusion, Noise, step_noise
from dddpm_tpu_torch.models.schedule import DiffusionSchedule


class DownsampleDiffusion(GaussianDiffusion):
    """dDDPM: DDPM in z-space plus down/up sampler networks.

    Args (beyond GaussianDiffusion):
      down_fn: x (NHWC) -> z before the squash.
      up_fn:   z (NHWC) -> x before the squash.
      x_shape: (H, W, C) of image space.
      sample_shape: (H/2^n, W/2^n, unet_in) of latent space.
    """

    def __init__(self, schedule: DiffusionSchedule, eps_fn: Callable,
                 down_fn: Callable, up_fn: Callable,
                 x_shape: Tuple[int, int, int],
                 sample_shape: Tuple[int, int, int],
                 force_latent: bool = True):
        super().__init__(schedule, eps_fn, sample_shape)
        self.down_fn = down_fn
        self.up_fn = up_fn
        self.x_shape = tuple(x_shape)
        self.force_latent = force_latent

    def rescaled_downsample(self, x):
        z = self.down_fn(x)
        if tuple(z.shape[1:]) != self.sample_shape:
            raise ValueError(f"latent shape {tuple(z.shape)} != {self.sample_shape}")
        return torch.tanh(z) if self.force_latent else z

    def rescaled_upsample(self, z):
        x = self.up_fn(z)
        if tuple(x.shape[1:]) != self.x_shape:
            raise ValueError(f"image shape {tuple(x.shape)} != {self.x_shape}")
        return torch.tanh(x) if self.force_latent else x

    @torch.no_grad()
    def sample(self, batch_size: int = 16, seed: int = 0,
               every: Optional[int] = None, early_stop: Optional[int] = None,
               noise: Noise = None):
        """Latent reverse chain, then one upsample: (x, z), or with
        `every=k` (x, z, z_snapshots) with the snapshots in z-space."""
        out = self.p_sample_loop(batch_size, seed, early_stop, every, noise)
        z = out if every is None else out[0]
        x = self.rescaled_upsample(z)
        return (x, z) if every is None else (x, z, out[1])

    @torch.no_grad()
    def reconstruct(self, x, n: int, seed: int = 0):
        """(x_recon, z_recon) at n linearly spaced noise scales."""
        x = x[:n]
        t = torch.linspace(0, self.timesteps - 1, n,
                           device=x.device).to(torch.int64)
        z = self.rescaled_downsample(x)
        z_t = self.q_sample(z, t, step_noise(seed, INIT_KEY, z.shape, z.device))
        eps_hat = self.eps_fn(z_t, t).float()
        z_recon = self.predict_x_from_eps(z_t, t, eps_hat, clip=False)
        return self.rescaled_upsample(z_recon), z_recon
