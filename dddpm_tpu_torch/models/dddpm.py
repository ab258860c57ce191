"""Downsampled DDPM (port of dddpm_tpu/models/dddpm.py): sampling (the
ancestral chain and DDIM), the training objective and the test-set VLB.

The reverse chain runs in the latent space of a learned downsampler;
one learned upsample maps the final latent to image space.  Both spaces
are tanh-squashed into [-1, 1] when force_latent is set.  The recon loss
applies only where t < t_rec_max.  Tensors at this level are NHWC.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dddpm_tpu_torch.models.ddpm import (
    INIT_KEY,
    GaussianDiffusion,
    Noise,
    step_noise,
    to_device,
)
from dddpm_tpu_torch.models.schedule import DiffusionSchedule
from dddpm_tpu_torch.ops.math import l2_loss


class DownsampleDiffusion(GaussianDiffusion):
    """dDDPM: DDPM in z-space plus down/up sampler networks.

    Args (beyond GaussianDiffusion):
      down_fn: x (NHWC) -> z before the squash.
      up_fn:   z (NHWC) -> x before the squash.
      x_shape: (H, W, C) of image space.
      sample_shape: (H/2^n, W/2^n, unet_in) of latent space.
      t_rec_max: the recon loss applies where t < t_rec_max (-1 -> T-1).
      recon_compact: the autoencoder variant's recon branch runs on the
        rows under the gate only (see DownsampleDiffusionAutoencoder).
    """

    def __init__(self, schedule: DiffusionSchedule, eps_fn: Callable,
                 down_fn: Callable, up_fn: Callable,
                 x_shape: Tuple[int, int, int],
                 sample_shape: Tuple[int, int, int],
                 loss_type: str = "simple", loss_flat: str = "sum",
                 t_rec_max: int = 100, force_latent: bool = True,
                 recon_compact: bool = False):
        super().__init__(schedule, eps_fn, sample_shape, loss_type, loss_flat)
        self.down_fn = down_fn
        self.up_fn = up_fn
        self.x_shape = tuple(x_shape)
        self.t_rec_max = self.timesteps - 1 if t_rec_max == -1 else t_rec_max
        self.force_latent = force_latent
        self.recon_compact = recon_compact

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
    def ddim_sample(self, batch_size: int = 16, seed: int = 0,
                    num_steps: int = 50, eta: float = 0.0,
                    spacing: str = "linear", noise: Noise = None):
        """Strided DDIM chain in latent space, then one upsample: (x, z)."""
        z = self.ddim_sample_loop(batch_size, seed, num_steps, eta, spacing,
                                  noise)
        return self.rescaled_upsample(z), z

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

    # --------------------------------------------------------------- losses

    def loss_recon(self, x, z_hat, t):
        """Per-element image reconstruction loss, gated to t < t_rec_max."""
        loss = self.flatten_loss(l2_loss(x, self.rescaled_upsample(z_hat)))
        return torch.where(t < self.t_rec_max, loss, torch.zeros_like(loss))

    def losses(self, x, t, eps):
        """Joint objective: latent DDPM loss + gated recon loss."""
        t = to_device(t, x.device)
        z = self.rescaled_downsample(x)
        z_t = self.q_sample(z, t, eps)
        eps_hat = self.eps_fn(z_t, t)
        l_ddpm = self.loss_ddpm(eps, eps_hat, t)
        z_hat = self.predict_x_from_eps(z_t, t, eps_hat, clip=False)
        l_rec = self.loss_recon(x, z_hat, t).mean()
        return l_ddpm + l_rec, {"latent": l_ddpm, "recon": l_rec}

    def loss_fn(self, x, key: int = 0, t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None):
        t, eps = self._draws(x, key, t, eps)
        obj, parts = self.losses(x, t, eps)
        return obj, {"train_obj": obj, "train_latent": parts["latent"],
                     "train_recon": parts["recon"]}

    @torch.no_grad()
    def test_losses(self, x, seed: int = 0,
                    noise: Noise = None) -> Dict[str, torch.Tensor]:
        """The full-chain VLB computed in z-space (reference
        dddpm.py:145-148)."""
        return super().test_losses(self.rescaled_downsample(x), seed, noise)


class DownsampleDiffusionAutoencoder(DownsampleDiffusion):
    """Default dDDPM variant: the recon loss is a pure autoencoder pass
    on z, and z is detached before the DDPM loss (reference
    dddpm.py:151-177).

    With recon_compact the recon branch, the only gradient source of
    both resamplers, runs on the rows with t < t_rec_max alone: x[mask],
    summed and divided by the full batch, which is the dense objective
    exactly.  Eager PyTorch needs neither the JAX package's static
    capacity nor its lax.cond fallback; with no row under the gate the
    branch is skipped (no launch at batch 0).  The full-batch
    downsample that feeds the DDPM loss then runs without autograd, as
    the stop_gradient at dddpm.py:247 does.  t's mask is read on the
    host: a t drawn by t_sample lies there already.
    """

    def losses(self, x, t, eps):
        if not self.recon_compact:
            return self._losses_dense(x, t, eps)
        batch = x.shape[0]
        t_dev = to_device(t, x.device)
        rows = torch.nonzero(t.cpu() < self.t_rec_max).squeeze(1)
        if len(rows):
            idx = to_device(rows, x.device)
            x_sub, t_sub = x.index_select(0, idx), t_dev.index_select(0, idx)
            l_sub = self.loss_recon(x_sub, self.rescaled_downsample(x_sub),
                                    t_sub)
            l_rec = l_sub.sum() / batch
        else:
            l_rec = torch.zeros((), device=x.device)
        with torch.no_grad():
            z = self.rescaled_downsample(x)
        l_ddpm = self._loss_latent(z, t_dev, eps)
        return l_ddpm + l_rec, {"latent": l_ddpm, "recon": l_rec}

    def _losses_dense(self, x, t, eps):
        t = to_device(t, x.device)
        z = self.rescaled_downsample(x)
        l_rec = self.loss_recon(x, z, t).mean()
        l_ddpm = self._loss_latent(z.detach(), t, eps)
        return l_ddpm + l_rec, {"latent": l_ddpm, "recon": l_rec}

    def _loss_latent(self, z, t, eps):
        """The DDPM loss on (detached) latents."""
        z_t = self.q_sample(z, t, eps)
        return self.loss_ddpm(eps, self.eps_fn(z_t, t), t)
