"""Diffusion beta schedules and the derived schedule buffers (port of
dddpm_tpu/models/schedule.py).

All twelve derived arrays are computed once in float64 numpy and stored
as float32 tensors on the requested device.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

BETA_SCHEDULES = ("linear", "cosine")


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta array (float64 numpy).  'linear' is Ho et al.'s schedule
    scaled by 1000/T; 'cosine' is Nichol & Dhariwal's, clipped <= 0.999."""
    if schedule == "linear":
        scale = 1000.0 / n_timestep
        return np.linspace(scale * linear_start, scale * linear_end,
                           n_timestep, dtype=np.float64)
    if schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        return np.clip(betas, 0.0, 0.999)
    raise ValueError(f"schedule '{schedule}' unknown.")


@dataclass(frozen=True)
class DiffusionSchedule:
    """All precomputed diffusion constants, one (T,) float32 tensor each."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    vlb_weights: torch.Tensor
    timesteps: int = 1000

    @classmethod
    def create(cls, schedule: str = "linear", timesteps: int = 1000,
               device="cpu", dtype=torch.float32) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps)
        if not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be in (0, 1]")

        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = (
            (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod) * betas)
        coef_x0 = np.sqrt(alphas_cumprod_prev) * betas / (1.0 - alphas_cumprod)
        coef_xt = (np.sqrt(alphas) * (1.0 - alphas_cumprod_prev)
                   / (1.0 - alphas_cumprod))
        # the posterior variance is 0 at t=0: clip its log to step 1's
        posterior_log_var_clip = np.log(
            np.append(posterior_variance[1], posterior_variance[1:]))
        with np.errstate(divide="ignore"):  # posterior_variance[0] == 0
            vlb_weights = betas ** 2 / (
                2.0 * posterior_variance * alphas * (1.0 - alphas_cumprod))
        vlb_weights[0] = vlb_weights[1]

        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return cls(
            betas=as_t(betas),
            alphas_cumprod=as_t(alphas_cumprod),
            alphas_cumprod_prev=as_t(alphas_cumprod_prev),
            sqrt_alphas_cumprod=as_t(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=as_t(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=as_t(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=as_t(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=as_t(np.sqrt(1.0 / alphas_cumprod - 1.0)),
            posterior_variance=as_t(posterior_variance),
            posterior_log_variance_clipped=as_t(posterior_log_var_clip),
            posterior_mean_coef1=as_t(coef_x0),
            posterior_mean_coef2=as_t(coef_xt),
            vlb_weights=as_t(vlb_weights),
            timesteps=timesteps,
        )

    def buffers(self) -> dict:
        """name -> tensor for the twelve derived buffers and betas."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name != "timesteps"}


def gather(buf: torch.Tensor, t: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """buf[t] reshaped to (B, 1, ..., 1) with `ndim` dims in total."""
    out = buf[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))
