"""Variational helpers (port of dddpm_tpu/models/variational.py): Gaussian
log-densities, the reparametrization and the Gaussian sample / merge
layers.  No model of the package calls them; they are the counterparts
of the JAX package's, for VAE-family models.  The noise comes from a
torch.Generator where one is given (the JAX functions take a key)."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def log_standard_gaussian(x: torch.Tensor) -> torch.Tensor:
    """log N(x | 0, I), summed over the non-batch dims."""
    logp = -0.5 * (math.log(2 * math.pi) + x * x)
    return logp.reshape(x.shape[0], -1).sum(-1)


def log_gaussian(x: torch.Tensor, mu: torch.Tensor,
                 log_var: torch.Tensor) -> torch.Tensor:
    """log N(x | mu, diag(exp(log_var))), summed over the non-batch dims."""
    logp = -0.5 * (math.log(2 * math.pi) + log_var
                   + torch.square(x - mu) * torch.exp(-log_var))
    return logp.reshape(x.shape[0], -1).sum(-1)


def reparametrize(mu: torch.Tensor, log_var: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mu + eps * sigma with eps ~ N(0, I) drawn from `generator` (on
    mu's device), or the `eps` given."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                          device=mu.device)
    return mu + eps * torch.exp(0.5 * log_var)


class GaussianSample(nn.Module):
    """Linear layers giving (z, mu, log_var) from features."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.mu = nn.Linear(in_features, out_features)
        self.log_var = nn.Linear(in_features, out_features)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        mu, log_var = self.mu(x), self.log_var(x)
        return reparametrize(mu, log_var, generator, eps), mu, log_var


class GaussianMerge(nn.Module):
    """Precision-weighted merge of two Gaussians (Ladder-VAE style)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.mu = nn.Linear(in_features, out_features)
        self.log_var = nn.Linear(in_features, out_features)

    def forward(self, x, mu1, log_var1,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        mu2, log_var2 = self.mu(x), self.log_var(x)
        prec1, prec2 = torch.exp(-log_var1), torch.exp(-log_var2)
        mu = (mu1 * prec1 + mu2 * prec2) / (prec1 + prec2)
        var = 1.0 / (prec1 + prec2)
        log_var = torch.log(var + 1e-8)
        return reparametrize(mu, log_var, generator, eps), mu, log_var
