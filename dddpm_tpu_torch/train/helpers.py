"""Training helpers (port of dddpm_tpu/train/helpers.py): batch grouping,
the linear LR decay, the deterministic KL warm-up and the Bernoulli
reconstruction loss, for the VAE-family trainers the config system
still describes.  No trainer of the package calls them."""
from __future__ import annotations

import os
from typing import List

import torch


def num_to_groups(num: int, divisor: int) -> List[int]:
    """num split into groups of `divisor` (and a remainder group)."""
    groups, remainder = divmod(num, divisor)
    return [divisor] * groups + ([remainder] if remainder > 0 else [])


def lambda_lr(n_epochs: int, offset: int, delay: int):
    """Linear LR decay starting after `delay` epochs (a LambdaLR factor)."""
    if (n_epochs - delay) <= 0:
        raise ValueError("Decay must start before training ends")

    def schedule(epoch: int) -> float:
        return 1.0 - max(0.0, epoch + offset - delay) / (n_epochs - delay)

    return schedule


class DeterministicWarmup:
    """Linear KL-weight warm-up from 0 to t_max over n steps."""

    def __init__(self, n: int = 100, t_max: float = 1.0):
        self.t = 0.0
        self.t_max = t_max
        self.inc = 1.0 / n

    def __iter__(self):
        return self

    def __next__(self) -> float:
        self.t = min(self.t + self.inc, self.t_max)
        return self.t


def bce_loss(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negative Bernoulli log-likelihood, summed per batch element."""
    eps = 1e-7
    r = torch.clamp(r, eps, 1.0 - eps)
    ll = x * torch.log(r) + (1.0 - x) * torch.log(1.0 - r)
    return -ll.reshape(x.shape[0], -1).sum(-1)


def delete_if_exists(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)
