"""Math primitives (port of dddpm_tpu/ops/math.py).

Elementwise functions on tensors in any layout; the reductions treat
dim 0 as the batch dim.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class _Mish(torch.autograd.Function):
    """x * tanh(softplus(x)) with the JAX package's custom JVP as its
    backward: with t = tanh(softplus(x)) and s = sigmoid(x),
    mish'(x) = t + x * s * (1 - t^2) (dddpm_tpu/ops/math.py:18-41).
    F.softplus is the stable form (x itself above 20)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * torch.tanh(F.softplus(x))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        t = torch.tanh(F.softplus(x))
        return grad * (t + x * torch.sigmoid(x) * (1.0 - t * t))


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: x * tanh(softplus(x))."""
    return _Mish.apply(x)


def l1_loss(target: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    return (target - output).abs().mean()


def l2_loss(target: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    """Elementwise squared error (reduction='none' MSE)."""
    return (target - output).square()


def reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims -> shape (B,)."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch dims -> shape (B,)."""
    return x.sum(dim=tuple(range(1, x.ndim)))


def flat_bits(x: torch.Tensor) -> torch.Tensor:
    """Mean over non-batch dims, scaled to bits (divide by ln 2)."""
    return reduce_mean(x) / math.log(2.0)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL( N(mean1, exp(logvar1)) || N(mean2, exp(logvar2)) ), broadcasting."""
    ref = next(v for v in (mean1, logvar1, mean2, logvar2)
               if isinstance(v, torch.Tensor))
    logvar1 = torch.as_tensor(logvar1, dtype=ref.dtype, device=ref.device)
    logvar2 = torch.as_tensor(logvar2, dtype=ref.dtype, device=ref.device)
    return 0.5 * (logvar2 - logvar1 - 1.0 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh approximation of the standard normal CDF (Ho et al.)."""
    return 0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means, log_scales
                                        ) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to the +-1/255 image grid
    (x is uint8 data rescaled to [-1, 1]); nats, same shape as x."""
    log_scales = torch.broadcast_to(log_scales, x.shape)
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def min_max_norm_batch(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalize over the whole batch."""
    return (x - x.min()) / (x.max() - x.min())


def min_max_norm_image(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalize each image in the batch independently."""
    flat = x.reshape(x.shape[0], -1)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    x_min = flat.amin(dim=1).reshape(shape)
    x_max = flat.amax(dim=1).reshape(shape)
    return (x - x_min) / (x_max - x_min)


def pad_conv_channels(x, w, b, cin_step: int, cout_step: int, per_bc=()):
    """A conv's operands with their channels zero-padded to multiples of
    cin_step (inputs) and cout_step (outputs), for a kernel that takes
    only such widths: NHWC x (B, H, W, Cin), HWIO w (kh, kw, Cin, Cout),
    b (Cout,) and per-(batch, input channel) arrays (B, Cin) or None.
    Returns (x, w, b, per_bc); each tensor itself where it needs no pad.
    Exact: a padded input channel is zero, and so is its prologue
    (mish(0 * 0 + 0) + 0), and it meets zero weights; the caller slices
    the padded output channels off."""
    cin, cout = w.shape[2], w.shape[3]
    pi = -(-cin // cin_step) * cin_step - cin
    po = -(-cout // cout_step) * cout_step - cout
    if pi:
        x = F.pad(x, (0, pi))
        per_bc = tuple(None if t is None else F.pad(t.reshape(t.shape[0], cin),
                                                     (0, pi)) for t in per_bc)
    if pi or po:
        w = F.pad(w, (0, po, 0, pi))
    if po:
        b = F.pad(b, (0, po))
    return x, w, b, tuple(per_bc)
