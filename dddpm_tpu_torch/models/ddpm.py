"""Gaussian diffusion (port of dddpm_tpu/models/ddpm.py): the sampling
chain and the training objective.

Tensors at this level are NHWC, the JAX package's layout; `eps_fn`
takes (x_t NHWC, t (B,) int64) and returns eps in x_t's shape.

Per-step noise is injectable.  By default the noise of step t is drawn
from a torch.Generator seeded from (seed, t) alone, so running the chain
as consecutive segments over slices of one ts equals the whole chain bit
for bit.  A caller may instead pass `noise`: a callable t -> tensor, or a
tensor holding one pre-drawn draw per entry of ts.  The DDIM chain and
the full-chain VLB (test_losses) draw theirs the same way.

The training draws (a micro-batch's t and eps) are injectable the same
way: `loss_fn(x, key, t=None, eps=None)`.  By default t comes from a CPU
torch.Generator seeded fold_seed(key, 0), so the host knows which rows
fall under the recon gate without waiting for the device, and eps from
a generator on x's device seeded fold_seed(key, 1); the trainer's key is
fold_seed(fold_seed(seed, step), micro_batch).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dddpm_tpu_torch.models.schedule import DiffusionSchedule, gather
from dddpm_tpu_torch.ops.math import (
    discretized_gaussian_log_likelihood,
    flat_bits,
    l2_loss,
    normal_kl,
    reduce_mean,
    reduce_sum,
)

Noise = Union[None, Callable[[int], torch.Tensor], torch.Tensor]
_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, key: int) -> int:
    """A 63-bit generator seed for (seed, key): splitmix64 of the pair."""
    z = (seed * 0x9E3779B97F4A7C15 + (key + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 31)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 29)) & ((1 << 63) - 1)


def step_noise(seed: int, key: int, shape, device) -> torch.Tensor:
    """N(0, 1) float32 of `shape` that depends only on (seed, key, shape)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, key))
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


INIT_KEY = -1   # key of the chain's starting draw; step t uses key t
OBJECTIVE_NAMES = ("simple", "hybrid", "vlb")


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """t on `device`; a host tensor goes to the card through pinned
    memory without a wait (a pageable copy would wait for the stream)."""
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def draw_t(key: int, n: int, timesteps: int) -> torch.Tensor:
    """A micro-batch's timesteps, uniform in [0, T), drawn on the CPU."""
    gen = torch.Generator().manual_seed(fold_seed(key, 0))
    return torch.randint(0, timesteps, (n,), generator=gen, dtype=torch.int64)


def draw_eps(key: int, shape, device) -> torch.Tensor:
    """A micro-batch's N(0, 1) float32 noise, drawn on `device`."""
    return step_noise(key, 1, shape, device)


def _segment(noise: Noise, a: int, b: int) -> Noise:
    """The noise of steps a..b-1 of a chain (pre-drawn noise is sliced)."""
    return noise if noise is None or callable(noise) else noise[a:b]


class GaussianDiffusion:
    """DDPM reverse process around an eps-predictor.

    Args:
      schedule: DiffusionSchedule, its tensors on the run's device.
      eps_fn: (x_t NHWC, t (B,)) -> eps_hat.
      sample_shape: (H, W, C) of the diffused space.
      loss_type: 'simple' | 'vlb' | 'hybrid'.
      loss_flat: 'sum' | 'mean' flattening of the per-pixel L2.
    """

    lambda_ = 1e-4
    clip_range = (-1.0, 1.0)

    def __init__(self, schedule: DiffusionSchedule, eps_fn: Callable,
                 sample_shape: Tuple[int, int, int], loss_type: str = "simple",
                 loss_flat: str = "sum"):
        if loss_type not in OBJECTIVE_NAMES:
            raise ValueError(f"loss_type must be one of {OBJECTIVE_NAMES}")
        if loss_flat not in ("sum", "mean"):
            raise ValueError("loss_flat must be 'sum' or 'mean'")
        self.schedule = schedule
        self.eps_fn = eps_fn
        self.sample_shape = tuple(sample_shape)
        self.timesteps = schedule.timesteps
        self.device = schedule.betas.device
        self.loss_type = loss_type
        self.flatten_loss = reduce_sum if loss_flat == "sum" else reduce_mean

    # ---------------------------------------------------------------- q / p

    def q_mean_variance(self, x, t):
        """q(x_t | x_0): mean, variance, log-variance."""
        s = self.schedule
        return (gather(s.sqrt_alphas_cumprod, t, x.ndim) * x,
                gather(1.0 - s.alphas_cumprod, t, x.ndim),
                gather(s.log_one_minus_alphas_cumprod, t, x.ndim))

    def q_sample(self, x, t, eps):
        """sqrt(ab_t) x + sqrt(1 - ab_t) eps."""
        s = self.schedule
        return (gather(s.sqrt_alphas_cumprod, t, x.ndim) * x
                + gather(s.sqrt_one_minus_alphas_cumprod, t, x.ndim) * eps)

    def predict_x_from_eps(self, x_t, t, eps, clip: bool = True):
        """x_0 = sqrt(1/ab_t) x_t - sqrt(1/ab_t - 1) eps, clipped to [-1, 1]."""
        s = self.schedule
        x = (gather(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
             - gather(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)
        return x.clamp(*self.clip_range) if clip else x

    def q_posterior(self, x, x_t, t):
        """q(x_{t-1} | x_t, x_0): mean, variance, clipped log-variance."""
        s = self.schedule
        mean = (gather(s.posterior_mean_coef1, t, x_t.ndim) * x
                + gather(s.posterior_mean_coef2, t, x_t.ndim) * x_t)
        return (mean, gather(s.posterior_variance, t, x_t.ndim),
                gather(s.posterior_log_variance_clipped, t, x_t.ndim))

    def p_mean_variance(self, x_t, t):
        """p(x_{t-1} | x_t) through the eps-predictor, x_0 clipped."""
        eps_hat = self.eps_fn(x_t, t).float()
        x_recon = self.predict_x_from_eps(x_t, t, eps_hat, clip=True)
        return self.q_posterior(x_recon, x_t, t)

    # ------------------------------------------------------------- sampling

    def p_sample(self, x_t, t, noise):
        """One ancestral step; the noise is masked out where t == 0."""
        mean, _, log_variance = self.p_mean_variance(x_t, t)
        nonzero = (t != 0).to(x_t.dtype).reshape(
            (t.shape[0],) + (1,) * (x_t.ndim - 1))
        return mean + nonzero * torch.exp(0.5 * log_variance) * noise

    def _noise(self, noise: Noise, seed: int, i: int, t: int, like):
        if noise is None:
            return step_noise(seed, t, like.shape, like.device)
        if callable(noise):
            return noise(t).to(like.device, torch.float32)
        return noise[i].to(like.device, torch.float32)

    @torch.no_grad()
    def p_sample_chain(self, img, ts: Sequence[int], seed: int = 0,
                       noise: Noise = None):
        """p_sample over an explicit (descending) sequence of t."""
        for i, t in enumerate(int(t) for t in ts):
            t_b = torch.full((img.shape[0],), t, dtype=torch.int64,
                             device=img.device)
            img = self.p_sample(img, t_b, self._noise(noise, seed, i, t, img))
        return img

    @torch.no_grad()
    def p_sample_chain_snapshots(self, img, ts: Sequence[int], every: int,
                                 seed: int = 0, noise: Noise = None):
        """p_sample_chain that also returns the state after every `every`
        steps, stacked oldest first.  A remainder runs first so the
        snapshots land on the trailing (low-t) steps."""
        ts = [int(t) for t in ts]
        if every <= 0:
            raise ValueError(f"every must be positive, got {every}")
        if not ts:
            return img, img.new_zeros((0,) + tuple(img.shape))
        every = min(every, len(ts))
        rem = len(ts) % every
        img = self.p_sample_chain(img, ts[:rem], seed,
                                  _segment(noise, 0, rem))
        snaps = []
        for a in range(rem, len(ts), every):
            img = self.p_sample_chain(img, ts[a:a + every], seed,
                                      _segment(noise, a, a + every))
            snaps.append(img)
        return img, torch.stack(snaps)

    def chain_ts(self, early_stop: Optional[int] = None) -> list:
        """T-1 .. t_end, the reverse chain's timesteps."""
        t_end = 0 if early_stop is None else early_stop
        return list(range(self.timesteps - 1, t_end - 1, -1))

    def init_latent(self, batch_size: int, seed: int = 0):
        return step_noise(seed, INIT_KEY, (batch_size, *self.sample_shape),
                          self.device)

    def p_sample_loop(self, batch_size: int, seed: int = 0,
                      early_stop: Optional[int] = None,
                      every: Optional[int] = None, noise: Noise = None):
        """The reverse chain T-1 .. early_stop from a seeded N(0, I) start;
        with `every=k` also the snapshots after each k steps."""
        img = self.init_latent(batch_size, seed)
        ts = self.chain_ts(early_stop)
        if every is None:
            return self.p_sample_chain(img, ts, seed, noise)
        return self.p_sample_chain_snapshots(img, ts, every, seed, noise)

    def sample(self, batch_size: int = 16, seed: int = 0,
               every: Optional[int] = None, early_stop: Optional[int] = None,
               noise: Noise = None):
        """A batch of samples; with `every=k`, (final, snapshots)."""
        return self.p_sample_loop(batch_size, seed, early_stop, every, noise)

    def ddim_taus(self, num_steps: int, spacing: str = "linear") -> List[int]:
        """Descending tau subsequence.  'linear' spaces uniformly; 'quad'
        concentrates steps near t = 0 (linspace(0, sqrt(0.8 T), S)^2)."""
        if spacing == "linear":
            taus = np.linspace(0, self.timesteps - 1, num_steps)
        elif spacing == "quad":
            taus = np.linspace(0, np.sqrt(self.timesteps * 0.8),
                               num_steps) ** 2
        else:
            raise ValueError(f"unknown tau spacing '{spacing}'")
        taus = np.unique(taus.round().astype(np.int32))
        return [int(t) for t in taus[::-1]]

    def ddim_coefficients(self, taus: Sequence[int], eta: float
                          ) -> List[Tuple[float, float, float]]:
        """Per DDIM step, (sqrt(ab_prev), dir_xt, sigma): float64 on the
        host from the schedule's float32 ab, rounded to float32, with
        ab_prev = 1 after the last tau.

          sigma  = eta sqrt((1 - ab_prev) / (1 - ab)) sqrt(1 - ab / ab_prev)
          dir_xt = sqrt(max(1 - ab_prev - sigma^2, 0))
        """
        ab_all = self.schedule.alphas_cumprod.detach().cpu().double().numpy()
        f32 = lambda v: float(np.float32(v))
        out = []
        for i, t in enumerate(taus):
            ab = ab_all[t]
            ab_prev = ab_all[taus[i + 1]] if i + 1 < len(taus) else 1.0
            sigma = (eta * np.sqrt((1.0 - ab_prev) / (1.0 - ab))
                     * np.sqrt(1.0 - ab / ab_prev))
            dir_xt = np.sqrt(max(1.0 - ab_prev - sigma ** 2, 0.0))
            out.append((f32(np.sqrt(ab_prev)), f32(dir_xt), f32(sigma)))
        return out

    def ddim_step(self, img, t: int, coefs: Tuple[float, float, float],
                  noise: Optional[torch.Tensor]):
        """One DDIM step (Song et al.) at t with coefs = (sqrt(ab_prev),
        dir_xt, sigma):

          x_prev = sqrt(ab_prev) x0 + dir_xt eps_hat + sigma z

        with x0 clipped; z is not needed (None) where sigma is 0."""
        c_x0, c_eps, sigma = coefs
        t_b = torch.full((img.shape[0],), t, dtype=torch.int64,
                         device=img.device)
        eps_hat = self.eps_fn(img, t_b).float()
        x0 = self.predict_x_from_eps(img, t_b, eps_hat, clip=True)
        out = c_x0 * x0 + c_eps * eps_hat
        return out + sigma * noise if sigma else out

    @torch.no_grad()
    def ddim_sample_chain(self, img, taus: Sequence[int], eta: float = 0.0,
                          seed: int = 0, noise: Noise = None):
        """DDIM over a descending tau sequence.  The step scalars come
        from the host (ddim_coefficients), so no step waits on the
        device; where sigma is 0 (eta 0, and always at the last step) no
        noise is drawn."""
        taus = [int(t) for t in taus]
        for i, (t, coefs) in enumerate(
                zip(taus, self.ddim_coefficients(taus, eta))):
            z = self._noise(noise, seed, i, t, img) if coefs[2] else None
            img = self.ddim_step(img, t, coefs, z)
        return img

    def ddim_sample_loop(self, batch_size: int, seed: int = 0,
                         num_steps: int = 50, eta: float = 0.0,
                         spacing: str = "linear", noise: Noise = None):
        """The DDIM chain from a seeded N(0, I) start."""
        return self.ddim_sample_chain(self.init_latent(batch_size, seed),
                                      self.ddim_taus(num_steps, spacing),
                                      eta, seed, noise)

    def ddim_sample(self, batch_size: int = 16, seed: int = 0,
                    num_steps: int = 50, eta: float = 0.0,
                    spacing: str = "linear", noise: Noise = None):
        return self.ddim_sample_loop(batch_size, seed, num_steps, eta, spacing,
                                     noise)

    @torch.no_grad()
    def reconstruct(self, x, n: int, seed: int = 0):
        """One-step denoised reconstructions at n linearly spaced t."""
        x = x[:n]
        t = torch.linspace(0, self.timesteps - 1, n,
                           device=x.device).to(torch.int64)
        eps = step_noise(seed, INIT_KEY, x.shape, x.device)
        x_t = self.q_sample(x, t, eps)
        return self.predict_x_from_eps(x_t, t, self.eps_fn(x_t, t).float(),
                                       clip=False)

    # --------------------------------------------------------------- losses

    def loss_ddpm(self, eps, eps_hat, t):
        """Reduce the L2 noise-prediction error to the scalar objective."""
        loss = self.flatten_loss(l2_loss(eps, eps_hat))
        w = self.schedule.vlb_weights[t]
        if self.loss_type == "simple":
            return loss.mean()
        if self.loss_type == "vlb":
            return (w * loss).mean()
        return (loss + self.lambda_ * w * loss).mean()   # hybrid

    def losses(self, x, t, eps):
        """Single-step training objective at timesteps t with noise eps."""
        t = to_device(t, x.device)
        x_t = self.q_sample(x, t, eps)
        return self.loss_ddpm(eps, self.eps_fn(x_t, t), t)

    def t_sample(self, key: int, n: int) -> torch.Tensor:
        """Uniform timesteps in [0, T), on the CPU."""
        return draw_t(key, n, self.timesteps)

    def _draws(self, x, key, t, eps):
        """(t, eps): t where it was drawn or given, eps on x's device."""
        if t is None:
            t = self.t_sample(key, x.shape[0])
        if eps is None:
            eps = draw_eps(key, (x.shape[0], *self.sample_shape), x.device)
        return t, eps.to(x.device)

    def loss_fn(self, x, key: int = 0, t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None):
        """Forward pass at drawn (or given) t and eps: (objective, metrics)."""
        t, eps = self._draws(x, key, t, eps)
        obj = self.losses(x, t, eps)
        return obj, {"train_obj": obj}

    # ------------------------------------------------------------ VLB / NLL

    def vlb_terms(self, x, x_t, t, eps_hat=None):
        """L_t = KL(q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)); L_0 = the
        discretized NLL.  Bits/dim per batch element."""
        true_mean, _, true_log_var = self.q_posterior(x, x_t, t)
        if eps_hat is None:
            eps_hat = self.eps_fn(x_t, t).float()
        x_recon = self.predict_x_from_eps(x_t, t, eps_hat, clip=True)
        pred_mean, _, pred_log_var = self.q_posterior(x_recon, x_t, t)
        if self.loss_type == "hybrid":   # the vlb part trains variances only
            true_mean, pred_mean = true_mean.detach(), pred_mean.detach()
        kl = flat_bits(normal_kl(true_mean, true_log_var, pred_mean,
                                 pred_log_var))
        nll = flat_bits(-discretized_gaussian_log_likelihood(
            x, means=pred_mean, log_scales=0.5 * pred_log_var))
        return torch.where(t == 0, nll, kl)

    def calc_prior(self, x):
        """L_T = KL(q(x_T | x_0) || N(0, I)), bits/dim per element."""
        t = torch.full((x.shape[0],), self.timesteps - 1, dtype=torch.int64,
                       device=x.device)
        mean, _, log_var = self.q_mean_variance(x, t)
        return flat_bits(normal_kl(mean, log_var, 0.0, 0.0))

    @torch.no_grad()
    def test_losses(self, x, seed: int = 0,
                    noise: Noise = None) -> Dict[str, torch.Tensor]:
        """Full-chain VLB + L_simple over every t, T-1 down to 0, one UNet
        evaluation per t.  The noise of t is step_noise(seed, t) unless
        given; every result stays on the device until the caller reads
        it.  vlb_t is (B, T) ordered T-1..0."""
        vlb, l_simple = [], []
        for i, t in enumerate(self.chain_ts()):
            t_b = torch.full((x.shape[0],), t, dtype=torch.int64,
                             device=x.device)
            eps = self._noise(noise, seed, i, t, x)
            x_t = self.q_sample(x, t_b, eps)
            eps_hat = self.eps_fn(x_t, t_b).float()
            vlb.append(self.vlb_terms(x, x_t, t_b, eps_hat))
            l_simple.append(l2_loss(eps, eps_hat).mean())
        vlb_t = torch.stack(vlb, dim=1)
        l_simple_t = torch.stack(l_simple)
        prior = self.calc_prior(x)
        return {"vlb_t": vlb_t, "prior": prior, "vlb": vlb_t.sum(dim=1) + prior,
                "L_simple_t": l_simple_t, "L_simple": l_simple_t.sum()}
