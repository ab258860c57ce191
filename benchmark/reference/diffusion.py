"""The dDDPM process in plain PyTorch: one ancestral step, the decode,
the training objective and one optimizer step (Ho et al. 2020; the
downsampled variant of simonamtoft/downsampled-diffusion, autoencoder
loss).

Tensors at this level are NHWC float32, as the benchmark hands them
out.  Work is done in blocks of `rows` rows, so that the float32
reference fits beside what the program left on the card; nothing in
the model couples rows, so a block's result is the rows' result.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.model import (DDDPMNet, ResnetBlock, check_config,
                                       mark_int8, set_mode, set_precision)


class Schedule:
    """The linear beta schedule (1e-4 .. 2e-2, scaled by 1000 / T) and
    the constants derived from it, in float64, held as float32."""

    def __init__(self, timesteps: int, device):
        scale = 1000.0 / timesteps
        betas = np.linspace(scale * 1e-4, scale * 2e-2, timesteps)
        alphas = 1.0 - betas
        ab = np.cumprod(alphas)
        ab_prev = np.append(1.0, ab[:-1])
        post_var = (1.0 - ab_prev) / (1.0 - ab) * betas
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.sqrt_ab = f32(np.sqrt(ab))
        self.sqrt_1m_ab = f32(np.sqrt(1.0 - ab))
        self.sqrt_recip_ab = f32(np.sqrt(1.0 / ab))
        self.sqrt_recipm1_ab = f32(np.sqrt(1.0 / ab - 1.0))
        self.coef_x0 = f32(np.sqrt(ab_prev) * betas / (1.0 - ab))
        self.coef_xt = f32(np.sqrt(alphas) * (1.0 - ab_prev) / (1.0 - ab))
        self.log_var = f32(np.log(np.append(post_var[1], post_var[1:])))
        self.timesteps = timesteps


def unpack_mask(bits, shape, a: int, b: int, device) -> torch.Tensor:
    """Rows a..b of a packed dropout mask (see `Reference.set_masks`) as
    float32 0 / 1, (b - a, C, H, W) on `device`."""
    rows = bits[a:b].to(device)
    shifts = torch.arange(8, device=device, dtype=torch.uint8)
    kept = (rows[..., None] >> shifts) & 1
    return kept.reshape(b - a, *shape).float()


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Reference:
    """The configuration's networks with the benchmark's weights.  In the
    int8 mode (config conv_quant) the gated convs are int8 and the rest
    float32, or at prec 'int4' (its control, a step below each precision
    the configuration states) int4 and fp8; call `calibrate` first."""

    def __init__(self, config: dict, weights: Dict[str, torch.Tensor],
                 device, prec: str = "f32", rows: int = 32):
        check_config(config)
        self.config = config
        int8 = config.get("conv_quant") == "int8"
        self.net = DDDPMNet(config).to(device)
        set_precision(self.net, "fp8" if int8 and prec == "int4" else prec)
        self.gated = (mark_int8(self.net, 7 if prec == "int4" else 127)
                      if int8 else [])
        missing, unexpected = self.net.load_state_dict(weights, strict=False)
        if missing or unexpected:
            raise KeyError(f"weights do not fit: missing {missing[:3]}, "
                           f"unexpected {unexpected[:3]}")
        self.schedule = Schedule(config["T"], device)
        self.rows = rows
        self.t_rec_max = config["t_rec_max"]
        zs = config["image_size"] // 2 ** config["n_downsamples"]
        self.sample_shape = (zs, zs, config["unet_in"])

    def eps(self, z_t, t):
        return nhwc(self.net.unet(nchw(z_t), t))

    def down(self, x):
        return torch.tanh(nhwc(self.net.downsample(nchw(x))))

    def up(self, z):
        return torch.tanh(nhwc(self.net.upsample(nchw(z))))

    # ------------------------------------------------------------ sampling

    @torch.no_grad()
    def p_sample(self, x_t, t: int, noise):
        """(x_{t-1}, eps_hat, the mask of elements whose x0 estimate lies
        inside [-1, 1]) for the whole batch, in blocks of rows."""
        s = self.schedule
        outs, epss, masks = [], [], []
        for a in range(0, x_t.shape[0], self.rows):
            x = x_t[a:a + self.rows].float()
            tb = torch.full((x.shape[0],), t, dtype=torch.int64,
                            device=x.device)
            eps = self.eps(x, tb)
            x0 = s.sqrt_recip_ab[t] * x - s.sqrt_recipm1_ab[t] * eps
            inside = x0.abs() <= 1.0
            mean = s.coef_x0[t] * x0.clamp(-1.0, 1.0) + s.coef_xt[t] * x
            if t:
                mean = mean + torch.exp(0.5 * s.log_var[t]) * noise[a:a + self.rows]
            outs.append(mean)
            epss.append(eps)
            masks.append(inside)
        return torch.cat(outs), torch.cat(epss), torch.cat(masks)

    @torch.no_grad()
    def calibrate(self, seed: int, noise, batch: int, n_points: int = 16,
                  snapshots=None) -> list:
        """Fills the gated convs' absmax as the int8 mode's calibration
        does (the trajectory mode): x ~ N(0, 1) from a CPU generator
        seeded `seed` at t = T - 1, then the states of the float chain
        after every T // n_points steps (a remainder first), each at the
        t of its chunk's last step less one; the quantized eps network
        runs on each in turn, each gated conv raising its absmax with its
        input first.  `noise(t)` is the chain's noise at t.  Returns the
        (x_t, t) pairs, which another precision may pass back in."""
        if snapshots is None:
            t_max = self.schedule.timesteps - 1
            shape = (batch, *self.sample_shape)
            x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
            x = x.to(self.schedule.sqrt_ab.device)
            snapshots = [(x, t_max)]
            every = max(1, (t_max + 1) // max(1, n_points))
            ts = list(range(t_max, -1, -1))
            rem = len(ts) % every
            set_mode(self.gated, "off")
            for k, t in enumerate(ts):
                x = self.p_sample(x, t, noise(t))[0]
                if k + 1 > rem and (k + 1 - rem) % every == 0 and t >= 1:
                    snapshots.append((x, t - 1))
        set_mode(self.gated, "observe")
        for x_t, t in snapshots:
            self.eps(x_t, torch.full((x_t.shape[0],), t, dtype=torch.int64,
                                     device=x_t.device))
        set_mode(self.gated, "serve")
        return snapshots

    @torch.no_grad()
    def decode(self, z):
        """The image of each latent, in [-1, 1] (NHWC)."""
        return torch.cat([self.up(z[a:a + self.rows].float())
                          for a in range(0, z.shape[0], self.rows)])

    # ------------------------------------------------------------ training

    def loss_rows(self, x, t, eps, batch: int):
        """The objective's share of these rows in a batch of `batch`:
        the latent L2 (summed over each row's latent) on the detached
        latent, plus the reconstruction L2 of the rows under the gate
        t < t_rec_max, each divided by the batch."""
        s = self.schedule
        with torch.no_grad():
            z = self.down(x)
        tt = t.to(x.device)
        z_t = (s.sqrt_ab[tt][:, None, None, None] * z
               + s.sqrt_1m_ab[tt][:, None, None, None] * eps)
        l_lat = (eps - self.eps(z_t, tt)).square().sum() / batch
        gate = torch.nonzero(t < self.t_rec_max).squeeze(1)
        if len(gate) == 0:
            return l_lat
        xr = x.index_select(0, gate.to(x.device))
        l_rec = (xr - self.up(self.down(xr))).square().sum() / batch
        return l_lat + l_rec

    def gradients(self, batches, ts, epss, masks=None) -> float:
        """Accumulates into .grad the mean over micro-batches of the
        objective's gradient; returns the mean objective.  `masks`, one
        per micro-batch (see `set_masks`), are the dropout masks the
        program drew; a configuration with dropout needs them."""
        if masks is None:
            if self.config["unet_dropout"]:
                raise ValueError("dropout runs on the program's masks; "
                                 "none were given")
            masks = [None] * len(batches)
        params = list(self.net.parameters())
        for p in params:
            p.grad = torch.zeros_like(p)
        total = 0.0
        for x, t, eps, mask in zip(batches, ts, epss, masks):
            batch = x.shape[0]
            for a in range(0, batch, self.rows):
                self.set_masks(mask, a, min(a + self.rows, batch))
                loss = self.loss_rows(x[a:a + self.rows], t[a:a + self.rows],
                                      eps[a:a + self.rows], batch)
                loss.backward()
                total += float(loss.detach())
            self.set_masks(None)
        for p in params:
            p.grad /= len(batches)
        return total / len(batches)

    def set_masks(self, masks, a: int = 0, b: int = 0) -> None:
        """Hands rows a..b of a micro-batch's dropout masks to the
        ResnetBlocks that drop: `masks` maps a block's name in the net
        (`unet.resnets.<i>`) to (bits, (C, H, W)), bits a uint8 tensor
        (B, C * H * W / 8), each byte eight consecutive elements of the
        row in NCHW order, the lowest bit first, 1 where the element is
        kept.  None clears them."""
        for name, m in self.net.named_modules():
            if isinstance(m, ResnetBlock) and m.dropout:
                m.mask = None if masks is None else unpack_mask(
                    *masks[name], a, b, self.schedule.sqrt_ab.device)


class Adam:
    """The global-norm clip at 1.0 (scale by 1 / |g| when |g| >= 1), then
    Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) and the EMA, which
    before its start step copies the parameters."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 ema_start: int = 2000):
        self.params, self.lr, self.ema_start = params, lr, ema_start
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.ema = [p.detach().clone() for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> List[torch.Tensor]:
        """Takes the step; returns the gradients as clipped."""
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = 1.0 if norm < 1.0 else 1.0 / norm
        grads = [g * scale for g in grads]
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + 1e-8))
        if self.t - 1 < self.ema_start:
            for e, p in zip(self.ema, self.params):
                e.copy_(p)
        else:
            raise NotImplementedError("the EMA's lerp is past the checked steps")
        return grads


def train_readings(ref: Reference, feeds, lr: float,
                   fault: Optional[str] = None) -> dict:
    """Runs len(feeds) optimizer steps of the reference from its weights,
    each fed (batches, ts, epss, dropout masks or None), and returns
    what the check compares: each step's objective, the first step's
    clipped gradient norm per leaf, and each leaf's change (parameters,
    then EMA) after the last step.  `fault` plants one of
    the faults the check must catch ('unchanged': the step leaves the
    state as it was; 'half_batch': the objective over the first half of
    each micro-batch only)."""
    names = [n for n, _ in ref.net.named_parameters()]
    params = list(ref.net.parameters())
    start = [p.detach().clone() for p in params]
    opt = Adam(params, lr)
    losses, grad_norms = [], None
    for i, (batches, ts, epss, masks) in enumerate(feeds):
        if fault == "half_batch":   # masks: their first rows are read
            half = batches[0].shape[0] // 2
            batches, ts, epss = ([b[:half] for b in v]
                                 for v in (batches, ts, epss))
        losses.append(ref.gradients(batches, ts, epss, masks))
        if fault == "unchanged":
            grads = [p.grad for p in params]
        else:
            grads = opt.step()
        if i == 0:
            grad_norms = [float(g.norm()) for g in grads]
    change = ([float((p.detach() - s).norm()) for p, s in zip(params, start)]
              + [float((e - s).norm()) for e, s in zip(opt.ema, start)])
    return {"names": names, "losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
