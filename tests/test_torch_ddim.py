"""The port's DDIM sampler and test-set VLB held against the JAX package.

Tiny models (image 16, unet_chan 16, dims (1, 2), T = 50; the x2 dDDPM
with ConvResNet resamplers of d_chans 32, and a plain DDPM) are
initialised in JAX and their weights converted.  JAX's draws (the
chain's start, normal(fold_in(rng, t)) per step or per t) are handed to
the port.  All in float32 on the CPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.evaluation.helpers import compute_test_losses as jax_helper
from dddpm_tpu.models.factory import build_model as jax_build_model
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.evaluation.helpers import compute_test_losses
from dddpm_tpu_torch.models.ddpm import fold_seed
from dddpm_tpu_torch.models.factory import build_model

X2 = {
    "model": "dddpm", "dataset": "celeba_hq", "image_size": 16,
    "batch_size": 2, "T": 50, "loss_type": "simple",
    "beta_schedule": "linear", "loss_flat": "sum",
    "unet_chan": 16, "unet_dims": (1, 2), "unet_dropout": 0.1,
    "unet_in": 8, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 32, "d_n_blocks": 3, "u_n_blocks": 3,
    "ae_loss": True, "t_rec_max": 100, "force_latent": True,
    "compute_dtype": "float32",
}
DDPM = dict(X2, model="ddpm", n_downsamples=0)
B = 2
LATENT = (B, 8, 8, 8)
IMAGE = (B, 16, 16, 3)


def _pair(config):
    _, proc_j, init_j, _ = jax_build_model(config)
    params = init_j(jax.random.PRNGKey(0))
    net, proc, _, _ = build_model(config, device="cpu")
    net.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params),
                                          net))
    return proc_j, params, proc


@pytest.fixture(scope="module")
def x2():
    return _pair(X2)


@pytest.fixture(scope="module")
def ddpm():
    return _pair(DDPM)


def _jax_draws(rng, keys, shape):
    """{t: normal(fold_in(rng, t), shape)} as torch tensors."""
    return {t: torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(rng, t), shape))) for t in keys}


def _close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("spacing", ["linear", "quad"])
@pytest.mark.parametrize("steps", [10, 50, 7])
def test_ddim_taus_match_jax(x2, spacing, steps):
    proc_j, _, proc = x2
    want = np.asarray(proc_j.ddim_taus(steps, spacing)).tolist()
    assert proc.ddim_taus(steps, spacing) == want
    assert want[0] > want[-1]


def test_ddim_taus_reject_unknown_spacing(x2):
    with pytest.raises(ValueError, match="unknown tau spacing"):
        x2[2].ddim_taus(10, "cubic")


def _jax_ddim_step(proc_j, params, img, t, t_prev, eta, noise):
    """One step of dddpm_tpu/models/ddpm.py:ddim_sample_loop's scan."""
    s = proc_j.schedule
    t_b = jnp.full((img.shape[0],), t, jnp.int32)
    eps_hat = proc_j.eps_fn(params, img, t_b, None, False)
    x0 = proc_j.predict_x_from_eps(img, t_b, eps_hat, clip=True)
    ab = s.alphas_cumprod[t]
    ab_prev = jnp.where(t_prev < 0, 1.0, s.alphas_cumprod[t_prev])
    sigma = (eta * jnp.sqrt((1.0 - ab_prev) / (1.0 - ab))
             * jnp.sqrt(1.0 - ab / ab_prev))
    dir_xt = jnp.sqrt(jnp.maximum(1.0 - ab_prev - sigma ** 2, 0.0))
    return jnp.sqrt(ab_prev) * x0 + dir_xt * eps_hat + sigma * noise


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax(x2, eta):
    """S = 10 with JAX's start and per-t noise.  Each step, from JAX's
    state, and the decode equal JAX's at 1e-4 x max(1, max|x|).  The
    free-running chains are held at 2e-3: at T = 50 the first steps
    multiply the nets' f32 rounding (~2e-6 in eps) by sqrt(1/ab - 1),
    up to 359 (seen 6.5e-4 at the end of the chain)."""
    proc_j, params, proc = x2
    rng = jax.random.PRNGKey(7)
    x_j, z_j = jax.jit(lambda p, r: proc_j.ddim_sample(p, r, B, 10, eta))(
        params, rng)
    chain_rng, init_rng = jax.random.split(rng)
    start = np.array(jax.random.normal(init_rng, LATENT, jnp.float32))
    taus = proc.ddim_taus(10)
    draws = _jax_draws(chain_rng, taus, LATENT)

    img = jnp.asarray(start)
    coefs = proc.ddim_coefficients(taus, eta)
    for i, t in enumerate(taus):
        t_prev = taus[i + 1] if i + 1 < len(taus) else -1
        want = _jax_ddim_step(proc_j, params, img, t, t_prev, eta,
                              jnp.asarray(draws[t].numpy()))
        with torch.no_grad():
            got = proc.ddim_step(torch.from_numpy(np.array(img)), t, coefs[i],
                                 draws[t])
        _close(got.numpy(), want, 1e-4)
        img = want
    z = proc.ddim_sample_chain(torch.from_numpy(start), taus, eta,
                               noise=draws.__getitem__)
    with torch.no_grad():
        x = proc.rescaled_upsample(z)
        x_from_jax_z = proc.rescaled_upsample(torch.from_numpy(np.array(z_j)))
    _close(x_from_jax_z.numpy(), x_j, 1e-4)
    _close(z.numpy(), z_j, 2e-3)
    _close(x.numpy(), x_j, 2e-3)
    assert x.shape == IMAGE and z.shape == LATENT


def test_ddim_eta0_ignores_noise_and_eta_draws_it(x2):
    *_, proc = x2
    zeros = lambda t: torch.zeros(LATENT)
    nines = lambda t: torch.full(LATENT, 9.0)
    assert torch.equal(proc.ddim_sample(B, seed=3, num_steps=5, noise=zeros)[1],
                       proc.ddim_sample(B, seed=3, num_steps=5, noise=nines)[1])
    a = proc.ddim_sample(B, seed=3, num_steps=5, eta=1.0, noise=zeros)[1]
    b = proc.ddim_sample(B, seed=3, num_steps=5, eta=1.0, noise=nines)[1]
    assert not torch.equal(a, b)


def test_q_mean_variance_vlb_terms_and_prior_match_jax(ddpm):
    proc_j, params, proc = ddpm
    rng = np.random.default_rng(1)
    x = np.clip(rng.standard_normal(IMAGE) * 0.8, -1, 1).astype(np.float32)
    eps = rng.standard_normal(IMAGE).astype(np.float32)
    # eps_hat near eps, as a net's is: far from it, the t = 0 NLL's cdf
    # difference cancels in f32 and both sides land on its 1e-12 clamp
    eps_hat = (eps + 0.1 * rng.standard_normal(IMAGE)).astype(np.float32)
    for t in ([0, 17], [49, 1], [0, 0]):
        t_j = jnp.asarray(t, jnp.int32)
        t_p = torch.tensor(t)
        x_t = np.array(proc_j.q_sample(jnp.asarray(x), t_j, jnp.asarray(eps)))
        for got, want in zip(proc.q_mean_variance(torch.from_numpy(x), t_p),
                             proc_j.q_mean_variance(jnp.asarray(x), t_j)):
            np.testing.assert_allclose(got.numpy(), np.broadcast_to(
                np.asarray(want), got.shape), rtol=1e-5, atol=1e-7)
        want = proc_j.vlb_terms(params, jnp.asarray(x), jnp.asarray(x_t), t_j,
                                eps_hat=jnp.asarray(eps_hat))
        got = proc.vlb_terms(torch.from_numpy(x), torch.from_numpy(x_t), t_p,
                             torch.from_numpy(eps_hat))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        proc.calc_prior(torch.from_numpy(x)).numpy(),
        np.asarray(proc_j.calc_prior(jnp.asarray(x))), rtol=1e-5)


@pytest.mark.parametrize("which", ["ddpm", "x2"])
def test_test_losses_match_jax(request, which):
    proc_j, params, proc = request.getfixturevalue(which)
    x = np.random.default_rng(2).uniform(-1, 1, IMAGE).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    want = jax.jit(proc_j.test_losses)(params, rng, jnp.asarray(x))
    shape = IMAGE if which == "ddpm" else LATENT
    draws = _jax_draws(rng, range(X2["T"]), shape)
    got = proc.test_losses(torch.from_numpy(x), noise=draws.__getitem__)
    assert set(got) == set(want) == {"vlb_t", "prior", "vlb", "L_simple_t",
                                     "L_simple"}
    assert got["vlb_t"].shape == (B, X2["T"])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_test_losses_run_without_grad_one_forward_per_t(x2):
    *_, proc = x2
    calls = []
    inner = proc.eps_fn
    proc.eps_fn = lambda x, t: (calls.append(int(t[0])), inner(x, t))[1]
    try:
        x = torch.zeros(IMAGE, requires_grad=True)
        out = proc.test_losses(x, seed=4)
    finally:
        proc.eps_fn = inner
    assert calls == list(range(X2["T"] - 1, -1, -1))
    assert not any(v.requires_grad for v in out.values())
    assert torch.isfinite(out["vlb"]).all()


def _fake_losses(mod, x):
    flat = x.reshape(x.shape[0], -1)
    return {"vlb": mod.abs(flat).mean(1) * 3.0, "L_simple": (flat ** 2).sum()}


class _JaxFake:
    def test_losses(self, params, rng, x):
        return _fake_losses(jnp, x)


class _TorchFake:
    """Test losses as fixed functions of the batch; records the seeds."""

    device = "cpu"

    def __init__(self):
        self.seeds = []

    def test_losses(self, x, seed=0):
        self.seeds.append(seed)
        return _fake_losses(torch, x)


def test_compute_test_losses_averages_as_jax():
    rng = np.random.default_rng(3)
    loader = [(rng.standard_normal((4, 5, 5, 3)).astype(np.float32), None)
              for _ in range(3)]
    for cap in (2, None):
        want = jax_helper(_JaxFake(), None, jax.random.PRNGKey(0), loader,
                          max_batches=cap)
        fake = _TorchFake()
        got = compute_test_losses(fake, 9, loader, max_batches=cap)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert fake.seeds == [fold_seed(9, i) for i in range(cap or 3)]
