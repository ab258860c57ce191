"""The port's x2 dDDPM sampling slice held against the JAX package.

A tiny x2 dDDPM (image 16, unet_chan 16, dims (1, 2), T = 50, ConvResNet
resamplers with d_chans 32) is initialised in JAX, its weights are
converted, and both chains run over the same start and the same
per-step noise, drawn here as ddpm.py draws it
(normal(fold_in(rng, t))) and handed to the port pre-drawn.  All in
float32 on the CPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.models.factory import build_model as jax_build_model
from dddpm_tpu.sample import fix_samples as jax_fix_samples
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.models.factory import build_model, param_count
from dddpm_tpu_torch.sample import fix_samples, generate_samples

CONFIG = {
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
B = 2
LATENT = (B, 8, 8, 8)


@pytest.fixture(scope="module")
def pair():
    _, proc_j, init_j, _ = jax_build_model(CONFIG)
    params = init_j(jax.random.PRNGKey(0))
    net, proc, _, _ = build_model(CONFIG, device="cpu")
    net.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params),
                                          net))
    return proc_j, params, net, proc


def _jax_noise(rng, ts, shape):
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, t),
                                                  shape)) for t in ts])


def test_param_count_matches_jax(pair):
    _, params, net, _ = pair
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    assert param_count(net) == n_jax


def test_chain_decode_and_npy_match_jax(pair):
    proc_j, params, _, proc = pair
    rng = jax.random.PRNGKey(3)
    ts = [4, 3, 2, 1, 0]
    z0 = np.random.default_rng(0).standard_normal(LATENT).astype(np.float32)

    z_j = jax.jit(proc_j.p_sample_chain)(params, rng, jnp.asarray(z0),
                                         jnp.asarray(ts, jnp.int32))
    x_j = jax.jit(proc_j.rescaled_upsample)(params, z_j)
    noise = torch.from_numpy(_jax_noise(rng, ts, LATENT))
    z_t = proc.p_sample_chain(torch.from_numpy(z0), ts, noise=noise)
    with torch.no_grad():
        x_t = proc.rescaled_upsample(z_t)

    # f32 on both sides: conv and matmul sums differ only in order (seen
    # ~7e-7 after 5 steps); 1e-5 leaves room for other BLAS builds
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=1e-5)
    # [0, 255] after a per-image min-max stretch: 1e-5 of a ~1-wide range
    # becomes ~3e-3 (seen 8e-5)
    np.testing.assert_allclose(fix_samples(x_t), jax_fix_samples(x_j),
                               rtol=0, atol=3e-3)


def test_segmented_chain_is_bit_identical(pair):
    *_, proc = pair
    z0 = torch.randn(LATENT, generator=torch.Generator().manual_seed(1))
    ts = list(range(9, -1, -1))
    whole = proc.p_sample_chain(z0, ts, seed=5)
    part = proc.p_sample_chain(z0, ts[:4], seed=5)
    part = proc.p_sample_chain(part, ts[4:], seed=5)
    assert torch.equal(whole, part)


def test_noise_is_masked_at_t0(pair):
    *_, proc = pair
    z0 = torch.randn(LATENT, generator=torch.Generator().manual_seed(2))
    a = proc.p_sample_chain(z0, [0], noise=torch.zeros((1,) + LATENT))
    b = proc.p_sample_chain(z0, [0], noise=torch.full((1,) + LATENT, 9.0))
    assert torch.equal(a, b)


def test_snapshots_end_where_the_chain_ends(pair):
    *_, proc = pair
    x, z, snaps = proc.sample(2, seed=4, every=2, early_stop=45)
    x_plain, z_plain = proc.sample(2, seed=4, early_stop=45)
    # 5 steps (t 49..45) in chunks of 2: the odd step first, 2 snapshots
    assert tuple(snaps.shape) == (2, *LATENT)
    assert torch.equal(snaps[-1], z) and torch.equal(z, z_plain)
    assert torch.equal(x, x_plain) and tuple(x.shape) == (2, 16, 16, 3)


def test_reconstruct_shapes(pair):
    *_, proc = pair
    x = torch.rand((3, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    x_rec, z_rec = proc.reconstruct(x * 2 - 1, n=2, seed=1)
    assert tuple(x_rec.shape) == (2, 16, 16, 3)
    assert tuple(z_rec.shape) == (2, 8, 8, 8)
    assert float(x_rec.abs().max()) <= 1.0   # tanh-squashed image space


def test_generate_samples_shapes_and_range(pair):
    *_, proc = pair
    samples, latents, timing = generate_samples(
        proc, seed=0, fid_samples=3, batch_size=2, early_stop=47,
        progress=False)
    assert samples.shape == (2, 2, 16, 16, 3) and samples.dtype == np.float32
    assert latents.shape == (2, 2, 8, 8, 8)
    assert np.isfinite(samples).all()
    assert samples.min() >= 0.0 and samples.max() <= 255.0
    assert set(timing) == {"total_s", "per_sample_s", "per_batch_s",
                           "imgs_per_sec"}


def test_build_model_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(CONFIG)
