"""The port's vestigial helpers (models/variational.py, train/helpers.py,
data/datasets.py:get_label_map) against tests/test_aux.py's cases and
the JAX package's functions on the same numpy inputs."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.data.datasets import LABEL_MAPS as JAX_LABEL_MAPS
from dddpm_tpu.models import variational as jvar
from dddpm_tpu.train import helpers as jhelpers
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.data.datasets import LABEL_MAPS, get_label_map
from dddpm_tpu_torch.models import variational as tvar
from dddpm_tpu_torch.train import helpers


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_log_densities_match_jax():
    rng = np.random.default_rng(0)
    x, mu, lv = (rng.standard_normal((4, 3, 5)).astype(np.float32)
                 for _ in range(3))
    np.testing.assert_allclose(tvar.log_standard_gaussian(_t(x)).numpy(),
                               np.asarray(jvar.log_standard_gaussian(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tvar.log_gaussian(_t(x), _t(mu), _t(lv)).numpy(),
        np.asarray(jvar.log_gaussian(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(lv))),
        rtol=1e-5)
    # test_aux.py's cases: the value at zero, and N(0, I) as a special case
    want = -0.5 * math.log(2 * math.pi) * 3
    np.testing.assert_allclose(tvar.log_standard_gaussian(torch.zeros(2, 3)).numpy(),
                               want, rtol=1e-6)
    xt = _t(x)
    torch.testing.assert_close(
        tvar.log_gaussian(xt, torch.zeros_like(xt), torch.zeros_like(xt)),
        tvar.log_standard_gaussian(xt), rtol=1e-5, atol=0)


def test_reparametrize_stats_and_given_noise():
    gen = torch.Generator().manual_seed(1)
    mu = torch.full((20000,), 2.0)
    log_var = torch.full((20000,), math.log(0.25))
    z = tvar.reparametrize(mu, log_var, gen).numpy()
    assert abs(z.mean() - 2.0) < 0.02 and abs(z.std() - 0.5) < 0.02
    again = tvar.reparametrize(mu, log_var, torch.Generator().manual_seed(1))
    assert np.array_equal(again.numpy(), z)
    eps = torch.randn(20000)
    torch.testing.assert_close(tvar.reparametrize(mu, log_var, eps=eps),
                               mu + eps * 0.5)


@pytest.mark.parametrize("kind", ["sample", "merge"])
def test_gaussian_layers_match_jax_on_its_weights(kind):
    """GaussianSample / GaussianMerge on JAX's Dense weights, with JAX's
    own noise handed to the port: the same (z, mu, log_var)."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 8)), jnp.float32)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (2, 4), jnp.float32))
    if kind == "sample":
        jmod, mod = jvar.GaussianSample(4), tvar.GaussianSample(8, 4)
        params = jmod.init(key, x, key)
        want = jmod.apply(params, x, key)
        mod.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params), mod))
        got = mod(_t(x), eps=_t(eps))
    else:
        mu1 = jnp.asarray(rng.standard_normal((2, 4)), jnp.float32)
        lv1 = jnp.asarray(rng.standard_normal((2, 4)) * 0.3, jnp.float32)
        jmod, mod = jvar.GaussianMerge(4), tvar.GaussianMerge(8, 4)
        params = jmod.init(key, x, mu1, lv1, key)
        want = jmod.apply(params, x, mu1, lv1, key)
        mod.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params), mod))
        got = mod(_t(x), _t(mu1), _t(lv1), eps=_t(eps))
    for g, w in zip(got, want):
        assert g.shape == (2, 4)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def test_num_to_groups():
    assert helpers.num_to_groups(50000, 192) == [192] * 260 + [80]
    assert helpers.num_to_groups(10, 5) == [5, 5]
    for num, div in ((7, 3), (0, 4), (192, 192), (1, 8)):
        assert helpers.num_to_groups(num, div) == jhelpers.num_to_groups(num, div)


def test_lambda_lr():
    f, jf = helpers.lambda_lr(100, 0, 50), jhelpers.lambda_lr(100, 0, 50)
    assert f(0) == 1.0 and f(75) == 0.5
    np.testing.assert_allclose(f(100), 0.0)
    assert [f(e) for e in range(0, 120, 7)] == [jf(e) for e in range(0, 120, 7)]
    with pytest.raises(ValueError):
        helpers.lambda_lr(10, 0, 10)


def test_deterministic_warmup():
    w = iter(helpers.DeterministicWarmup(n=4, t_max=1.0))
    np.testing.assert_allclose([next(w) for _ in range(6)],
                               [0.25, 0.5, 0.75, 1.0, 1.0, 1.0])


def test_bce_loss_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.random((3, 2, 5)) > 0.5).astype(np.float32)
    r = rng.random((3, 2, 5)).astype(np.float32)
    r[0, 0, :2] = [0.0, 1.0]                       # clipped to [eps, 1 - eps]
    np.testing.assert_allclose(helpers.bce_loss(_t(r), _t(x)).numpy(),
                               np.asarray(jhelpers.bce_loss(jnp.asarray(r), jnp.asarray(x))),
                               rtol=1e-5)
    x1 = torch.tensor([[0.0, 1.0, 1.0, 0.0]])
    r1 = torch.tensor([[0.001, 0.999, 0.999, 0.001]])
    assert float(helpers.bce_loss(r1, x1)[0]) < 0.01


def test_delete_if_exists(tmp_path):
    path = tmp_path / "f"
    path.write_text("x")
    helpers.delete_if_exists(str(path))
    helpers.delete_if_exists(str(path))
    assert not path.exists()


def test_label_maps_match_jax():
    assert LABEL_MAPS == JAX_LABEL_MAPS
    assert len(get_label_map("cifar10")) == 10
    assert get_label_map("celeba_hq") == ["female", "male"]
    for bad in ("omniglot", "cifar100"):
        with pytest.raises(ValueError):
            get_label_map(bad)
