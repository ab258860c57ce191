"""The port's schedule and math primitives against the JAX package, on
the same numpy inputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.models.schedule import DiffusionSchedule as JaxSchedule
from dddpm_tpu.models.schedule import gather as jax_gather
from dddpm_tpu.ops import math as jm
from dddpm_tpu_torch.models.schedule import DiffusionSchedule, gather
from dddpm_tpu_torch.ops import math as tm


@pytest.mark.parametrize("kind,steps", [("linear", 1000), ("linear", 50),
                                        ("cosine", 1000), ("cosine", 50)])
def test_schedule_buffers_equal_jax(kind, steps):
    """Both sides compute in float64 numpy and store float32: equal."""
    ours = DiffusionSchedule.create(kind, steps)
    ref = JaxSchedule.create(kind, steps)
    bufs = ours.buffers()
    assert len(bufs) == 13 and ours.timesteps == ref.timesteps
    for name, t in bufs.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_gather_matches_jax():
    sched = DiffusionSchedule.create("linear", 100)
    t = np.array([0, 5, 99, 42])
    got = gather(sched.sqrt_alphas_cumprod, torch.from_numpy(t), 4)
    want = jax_gather(JaxSchedule.create("linear", 100).sqrt_alphas_cumprod,
                      jnp.asarray(t), 4)
    assert tuple(got.shape) == (4, 1, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mish_matches_jax():
    x = np.linspace(-30.0, 30.0, 4001, dtype=np.float32)
    # f32 transcendentals of two libraries: a few ulp
    np.testing.assert_allclose(tm.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.mish(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_mish_gradient_matches_jax_custom_jvp():
    """The autograd Function's backward is JAX's custom JVP
    t + x s (1 - t^2); in f32 on both sides, a few ulp apart."""
    x = np.linspace(-30.0, 30.0, 4001, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    tm.mish(xt).sum().backward()
    want = jax.grad(lambda v: jm.mish(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_min_max_norms_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 4, 5, 2)).astype(np.float32)
    for fn in ("min_max_norm_image", "min_max_norm_batch"):
        np.testing.assert_allclose(
            getattr(tm, fn)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jm, fn)(jnp.asarray(x))), rtol=1e-6, atol=1e-6,
            err_msg=fn)


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(1)
    m1, m2 = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
              for _ in range(2))
    lv1, lv2 = (rng.uniform(-3, 0, (2, 3, 4, 4)).astype(np.float32)
                for _ in range(2))
    x = np.clip(rng.uniform(-1.05, 1.05, (2, 3, 4, 4)), -1, 1).astype(np.float32)
    # means near x: far in the tails the tanh-based cdf rounds to 0 or 1
    # differently in the two libraries, and the log of the difference
    # is then library noise, not the function
    mx = (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    ls = rng.uniform(-4, -2, x.shape).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    j = jnp.asarray
    pairs = [
        (tm.normal_kl(t(m1), t(lv1), t(m2), t(lv2)),
         jm.normal_kl(j(m1), j(lv1), j(m2), j(lv2))),
        (tm.normal_kl(t(m1), t(lv1), 0.0, 0.0),
         jm.normal_kl(j(m1), j(lv1), 0.0, 0.0)),
        (tm.discretized_gaussian_log_likelihood(t(x), means=t(mx),
                                                log_scales=t(ls)),
         jm.discretized_gaussian_log_likelihood(j(x), means=j(mx),
                                                log_scales=j(ls))),
        (tm.flat_bits(t(m1)), jm.flat_bits(j(m1))),
        (tm.reduce_sum(t(m1)), jm.reduce_sum(j(m1))),
        (tm.l2_loss(t(m1), t(m2)), jm.l2_loss(j(m1), j(m2))),
        (tm.l1_loss(t(m1), t(m2)), jm.l1_loss(j(m1), j(m2))),
    ]
    for i, (ours, ref) in enumerate(pairs):
        # f32 elementwise math with exp/log/tanh: a few ulp
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=f"pair {i}")
