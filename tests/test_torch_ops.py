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


def _pad_case(kind, dtype):
    """(plain on the originals, plain on the wrapper's padded operands,
    sliced) for K5, K6 or K4 at a ragged width.  The data lie on dyadic
    grids small enough that every sum in the plain versions is exact in
    f32, so that the CPU BLAS's summation order, which moves with the
    padded shapes, cannot show; a mish prologue's inputs are 0 or >= 16,
    where the f32 mish is exactly 0 or the identity, and K4's k is 0 at 16
    of 64 tokens a dimension and -1000 elsewhere, so that the softmax's
    sums are exact."""
    from dddpm_tpu_torch.ops import conv3x3 as c3
    from dddpm_tpu_torch.ops import linear_attention as la
    from dddpm_tpu_torch.ops import winograd as wg
    from dddpm_tpu_torch.ops.math import pad_conv_channels

    rng = np.random.default_rng(17)

    def grid(shape, step, lo, hi):
        n = rng.integers(round(lo / step), round(hi / step) + 1, shape)
        return torch.from_numpy((n * step).astype(np.float32))

    def big_or_zero(shape):   # mish-exact inputs
        return grid(shape, 0.25, 16, 24) * torch.from_numpy(
            rng.integers(0, 2, shape).astype(np.float32))

    if kind == "k4":   # 3 heads of 20 -> 3 heads of 32
        q, v = grid((2, 64, 60), 0.25, -1, 1), grid((2, 64, 60), 0.25, -1, 1)
        k = torch.full((2, 64, 60), -1000.0)
        for b in range(2):
            for d in range(60):
                k[b, rng.permutation(64)[:16], d] = 0.0
        q, k, v = (t.to(dtype) for t in (q, k, v))
        want = la.plain(q, k, v, 20)
        pq, pk, pv = (la.pad_heads(t, 20) for t in (q, k, v))
        assert pq.shape == (2, 64, 96)
        return want, la.unpad_heads(la.plain(pq, pk, pv, 32), 20)
    cin, cout = (40, 72) if kind.startswith("k5") else (24, 40)
    w, b = grid((3, 3, cin, cout), 1 / 16, -1, 1), grid((cout,), 0.25, -2, 2)
    if kind == "k6":
        x = big_or_zero((2, 6, 8, cin)).to(dtype)
        want = wg.plain(x, w, b, True)
        xp, wp, bp, _ = pad_conv_channels(x, w, b, wg.CIN_STEP, wg.COUT_STEP)
        assert wp.shape == (3, 3, 32, 64)
        return want, wg.plain(xp, wp, bp, True)[..., :cout]
    kw = {}
    if kind == "k5":
        x = grid((2, 6, 8, cin), 0.25, -2, 2).to(dtype)
    else:
        x = big_or_zero((2, 6, 8, cin)).to(dtype)
    if kind == "k5_gn":
        kw = {"scale": grid((2, cin), 1, 1, 2), "shift": grid((2, cin), 16, 0, 16),
              "post_bias": grid((2, cin), 0.25, -1, 1).to(dtype)}
    want = c3.plain(x, w, b, apply_mish=kind == "k5_mish", **kw)
    xp, wp, bp, extra = pad_conv_channels(
        x, w, b, c3.CIN_STEP, c3.COUT_STEP,
        tuple(kw.get(n) for n in ("scale", "shift", "post_bias")))
    assert wp.shape == (3, 3, 64, 128)
    if kw:
        kw = dict(zip(("scale", "shift", "post_bias"), extra))
    return want, c3.plain(xp, wp, bp, apply_mish=kind == "k5_mish", **kw)[..., :cout]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["k5", "k5_mish", "k5_gn", "k6", "k4"])
def test_padding_in_the_wrappers_is_exact(kind, dtype):
    """K5, K6 and K4 take ragged widths by zero-padding channels (heads,
    for K4) in the wrapper: their plain versions on the padded operands,
    sliced, equal the plain versions on the originals bit for bit."""
    want, got = _pad_case(kind, dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
