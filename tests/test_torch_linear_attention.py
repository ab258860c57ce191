"""The port's linear attention (ops/linear_attention.py: its plain
versions on the CPU) against the JAX package's linear_attention (Pallas,
interpret mode) and _reference_impl, forward and gradients, on the same
numpy inputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.ops.pallas import linear_attention as jla
from dddpm_tpu_torch.ops import linear_attention as la


def _qkv(seed, b, n, hd, k_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, hd)).astype(np.float32) for _ in range(3))
    return q, k * k_scale, v


@pytest.mark.parametrize("b,n,hd", [(2, 256, 128), (2, 777, 64), (1, 128, 32),
                                    (1, 1024, 128)])
def test_forward_matches_jax_kernel_f32(b, n, hd):
    q, k, v = _qkv(n + hd, b, n, hd, k_scale=3.0)
    got = la.linear_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    want = np.asarray(jla.linear_attention(*map(jnp.asarray, (q, k, v)), 32, True))
    # f32: JAX carries a running max over its token tiles, the plain
    # version takes the max over all tokens at once, and sums run in
    # another order; with k scaled by 3 the exponents span a wide range
    # (seen 1.6e-5 at outputs of ~5): the JAX test's own 2e-4
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    ref = la.reference_impl(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(
        ref, np.asarray(jla._reference_impl(*map(jnp.asarray, (q, k, v)), 32)),
        rtol=2e-4, atol=2e-4)


def test_forward_matches_jax_kernel_bf16():
    q, k, v = _qkv(1, 1, 512, 128)
    got = la.linear_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = jla.linear_attention(*(jnp.asarray(t).astype(jnp.bfloat16)
                                  for t in (q, k, v)), 32, True)
    want = np.asarray(want.astype(jnp.float32))
    # both round ctx to bf16 before the q product and the output after
    # it; f32 sums in another order can move a value across a bf16
    # rounding boundary: one bf16 ulp of the largest output (seen 2e-6)
    ulp = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_plain_rounds_ctx_where_the_kernel_does():
    """In bf16 the plain version rounds ctx before the q product (the
    kernel's rounding); reference_impl keeps it f32.  They differ by
    about a bf16 ulp of ctx, far less than the output itself."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(2, 1, 256, 64))
    ctx = la.ctx_plain(k, v)
    assert tuple(ctx.shape) == (1, 2, 32, 32) and ctx.dtype == torch.float32
    gap = (la.plain(q, k, v).float() - la.reference_impl(q, k, v).float()).abs()
    assert 0 < float(gap.max()) < 0.05 * float(la.reference_impl(q, k, v).abs().max())


def test_gradients_match_jax():
    q, k, v = _qkv(3, 1, 64, 64)
    f = lambda *a: jnp.sum(jla.linear_attention(*a, 32, True) ** 2)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    la.linear_attention(*leaves).square().sum().backward()
    for t, w in zip(leaves, want):
        # both backwards are autograd through the same f32 reference
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_a_bf16_pair_of_p_keeps_ctx_at_f32_accuracy():
    """The bf16 ctx kernel's rule (csrc/linear_attention.cu, lin_ctx_mma):
    p = exp(k - m) split into a bf16 pair, hi = bf16(p) and lo = bf16(p -
    hi), each multiplied by v (exact in bf16) with f32 sums, gives
    ctx_plain (f32 products) within 1e-5 of its largest magnitude on
    skewed keys, where bf16(p) alone misses that bound."""
    rng = np.random.default_rng(7)
    k = 2.0 * rng.standard_normal((2, 2048, 128)).astype(np.float32)
    k[:, 300:340] += 6.0     # a few tokens hold most of the softmax's mass
    v = rng.standard_normal((2, 2048, 128)).astype(np.float32)
    k, v = (torch.from_numpy(t).bfloat16() for t in (k, v))
    want = la.ctx_plain(k, v)
    kf = la._split(k, 32).float()
    p = torch.exp(kf - kf.amax(dim=1, keepdim=True))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    vf = la._split(v, 32).float()

    def ctx_of(*parts):
        a = sum(torch.einsum("bnhd,bnhe->bhde", part, vf) for part in parts)
        return a / p.sum(dim=1)[..., None]

    bound = 1e-5 * float(want.abs().max())
    assert float((ctx_of(hi, lo) - want).abs().max()) <= bound
    assert float((ctx_of(hi) - want).abs().max()) > bound
