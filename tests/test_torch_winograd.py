"""The port's Winograd conv (ops/winograd.py: its plain versions on the
CPU) against the JAX package: transform_weights and
conv3x3_winograd_ref against dddpm_tpu/ops/winograd.py, and the K6
wrapper's plain path against conv3x3_winograd (Pallas, interpret mode),
on the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from dddpm_tpu.ops.math import mish as jax_mish
from dddpm_tpu.ops.pallas.winograd import conv3x3_winograd as jax_winograd
from dddpm_tpu.ops.winograd import conv3x3_winograd_ref as jax_ref
from dddpm_tpu.ops.winograd import transform_weights as jax_transform
from dddpm_tpu_torch.ops import winograd as wg


def _data(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(*shape), 0.05 * f(3, 3, shape[-1], cout), 0.1 * f(cout)


def _direct(x, w, b, apply_mish=False):
    """The JAX tests' yardstick: lax's direct 3x3 conv in f32."""
    x = jnp.asarray(x)
    if apply_mish:
        x = jax_mish(x)
    y = lax.conv_general_dilated(x, jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return np.asarray(y + jnp.asarray(b))


def test_matrices_match_jax():
    from dddpm_tpu.ops import winograd as jwg

    for ours, theirs in ((wg.BT, jwg.BT), (wg.G, jwg.G), (wg.AT, jwg.AT)):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("cin,cout", [(8, 16), (128, 256)])
def test_transform_weights_matches_jax(cin, cout):
    _, w, _ = _data((1, 2, 2, cin), cout)
    got = wg.transform_weights(torch.from_numpy(w))
    assert tuple(got.shape) == (4, 4, cin, cout)
    # f32, three-term sums with entries 1 and +-0.5 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_transform(w)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 16), 24), ((1, 16, 6, 8), 8)])
def test_ref_matches_jax_ref(shape, cout):
    x, w, b = _data(shape, cout)
    got = wg.conv3x3_winograd_ref(*map(torch.from_numpy, (x, w, b)))
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    # f32 both sides, the same transforms: sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # and the same function as the direct conv, at the JAX test's 1e-4
    np.testing.assert_allclose(got.numpy(), _direct(x, w, b), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,cout,apply_mish", [
    ((1, 16, 16, 128), 128, False),
    ((1, 16, 8, 128), 256, True),
])
def test_plain_matches_jax_kernel_f32(shape, cout, apply_mish):
    x, w, b = _data(shape, cout, seed=1)
    got = wg.conv3x3_winograd(*map(torch.from_numpy, (x, w, b)),
                              apply_mish=apply_mish).numpy()
    want = np.asarray(jax_winograd(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), apply_mish=apply_mish))
    # both round V and U to bf16 and sum the products in f32; an f32-ulp
    # difference in mish before that rounding can move one V by a bf16
    # ulp (0.4%), ~1e-3 at the output at most (seen 4e-4 with mish, 1e-6
    # without)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    # and the JAX test's yardstick: within 5e-2 of the direct conv
    assert np.abs(got - _direct(x, w, b, apply_mish)).max() < 5e-2


@pytest.mark.parametrize("apply_mish", [False, True])
def test_plain_matches_jax_kernel_bf16(apply_mish):
    x, w, b = _data((1, 16, 16, 128), 128, seed=2)
    got = wg.conv3x3_winograd(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w), torch.from_numpy(b),
                              apply_mish=apply_mish)
    assert got.dtype == torch.bfloat16
    want = jax_winograd(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                        jnp.asarray(b), apply_mish=apply_mish)
    want = np.asarray(want.astype(jnp.float32))
    # the same roundings; f32 sums in another order may move an output
    # across a bf16 rounding boundary: one bf16 ulp of the largest output
    ulp = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_plain_rounds_v_and_u_to_bf16():
    """In f32 the plain version still rounds V and U to bf16, as the TPU
    kernel does: it differs from the f32 reference by ~1e-2, not 1e-6."""
    x, w, b = map(torch.from_numpy, _data((1, 8, 8, 32), 32, seed=3))
    gap = float((wg.plain(x, w, b) - wg.conv3x3_winograd_ref(x, w, b)).abs().max())
    assert 1e-4 < gap < 5e-2


def test_wrapper_refuses_odd_sizes():
    x, w, b = map(torch.from_numpy, _data((1, 7, 8, 16), 16))
    with pytest.raises(ValueError, match="even"):
        wg.conv3x3_winograd(x, w, b)
    with pytest.raises(ValueError, match="even"):
        wg.conv3x3_winograd_ref(x, w, b)
