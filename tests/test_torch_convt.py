"""The port's subpixel transposed conv (ops/convt.py) against
F.conv_transpose2d and the JAX package's conv_transpose_2x_subpixel on
the same numpy inputs, f32 at 1e-5 of the largest output (convs summed
in other orders)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from dddpm_tpu.ops.convt import conv_transpose_2x_subpixel as jax_subpixel
from dddpm_tpu_torch.ops.convt import conv_transpose_2x_subpixel

SHAPES = [((2, 8, 8, 16), 24), ((1, 5, 7, 8), 8), ((3, 4, 4, 4), 12)]


def _case(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    # torch's (Cin, Cout, 4, 4) and flax's (4, 4, Cin, Cout), flipped
    w = rng.standard_normal((shape[-1], cout, 4, 4)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, w, b


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("shape,cout", SHAPES)
@pytest.mark.parametrize("bias", [False, True])
def test_subpixel_matches_conv_transpose2d(shape, cout, bias):
    x, w, b = _case(shape, cout, sum(shape) + cout)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bt = torch.from_numpy(b) if bias else None
    got = conv_transpose_2x_subpixel(xt, torch.from_numpy(w), bt)
    want = F.conv_transpose2d(xt, torch.from_numpy(w), bt, stride=2, padding=1)
    assert got.shape == (shape[0], cout, 2 * shape[1], 2 * shape[2])
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_subpixel_matches_jax(shape, cout):
    x, w, b = _case(shape, cout, 7 * cout)
    kernel = np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])
    want = np.asarray(jax_subpixel(jnp.asarray(x), jnp.asarray(kernel),
                                   jnp.asarray(b)))
    got = conv_transpose_2x_subpixel(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     torch.from_numpy(w), torch.from_numpy(b))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_subpixel_refuses_other_kernels():
    with pytest.raises(ValueError, match="4x4"):
        conv_transpose_2x_subpixel(torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3))
