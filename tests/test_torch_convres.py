"""The port's ConvResBlock (ops/convres.py, its plain version on the
CPU), ConvResBlock and ConvResNet modules against the JAX package's
fused_convres_block(..., interpret=True) and modules, on the same numpy
inputs and converted weights, in float32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.models import resample as jres
from dddpm_tpu.ops.pallas.convres import fused_convres_block as jax_fused
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.models import resample
from dddpm_tpu_torch.ops.convres import fused_convres_block

# f32 on both sides, conv sums in other orders: oneDNN picks its
# algorithm by thread count, and with the +2 bias shift the outputs reach
# ~5, where 5e-5 apart was seen; 1e-4 is ~2e-5 of that scale
TOL = dict(rtol=1e-4, atol=1e-4)


def _make(seed, cio=16, cm=8, b=2, h=32, w=16, bias_shift=0.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(b, h, w, cio),
            f(1, 1, cio, cm) / np.sqrt(cio), 0.1 * f(cm) + bias_shift,
            f(3, 3, cm, cm) / np.sqrt(9 * cm), 0.1 * f(cm) + bias_shift,
            f(3, 3, cm, cm) / np.sqrt(9 * cm), 0.1 * f(cm),
            f(1, 1, cm, cio) / np.sqrt(cm), 0.1 * f(cio))


@pytest.mark.parametrize("scale", [None, "up", "down"])
@pytest.mark.parametrize("h,w", [(32, 16), (16, 8)])
def test_block_matches_jax_fused_kernel(scale, h, w):
    # large b1/b2: mish(b) far from 0, so a halo that is not zeroed at
    # the top and bottom image rows shows there
    args = _make(0, h=h, w=w, bias_shift=2.0)
    want = np.asarray(jax_fused(*map(jnp.asarray, args), True, True, scale))
    got = fused_convres_block(*map(torch.from_numpy, args), residual=True,
                              scale=scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :2], want[:, :2], **TOL)
    np.testing.assert_allclose(got[:, -2:], want[:, -2:], **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_block_without_residual_matches_jax():
    args = _make(1)
    want = jax_fused(*map(jnp.asarray, args), False, True, None)
    got = fused_convres_block(*map(torch.from_numpy, args), residual=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", [{"downsample": True}, {"upsample": True}, {}])
def test_module_matches_jax_fused_module(monkeypatch, mode):
    monkeypatch.setattr(jres, "FUSED_MIN_PIXELS", 0)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 32)).astype(np.float32)
    kw = dict(dim=32, in_channels=32, out_channels=32, residual=True, **mode)
    jmod = jres.ConvResBlock(use_pallas=True, **kw)
    params = jres.ConvResBlock(use_pallas=False, **kw).init(
        jax.random.PRNGKey(1), jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    ours = resample.ConvResBlock(**kw).eval()
    ours.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params), ours))
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("upsample", [True, False])
def test_convresnet_matches_jax(monkeypatch, upsample):
    """d_chans 64 (cm 32, cio 64): the main path's block widths, with
    the JAX gate lowered so its fused kernel runs in interpret mode."""
    monkeypatch.setattr(jres, "FUSED_MIN_PIXELS", 0)
    shape = (1, 16, 16, 8) if upsample else (1, 32, 32, 3)
    cin, cout = (8, 3) if upsample else (3, 8)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jnet = jres.ConvResNet(64, cin, cout, 1, upsample=upsample, n_blocks=3,
                           use_pallas=True)
    params = jres.ConvResNet(64, cin, cout, 1, upsample=upsample,
                             n_blocks=3).init(jax.random.PRNGKey(4),
                                              jnp.asarray(x))
    want = jnet.apply(params, jnp.asarray(x))
    ours = resample.ConvResNet(64, cin, cout, 1, upsample=upsample,
                               n_blocks=3).eval()
    ours.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params), ours))
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_gate_matches_jax_where_the_kernel_applies():
    cases = [((128, 128), dict(dim=32, in_channels=32, out_channels=32)),
             ((256, 256), dict(dim=32, in_channels=64, out_channels=64)),
             ((128, 128), dict(dim=32, in_channels=64, out_channels=64,
                               downsample=True)),
             ((64, 64), dict(dim=32, in_channels=32, out_channels=32)),
             ((128, 126), dict(dim=32, in_channels=32, out_channels=32)),
             ((129, 128), dict(dim=32, in_channels=32, out_channels=32)),
             ((128, 128), dict(dim=32, in_channels=32, out_channels=64)),
             ((128, 128), dict(dim=32, in_channels=24, out_channels=24))]
    for (hh, ww), kw in cases:
        want = jres.ConvResBlock(use_pallas=True, **kw)._fused_shape_ok(hh, ww)
        assert resample.ConvResBlock(**kw).fused_shape_ok(hh, ww) == want, kw
    # the kernel takes 32 mid channels only: wider blocks stay plain
    assert not resample.ConvResBlock(64, 128, 128).fused_shape_ok(128, 128)


def test_block_refuses_grad_on_card_only():
    """On the CPU the plain version gives gradients."""
    args = [torch.from_numpy(a).requires_grad_() for a in _make(5, h=16, w=8)]
    fused_convres_block(*args).square().sum().backward()
    assert args[0].grad is not None
