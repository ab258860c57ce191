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
from dddpm_tpu_torch.ops.convres import (
    backward_reference,
    fused_convres_block,
    reference_impl,
)

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


@pytest.mark.parametrize("mode", [{"downsample": True}, {"upsample": True}])
def test_module_with_dropout_runs_the_core_fused_and_the_rest_outside(
        monkeypatch, mode):
    """With dropout active the fused op computes the conv core alone
    (residual=False, scale=None), and dropout, residual and scaling
    follow outside, as the JAX module dispatches (resample.py:203-252)."""
    monkeypatch.setattr(resample, "FUSED_MIN_PIXELS", 0)
    calls = []

    def spy(*args, residual, scale):
        calls.append((residual, scale))
        return fused_convres_block(*args, residual=residual, scale=scale)

    monkeypatch.setattr(resample, "fused_convres_block", spy)
    block = resample.ConvResBlock(32, 32, 32, residual=True, dropout=0.5,
                                  **mode).train()
    x = torch.randn(2, 32, 16, 16, generator=torch.Generator().manual_seed(3))
    torch.manual_seed(0)
    got = block(x)
    assert calls == [(False, None)]
    hwio = [t for c in block.convs for t in (c.weight.permute(2, 3, 1, 0), c.bias)]
    core = reference_impl(x.permute(0, 2, 3, 1), *hwio, residual=False)
    torch.manual_seed(0)
    want = resample.scale_ref(
        (x + block.drop(core.permute(0, 3, 1, 2))).permute(0, 2, 3, 1),
        block.scale).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want)
    block.eval()
    block(x)
    assert calls[-1] == (True, block.scale)


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
    # wider blocks take the kernels too (the general route), as in JAX
    assert resample.ConvResBlock(64, 128, 128).fused_shape_ok(128, 128)


@pytest.mark.parametrize("cm", [32, 64, 96, 128, 48])
def test_gate_equals_jax_over_widths(cm):
    """The port's gate is JAX's _fused_shape_ok, with no width clause of
    its own, over cio, map sizes (the 128^2 floor, the row tile, W % 4,
    W % 8 at 'down') and scalings."""
    for cio in (32, 64, 96, 128, 192, 256, 48):
        for hh, ww in ((128, 128), (256, 256), (64, 64), (128, 126),
                       (129, 128), (136, 128), (128, 132), (256, 100)):
            for mode in ({}, {"upsample": True}, {"downsample": True}):
                kw = dict(dim=cm, in_channels=cio, out_channels=cio, **mode)
                want = jres.ConvResBlock(use_pallas=True,
                                         **kw)._fused_shape_ok(hh, ww)
                got = resample.ConvResBlock(**kw).fused_shape_ok(hh, ww)
                assert got == want, (kw, hh, ww)


def test_block_gives_grads_on_cpu_through_the_autograd_function():
    """On the CPU the autograd Function's plain backward gives every
    gradient, in each input's dtype and shape, equal to autograd through
    the plain forward (the same function, differentiated twice)."""
    args = [torch.from_numpy(a).requires_grad_() for a in _make(5, h=16, w=8)]
    fused_convres_block(*args, scale="down").square().sum().backward()
    leaves = [a.detach().clone().requires_grad_() for a in args]
    reference_impl(*leaves, scale="down").square().sum().backward()
    for a, ref in zip(args, leaves):
        assert a.grad.dtype == a.dtype and a.grad.shape == a.shape
        np.testing.assert_allclose(a.grad.numpy(), ref.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


# the JAX backward kernel's sums run over packed tiles in another order;
# dW sums ~500 products of magnitude up to ~5 (b1/b2 shifted by +2), so
# 5e-4 absolute is ~1e-5 of the largest gradient entries
GRAD_TOL = dict(rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("scale", [None, "up", "down"])
@pytest.mark.parametrize("residual", [True, False])
def test_block_grads_match_jax_custom_vjp(scale, residual):
    """dx and all eight dW/db from the port's autograd Function against
    jax.grad through the JAX fused block's custom VJP (its backward
    kernel in interpret mode), with b1/b2 shifted by +2 so that a halo
    slip shows at the image border."""
    args = _make(6, h=16, w=8, bias_shift=2.0)
    out_shape = {None: (2, 16, 8, 16), "up": (2, 32, 16, 16),
                 "down": (2, 8, 4, 16)}[scale]
    dy = np.random.default_rng(7).standard_normal(out_shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jax_fused(*a, residual, True, scale) * dy)

    want = jax.grad(jloss, argnums=tuple(range(9)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_convres_block(*leaves, residual=residual, scale=scale)
    (out * torch.from_numpy(dy)).sum().backward()
    names = ["dx", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dw4", "db4"]
    for name, t, w in zip(names, leaves, want):
        assert t.grad.shape == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("cm,cio", [(64, 128), (96, 192)])
def test_wide_block_and_grads_match_jax_fused_kernel(cm, cio):
    """At the widths of the general route (d_chans 128 and 192): the
    port's block and its autograd Function's gradients (plain versions
    on the CPU) against JAX's fused kernel and its custom VJP in
    interpret mode, B = 1, 16 x 16, b1/b2 shifted by +2; the forward at
    TOL, the gradients at GRAD_TOL, the existing tests' tolerances."""
    args = _make(10, cio=cio, cm=cm, b=1, h=16, w=16, bias_shift=2.0)
    dy = np.random.default_rng(11).standard_normal((1, 16, 16, cio)).astype(
        np.float32)

    def jloss(*a):
        return jnp.sum(jax_fused(*a, True, True, None) * dy)

    jargs = list(map(jnp.asarray, args))
    want_y = np.asarray(jax_fused(*jargs, True, True, None))
    want = jax.grad(jloss, argnums=tuple(range(9)))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_convres_block(*leaves, residual=True)
    np.testing.assert_allclose(out.detach().numpy(), want_y, **TOL)
    (out * torch.from_numpy(dy)).sum().backward()
    names = ["dx", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dw4", "db4"]
    for name, t, w in zip(names, leaves, want):
        assert t.grad.shape == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_backward_reference_is_the_unscaled_vjp():
    """backward_reference(dy) is what the kernel K3 is held against:
    autograd of the unscaled block at x."""
    args = [torch.from_numpy(a) for a in _make(8, h=16, w=8)]
    dy = torch.randn(2, 16, 8, 16, generator=torch.Generator().manual_seed(0))
    got = backward_reference(*args, dy, residual=False)
    leaves = [a.clone().requires_grad_() for a in args]
    (reference_impl(*leaves, residual=False) * dy).sum().backward()
    for g, t in zip(got, leaves):
        torch.testing.assert_close(g, t.grad)
