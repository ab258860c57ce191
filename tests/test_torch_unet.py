"""The port's UNet and resamplers against the JAX package: parameter
counts against the golden counts, the whole UNet on converted weights,
and the 4x4 transposed conv's spatial flip."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.models import resample as jres
from dddpm_tpu.models.blocks import ResnetBlock as JaxResnetBlock
from dddpm_tpu.models.blocks import Upsample as JaxUpsample
from dddpm_tpu.models.unet import Unet as JaxUnet
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.models import resample
from dddpm_tpu_torch.models.blocks import ResnetBlock, Upsample
from dddpm_tpu_torch.models.factory import param_count
from dddpm_tpu_torch.models.unet import Unet
from test_dddpm import REF_COUNTS
from test_unet import GOLDEN_COUNTS


# f32 convs in two frameworks (and oneDNN algorithms that vary with the
# thread count) sum in other orders: tests of conv stacks allow 1e-4
def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dim,in_ch,mults,expected", GOLDEN_COUNTS)
def test_unet_param_count_matches_golden(dim, in_ch, mults, expected):
    assert param_count(Unet(dim, in_ch, mults, dropout=0.1)) == expected


@pytest.mark.parametrize("name,make", [
    ("down_convres_64_3_8_n2_b3",
     lambda: resample.ConvResNet(64, 3, 8, 2, upsample=False, n_blocks=3)),
    ("up_convres_64_8_3_n2_b3",
     lambda: resample.ConvResNet(64, 8, 3, 2, upsample=True, n_blocks=3)),
    ("down_convres_64_3_8_n3_b3",
     lambda: resample.ConvResNet(64, 3, 8, 3, upsample=False, n_blocks=3)),
    ("simpledown_8_3_2", lambda: resample.SimpleDownConv(8, 3, 2)),
    ("simpleup_8_3_2", lambda: resample.SimpleUpConv(8, 3, 2)),
])
def test_resampler_param_count_matches_golden(name, make):
    assert param_count(make()) == REF_COUNTS[name]


def test_init_draws_torch_default_bounds_from_the_seed():
    from dddpm_tpu_torch.models.init import init_params_

    net = Unet(32, 3, (1, 2))
    init_params_(net, torch.Generator().manual_seed(0))
    first = {k: v.clone() for k, v in net.state_dict().items()}
    checked = 0
    for name, mod in net.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and mod.weight.numel() > 500:
            bound = 1.0 / np.sqrt(mod.weight[0].numel())
            w = mod.weight.detach()
            assert float(w.abs().max()) <= bound
            # U(-b, b) has std b/sqrt(3); 15% covers sampling noise
            assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.15 * bound
            checked += 1
    assert checked > 5
    init_params_(net, torch.Generator().manual_seed(0))
    assert all(torch.equal(first[k], v) for k, v in net.state_dict().items())
    init_params_(net, torch.Generator().manual_seed(1))
    assert not torch.equal(first["final_conv.weight"],
                           net.state_dict()["final_conv.weight"])


def test_unet_matches_jax_on_converted_weights():
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 7], np.int32)
    jnet = JaxUnet(dim=16, in_channels=3, dim_mults=(1, 2), dropout=0.1)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(t))
    net = Unet(16, 3, (1, 2), dropout=0.1).eval()
    net.load_state_dict(jax_to_state_dict(_np_tree(params), net))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    # f32 both sides; ~30 layers of convs and norms summed in other orders
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_unet_bf16_compute_keeps_f32_params_and_output():
    net = Unet(16, 3, (1, 2), compute_dtype=torch.bfloat16).eval()
    x = torch.randn(1, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net(x, torch.tensor([5]))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_unet_bf16_error_matches_jax_bf16_error():
    """bf16 compute (the main path's): the two frameworks round in other
    places, so hold the port's bf16 error against the f32 output to at
    most 2x the JAX package's own bf16 error (seen 0.029 vs 0.023)."""
    x = np.random.default_rng(6).standard_normal((2, 16, 16, 8)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    jnet = JaxUnet(dim=32, in_channels=8, dim_mults=(1, 2))
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))
    jax_bf16 = np.asarray(JaxUnet(dim=32, in_channels=8, dim_mults=(1, 2),
                                  dtype=jnp.bfloat16).apply(
        params, jnp.asarray(x), jnp.asarray(t)))
    net = Unet(32, 8, (1, 2), compute_dtype=torch.bfloat16).eval()
    net.load_state_dict(jax_to_state_dict(_np_tree(params), net))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    ours_err = np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max()
    assert ours_err <= 2.0 * np.abs(jax_bf16 - ref).max()


def test_resnet_block_with_skip_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    s = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    t = rng.standard_normal((2, 64)).astype(np.float32)
    jrb = JaxResnetBlock(32, 24)
    params = jrb.init(jax.random.PRNGKey(1), jnp.concatenate([x, s], -1),
                      jnp.asarray(t))
    want = jrb.apply(params, jnp.asarray(x), jnp.asarray(t), skip=jnp.asarray(s))
    rb = ResnetBlock(32, 24, time_dim=64).eval()
    rb.load_state_dict(jax_to_state_dict(_np_tree(params), rb))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = rb(nchw(x), torch.from_numpy(t), skip=nchw(s))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(4, 4), (5, 6)])
def test_conv_transpose_flip_is_pinned(hw):
    """flax ConvTranspose((4,4),(2,2),'SAME') == torch ConvTranspose2d(4,
    2, 1) with the kernel flipped in both spatial dims (convert.py), and
    the unflipped kernel does not match."""
    x = np.random.default_rng(2).standard_normal((1, *hw, 4)).astype(np.float32)
    for subpixel_max in (0, 1 << 30):   # both JAX application paths
        jmod = JaxUpsample(4, subpixel_max_elems=subpixel_max)
        params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
        want = np.asarray(jmod.apply(params, jnp.asarray(x)))
        up = Upsample(4)
        up.load_state_dict(jax_to_state_dict(_np_tree(params), up))
        with torch.no_grad():
            got = up(torch.from_numpy(x).permute(0, 3, 1, 2))
            kernel = np.asarray(params["params"]["ConvTranspose_0"]["kernel"])
            up.weight.copy_(torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
            unflipped = up(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, 2 * hw[0], 2 * hw[1], 4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_interpolate_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 16, 16, 3)).astype(np.float32)
    for size in ((8, 8), (32, 32)):
        jmod = jres.Interpolate(size=size)
        want = jmod.apply(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                          jnp.asarray(x))
        got = resample.Interpolate(size)(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("jcls,tcls,shape", [
    (jres.SimpleDownConv, resample.SimpleDownConv, (1, 16, 16, 3)),
    (jres.SimpleUpConv, resample.SimpleUpConv, (1, 4, 4, 8)),
])
def test_simple_convs_match_jax(jcls, tcls, shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    jmod = jcls(8, 3, 2)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    mod = tcls(8, 3, 2)
    mod.load_state_dict(jax_to_state_dict(_np_tree(params), mod))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_remat_unet_equals_the_plain_unet_with_dropout():
    """remat=True (torch.utils.checkpoint around each ResnetBlock under
    grad) keeps the state_dict keys, and gives the plain UNet's outputs
    and gradients with dropout 0.3 active: the recompute replays the
    dropout masks.  Without grad the blocks run as they are."""
    torch.manual_seed(0)
    plain = Unet(16, 3, (1, 2), dropout=0.3).train()
    remat = Unet(16, 3, (1, 2), dropout=0.3, remat=True).train()
    assert list(remat.state_dict()) == list(plain.state_dict())
    remat.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    t = torch.tensor([3, 700])
    outs, grads = [], []
    for net in (plain, remat):
        torch.manual_seed(5)
        out = net(x, t)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        outs.append(out.detach())
        grads.append({k: p.grad for k, p in net.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0])
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, msg=k)
    # dropout is live: another seed gives another output
    torch.manual_seed(6)
    with torch.no_grad():
        assert not torch.allclose(remat(x, t), outs[0])
    cfg = dict(unet_chan=16, unet_in=3, unet_dims=(1, 2), unet_dropout=0.0,
               use_pallas_attention=False, remat=True)
    assert Unet.from_config(cfg).remat and not Unet.from_config(
        dict(cfg, remat=False)).remat
