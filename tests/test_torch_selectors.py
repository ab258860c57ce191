"""The JAX package's two kernel selectors, mirrored in the port:
use_pallas_attention ('auto' | True | False, pinned into the config by
build_model) and use_pallas_resample (True | False).  False takes the
plain path wherever the tensors lie; tests/test_torch_cuda.py shows on
the card that no kernel launches then."""
import numpy as np
import pytest
import torch

from dddpm_tpu import config as jconfig
from dddpm_tpu.models import resample as jres
from dddpm_tpu.models.unet import resolve_use_pallas as jax_resolve
from dddpm_tpu_torch import config as tconfig
from dddpm_tpu_torch.models import blocks, resample
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.models.unet import Unet, resolve_use_pallas

# a tiny x2 dDDPM whose resamplers have the fused block's widths
# (cio 64 / cm 32)
CONFIG = {
    "model": "dddpm", "dataset": "synthetic", "image_size": 16,
    "batch_size": 2, "T": 50, "loss_type": "simple",
    "beta_schedule": "linear", "loss_flat": "sum",
    "unet_chan": 8, "unet_dims": (1, 2), "unet_dropout": 0.0,
    "unet_in": 8, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 64, "d_n_blocks": 2, "u_n_blocks": 2,
    "ae_loss": True, "t_rec_max": 5, "force_latent": True,
    "compute_dtype": "float32",
}


def test_defaults_are_the_jax_packages():
    for key in ("use_pallas_attention", "use_pallas_resample"):
        assert tconfig.CONFIG_PORT[key] == jconfig.CONFIG_TPU[key], key


@pytest.mark.parametrize("value,want", [("auto", False), (True, True),
                                        (False, False)])
def test_build_model_on_the_cpu_pins_the_attention_selector(value, want):
    """'auto' becomes False on the CPU, as the JAX package resolves it on
    its CPU backend; an explicit bool stays.  The UNet's attention
    blocks carry the pinned value."""
    cfg = dict(CONFIG, use_pallas_attention=value)
    assert jax_resolve(cfg) is want   # the JAX tests run on the CPU
    net, _, _, out = build_model(cfg, device="cpu")
    assert out["use_pallas_attention"] is want
    assert cfg["use_pallas_attention"] == value   # the caller's dict is kept
    assert {m.use_pallas for m in net.unet.attns} == {want}


def test_auto_resolves_to_the_kernels_on_a_cuda_device():
    assert resolve_use_pallas({}, torch.device("cuda")) is True
    assert resolve_use_pallas({"use_pallas_attention": "auto"}, "cuda:0") is True
    assert resolve_use_pallas({"use_pallas_attention": False}, "cuda") is False
    assert resolve_use_pallas({}, "cpu") is False


def test_unet_from_config_takes_a_resolved_selector():
    with pytest.raises(ValueError):
        Unet.from_config(dict(CONFIG, use_pallas_attention="auto"))
    assert not Unet.from_config(dict(CONFIG, use_pallas_attention=False)).attns[0].use_pallas


def test_attention_selector_false_takes_the_plain_version(monkeypatch):
    """With use_pallas False the block never calls attention_block (the
    kernels' entry) and gives the plain version's result."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 32)).astype(np.float32)).permute(0, 3, 1, 2)
    on = blocks.PreNormLinearAttention(32)
    off = blocks.PreNormLinearAttention(32, use_pallas=False)
    off.load_state_dict(on.state_dict())
    with torch.no_grad():
        want = on(x)

        def refuse(*a, **k):
            raise AssertionError("attention_block called")

        monkeypatch.setattr(blocks, "attention_block", refuse)
        got = off(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_resample_selector_false_closes_the_gate():
    kw = dict(dim=32, in_channels=64, out_channels=64)
    assert resample.ConvResBlock(**kw).fused_shape_ok(128, 128)
    assert not resample.ConvResBlock(use_pallas=False, **kw).fused_shape_ok(128, 128)
    # as the JAX module's gate: use_pallas and the shape
    assert jres.ConvResBlock(use_pallas=True, **kw)._fused_shape_ok(128, 128)


@pytest.mark.parametrize("value", [True, False])
def test_resample_selector_reaches_every_block(value):
    net, _, _, out = build_model(dict(CONFIG, use_pallas_resample=value),
                                 device="cpu")
    blks = [m for m in net.modules() if isinstance(m, resample.ConvResBlock)]
    assert len(blks) == 4 and out["use_pallas_resample"] is value
    assert {b.use_pallas for b in blks} == {value}
    assert all(b.fused_shape_ok(128, 128) is value for b in blks)


def test_resample_selector_false_runs_the_plain_convs(monkeypatch):
    """At a shape the fused block takes, use_pallas False never calls
    fused_convres_block and equals the fused call's plain version."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 64, 128, 128)).astype(np.float32))
    on = resample.ConvResBlock(32, 64, 64, residual=True).eval()
    off = resample.ConvResBlock(32, 64, 64, residual=True,
                                use_pallas=False).eval()
    off.load_state_dict(on.state_dict())
    with torch.no_grad():
        want = on(x)

        def refuse(*a, **k):
            raise AssertionError("fused_convres_block called")

        monkeypatch.setattr(resample, "fused_convres_block", refuse)
        got = off(x)
    # f32 convs by two routes (one fused plain version, four Conv2d)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
