"""The port's attention block (ops/attention_block.py, its plain
version on the CPU) and its PreNormLinearAttention against the JAX
package: attention_block(..., interpret=True), _reference_impl and the
flax module path, on the same numpy inputs, in float32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.models.blocks import PreNormLinearAttention as JaxPreNorm
from dddpm_tpu.ops.pallas import attention_block as jab
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.models.blocks import PreNormLinearAttention
from dddpm_tpu_torch.ops import attention_block as tab

HIDDEN = 128


def _inputs(seed, bsz, n, c, k_scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w_qkv = f(c, 3 * HIDDEN) / np.sqrt(c)
    w_qkv[:, HIDDEN:2 * HIDDEN] *= k_scale
    return (f(bsz, n, c), 1.0 + 0.1 * f(c), 0.1 * f(c), w_qkv.astype(np.float32),
            f(HIDDEN, c) / np.sqrt(HIDDEN), 0.1 * f(c))


@pytest.mark.parametrize("shape", [(2, 64, 32), (2, 1024, 64)])
def test_plain_block_matches_jax_fused_kernel(shape):
    args = _inputs(0, *shape)
    want = jab.attention_block(*map(jnp.asarray, args), 32, True)
    got = tab.attention_block(*map(torch.from_numpy, args), 32)
    # f32 both sides; the JAX kernel sums exp(k) unshifted and tiles the
    # token sums, the plain version shifts by the max: ~1e-6 apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    ref = jab._reference_impl(*map(jnp.asarray, args), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_clamped_regime_matches_jax():
    """k-logits far past K_CLAMP: both clamp before the softmax."""
    args = _inputs(1, 1, 64, 64, k_scale=10.0 * tab.K_CLAMP)
    ln = tab.layer_norm_f32(*map(torch.from_numpy, args[:3]))
    logits = ln @ torch.from_numpy(args[3][:, HIDDEN:2 * HIDDEN])
    assert float(logits.max()) > tab.K_CLAMP
    got = tab.attention_block(*map(torch.from_numpy, args), 32)
    assert torch.isfinite(got).all()
    ref = jab._reference_impl(*map(jnp.asarray, args), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    # the JAX kernel's unshifted exp(60) sums make f32 order visible
    fused = jab.attention_block(*map(jnp.asarray, args), 32, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("c,hw", [(32, 8), (64, 16)])
def test_prenorm_module_matches_jax_module_path(c, hw):
    x = np.random.default_rng(2).standard_normal((2, hw, hw, c)).astype(np.float32)
    mod = JaxPreNorm(dim=c, use_pallas=False)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial norm params so the g/b mapping is exercised
    params = jax.tree.map(np.asarray, params)
    params["params"]["norm"]["g"] = 1.0 + 0.1 * np.arange(c, dtype=np.float32) / c
    params["params"]["norm"]["b"] = 0.01 * np.arange(c, dtype=np.float32)
    want = mod.apply(params, jnp.asarray(x))
    ours = PreNormLinearAttention(c)
    ours.load_state_dict(jax_to_state_dict(params, ours))
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_pass_plain_versions_compose_to_the_block():
    """Plain pass A, the W_eff fold and plain pass B (what chip_smoke.py
    holds the two kernels against) give the whole block."""
    x, g, b, w_qkv, w_out, b_out = map(torch.from_numpy, _inputs(5, 2, 256, 64))
    w_q, w_k, w_v = (w_qkv.reshape(64, 3, HIDDEN)[:, i] for i in range(3))
    ctx = tab.ctx_reference(x, g, b, torch.cat([w_k, w_v], dim=1))
    assert tuple(ctx.shape) == (2, HIDDEN, HIDDEN)
    assert float(ctx[:, :32, 32:].abs().max()) == 0.0   # block diagonal
    y = tab.out_reference(x, g, b, tab.fold_w_eff(w_q, ctx, w_out, x.dtype),
                          b_out)
    # f32; the fold reassociates the three products
    np.testing.assert_allclose(y.numpy(),
                               tab.reference_impl(x, g, b, w_qkv, w_out,
                                                  b_out).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_cpu_block_leaves_input_untouched_with_inplace():
    args = list(map(torch.from_numpy, _inputs(3, 1, 1024, 32)))
    x0 = args[0].clone()
    tab.attention_block(*args, 32, inplace=True)
    assert torch.equal(args[0], x0)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, g, b, w_qkv, w_out, b_out = map(torch.from_numpy, _inputs(4, 1, 64, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tab.attention_ctx(x, g, b, w_qkv[:, HIDDEN:].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        tab.attention_out(x, g, b, torch.zeros(1, 32, 32), b_out)


def _one_pass_args(seed, bsz, n, c):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(bsz, n, c), 1.0 + 0.1 * f(c), 0.1 * f(c), 0.1 * f(c, 3 * HIDDEN),
            0.1 * f(HIDDEN, c), 0.1 * f(c))


def test_one_pass_plain_matches_jax_one_pass_kernel():
    """K1c's plain version and the block under FORCE_ONE_PASS (the plain
    path on the CPU) against JAX's single-dispatch kernel
    (_fused_forward_1pass, interpret mode) at N = 768, one tile."""
    args = _one_pass_args(13, 2, 768, 128)
    want = np.asarray(jab._fused_forward_1pass(*map(jnp.asarray, args), 32, True))
    targs = list(map(torch.from_numpy, args))
    # f32 both sides; the plain version folds W_eff by einsum and shifts
    # the softmax by its max, the JAX kernel sums exp(k) unshifted: the
    # JAX test's own 2e-5 against its reference
    np.testing.assert_allclose(tab.one_pass_reference(*targs).numpy(), want,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tab.attention_block(*targs).numpy(), want,
                               rtol=2e-5, atol=2e-5)


def test_force_one_pass_follows_the_environment():
    """FORCE_ONE_PASS mirrors JAX's _FORCE_ONE_PASS: DDDPM_ATTN_ONE_PASS
    == "1" when the module is imported, and nothing else."""
    import os
    import subprocess
    import sys

    assert tab.FORCE_ONE_PASS == (os.environ.get("DDDPM_ATTN_ONE_PASS") == "1")
    code = ("import dddpm_tpu_torch.ops.attention_block as ab; "
            "print(ab.FORCE_ONE_PASS)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, DDDPM_ATTN_ONE_PASS="1"),
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "True"


def test_one_pass_chain_matches_jax_one_pass_chain(monkeypatch):
    """Two steps of a tiny x2 chain with FORCE_ONE_PASS set on both sides:
    JAX with use_pallas_attention=True runs its one-pass kernel (interpret
    mode) at every attention site; the port on the CPU runs the plain
    path.  Same weights, start and per-step noise, in f32."""
    from dddpm_tpu.models.factory import build_model as jax_build_model
    from dddpm_tpu_torch.models.factory import build_model

    config = {
        "model": "dddpm", "dataset": "celeba_hq", "image_size": 16,
        "batch_size": 2, "T": 50, "loss_type": "simple",
        "beta_schedule": "linear", "loss_flat": "sum",
        "unet_chan": 16, "unet_dims": (1, 2), "unet_dropout": 0.0,
        "unet_in": 8, "n_downsamples": 1,
        "d_mode": "convolutional_res", "u_mode": "convolutional_res",
        "d_dropout": 0, "d_chans": 32, "d_n_blocks": 3, "u_n_blocks": 3,
        "ae_loss": True, "t_rec_max": 100, "force_latent": True,
        "compute_dtype": "float32",
    }
    monkeypatch.setattr(jab, "_FORCE_ONE_PASS", True)
    monkeypatch.setattr(tab, "FORCE_ONE_PASS", True)
    calls = []
    one_pass = jab._fused_forward_1pass
    monkeypatch.setattr(jab, "_fused_forward_1pass",
                        lambda *a: calls.append(1) or one_pass(*a))
    _, proc_j, init_j, _ = jax_build_model(dict(config, use_pallas_attention=True))
    params = init_j(jax.random.PRNGKey(0))
    net, proc, _, _ = build_model(config, device="cpu")
    net.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params), net))
    rng = jax.random.PRNGKey(3)
    ts = [4, 3]
    shape = (2, 8, 8, 8)
    z0 = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jax.jit(proc_j.p_sample_chain)(params, rng, jnp.asarray(z0),
                                          jnp.asarray(ts, jnp.int32))
    assert calls, "the JAX chain did not take its one-pass kernel"
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, t),
                                                   shape)) for t in ts])
    got = proc.p_sample_chain(torch.from_numpy(z0), ts,
                              noise=torch.from_numpy(noise))
    # f32, two UNet evaluations: sums in other orders (the two-pass chain
    # test sees ~7e-7 after five steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
