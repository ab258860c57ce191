"""The port's fused 3x3 conv (ops/conv3x3.py: its plain version on the
CPU) against the JAX package's conv3x3_fused (Pallas, interpret mode) in
its three prologue modes, and the port's ResnetBlock seam against the
seam of scripts/probe_block_fusion.py, rebuilt here from conv3x3_fused,
mish and lax.conv_general_dilated (the script changes JAX's config when
imported), on the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from dddpm_tpu.ops.math import mish as jax_mish
from dddpm_tpu.ops.pallas.conv3x3 import conv3x3_fused as jax_conv3x3_fused
from dddpm_tpu_torch.ops import conv3x3 as c3
from dddpm_tpu_torch.ops.math import mish

GROUPS, EPS = 8, 1e-5


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _data(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    return _f(rng, *shape), 0.05 * _f(rng, 3, 3, shape[-1], cout), 0.1 * _f(rng, cout)


def _prologue_args(bsz, c, mode, seed=7):
    rng = np.random.default_rng(seed)
    if mode == "identity":
        return {}
    if mode == "mish":
        return {"apply_mish": True}
    args = {"scale": 1.0 + 0.1 * _f(rng, bsz, c), "shift": 0.2 * _f(rng, bsz, c)}
    if mode == "gn_fold_post_bias":
        args["post_bias"] = 0.2 * _f(rng, bsz, c)
    return args


def _to(args, conv):
    return {k: v if isinstance(v, bool) else conv(v) for k, v in args.items()}


def _jax(x, w, b, args, dtype=jnp.float32):
    y = jax_conv3x3_fused(jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
                          jnp.asarray(b), **_to(args, jnp.asarray))
    return np.asarray(y.astype(jnp.float32))


MODES = ["identity", "mish", "gn_fold", "gn_fold_post_bias"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,cout", [((1, 16, 16, 128), 128),
                                        ((1, 16, 8, 128), 256),
                                        ((1, 8, 16, 256), 128)])
def test_plain_matches_jax_kernel_f32(mode, shape, cout):
    x, w, b = _data(shape, cout)
    args = _prologue_args(shape[0], shape[-1], mode)
    got = c3.conv3x3_fused(*map(torch.from_numpy, (x, w, b)),
                           **_to(args, torch.from_numpy))
    # f32 both sides: sums over 9 * Cin products in another order (seen
    # < 1e-5)
    np.testing.assert_allclose(got.numpy(), _jax(x, w, b, args), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_kernel_bf16(mode):
    x, w, b = _data((1, 16, 16, 128), 128, seed=1)
    args = _prologue_args(1, 128, mode)
    got = c3.conv3x3_fused(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w).bfloat16(), torch.from_numpy(b),
                           **_to(args, torch.from_numpy))
    assert got.dtype == torch.bfloat16
    want = _jax(x, w, b, args, jnp.bfloat16)
    # the same roundings (prologue to bf16, and again after post_bias;
    # f32 sums; output to bf16), but an f32 ulp apart in mish or in the
    # sums' order can move a value across a bf16 rounding boundary: one
    # bf16 ulp of the largest output (seen half of it)
    ulp = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_zero_padding_is_operand_space():
    """Out-of-image conv padding is zero AFTER the prologue (prologue(0)
    = mish(0.5) != 0), as tests/test_conv_kernels.py pins for JAX."""
    x, w, b = _data((1, 16, 8, 128), 128)
    scale, shift = np.ones((1, 128), np.float32), np.full((1, 128), 0.5, np.float32)
    got = c3.conv3x3_fused(*map(torch.from_numpy, (x, w, b)),
                           scale=torch.from_numpy(scale),
                           shift=torch.from_numpy(shift)).numpy()
    want = _jax(x, w, b, {"scale": scale, "shift": shift})
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # padding by prologue(0) instead would move the edge rows by ~1e-1
    pro = c3.prologue(torch.from_numpy(x), scale=torch.from_numpy(scale),
                      shift=torch.from_numpy(shift))
    padded = torch.nn.functional.pad(pro.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                     value=float(mish(torch.tensor(0.5))))
    wrong = (torch.nn.functional.conv2d(padded, torch.from_numpy(w).permute(3, 2, 0, 1))
             .permute(0, 2, 3, 1) + torch.from_numpy(b)).numpy()
    assert np.abs(wrong - want)[:, 0].max() > 1e-2


def test_post_bias_needs_scale():
    x, w, b = map(torch.from_numpy, _data((1, 8, 8, 32), 32))
    with pytest.raises(ValueError, match="post_bias"):
        c3.conv3x3_fused(x, w, b, post_bias=torch.zeros(1, 32))


# --- the ResnetBlock seam (scripts/probe_block_fusion.py:34-79) --------

def _jax_conv(x, w, b):
    y = lax.conv_general_dilated(x, w, (1, 1), ((1, 1), (1, 1)),
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                 preferred_element_type=jnp.float32)
    return (y + b.astype(jnp.float32)).astype(x.dtype)


def _jax_gn_mish(x, g, b):
    bs, h, w, c = x.shape
    xf = x.astype(jnp.float32).reshape(bs, h, w, GROUPS, c // GROUPS)
    mean = xf.mean(axis=(1, 2, 4), keepdims=True)
    var = ((xf - mean) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    y = ((xf - mean) * lax.rsqrt(var + EPS)).reshape(bs, h, w, c) * g + b
    return jax_mish(y).astype(x.dtype)


def _jax_gn_fold(x, g, b):
    bs, h, w, c = x.shape
    xf = x.astype(jnp.float32).reshape(bs, h, w, GROUPS, c // GROUPS)
    mean = xf.mean(axis=(1, 2, 4))
    var = ((xf - mean[:, None, None, :, None]) ** 2).mean(axis=(1, 2, 4))
    rep = c // GROUPS
    scale = jnp.repeat(lax.rsqrt(var + EPS), rep, axis=1) * g
    return scale, b - jnp.repeat(mean, rep, axis=1) * scale


def _jax_seam_xla(x, p):
    c1 = _jax_conv(x, p["w1"], p["b1"])
    h = _jax_gn_mish(c1, p["g1"], p["be1"]) + p["tb"][:, None, None, :]
    return _jax_gn_mish(_jax_conv(h, p["w2"], p["b2"]), p["g2"], p["be2"])


def _jax_seam_fused(x, p):
    c1 = _jax_conv(x, p["w1"], p["b1"])
    scale, shift = _jax_gn_fold(c1, p["g1"], p["be1"])
    c2 = jax_conv3x3_fused(c1, p["w2"], p["b2"], scale=scale, shift=shift,
                           post_bias=p["tb"])
    return _jax_gn_mish(c2, p["g2"], p["be2"])


def _seam_params(c, bsz, seed=3):
    rng = np.random.default_rng(seed)
    return {"w1": 0.05 * _f(rng, 3, 3, c, c), "b1": 0.05 * _f(rng, c),
            "w2": 0.05 * _f(rng, 3, 3, c, c), "b2": 0.05 * _f(rng, c),
            "g1": 1.0 + 0.1 * _f(rng, c), "be1": 0.1 * _f(rng, c),
            "g2": 1.0 + 0.1 * _f(rng, c), "be2": 0.1 * _f(rng, c),
            "tb": 0.05 * _f(rng, bsz, c)}


def test_gn_fold_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 128)).astype(np.float32)
    p = _seam_params(128, 2)
    got = c3.gn_fold(torch.from_numpy(x), torch.from_numpy(p["g1"]),
                     torch.from_numpy(p["be1"]))
    want = _jax_gn_fold(jnp.asarray(x), jnp.asarray(p["g1"]), jnp.asarray(p["be1"]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seam_matches_jax_seam(dtype):
    bsz, c = 2, 128
    x = np.random.default_rng(5).standard_normal((bsz, 8, 16, c)).astype(np.float32)
    p = _seam_params(c, bsz)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    floats = ("g1", "be1", "g2", "be2")   # GroupNorm params stay f32
    jp = {k: jnp.asarray(v) if k in floats else jnp.asarray(v).astype(jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v) if k in floats else torch.from_numpy(v).to(tdt)
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(tdt)
    fused = c3.seam_fused(tx, tp).float().numpy()
    unfused = c3.seam_plain(tx, tp).float().numpy()
    want_fused = np.asarray(_jax_seam_fused(jnp.asarray(x).astype(jdt), jp)
                            .astype(jnp.float32))
    want_xla = np.asarray(_jax_seam_xla(jnp.asarray(x).astype(jdt), jp)
                          .astype(jnp.float32))
    if dtype == "float32":
        # f32: sums and GN statistics in another order (seen < 1e-5)
        tol = 1e-4
    else:
        # bf16: four rounded stages; a value one bf16 ulp apart early can
        # move the output by a few ulps: 3% of its largest magnitude, the
        # probe's own equivalence bound
        tol = 3e-2 * np.abs(want_xla).max()
    np.testing.assert_allclose(fused, want_fused, rtol=0, atol=tol)
    np.testing.assert_allclose(unfused, want_xla, rtol=0, atol=tol)
    np.testing.assert_allclose(fused, unfused, rtol=0, atol=tol)
