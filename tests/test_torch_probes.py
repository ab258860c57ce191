"""The probes' plain versions (dddpm_tpu_torch/probes/, run on CPU
tensors) against the TPU probe kernels of scripts/probe_*.py, run in
interpret mode (pl.pallas_call patched to interpret=True), on the same
numpy inputs: every variant of P1 (G = 1 and 4), P2, P3 and P4, in f32
where the point is the algorithm and once per probe in bf16."""
import functools
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dddpm_tpu_torch.probes import _util
from dddpm_tpu_torch.probes import attention_ceiling as p1
from dddpm_tpu_torch.probes import attention_writeback as p2
from dddpm_tpu_torch.probes import cmajor_conv as p4
from dddpm_tpu_torch.probes import convres_variants as p3

ROOT = Path(__file__).resolve().parent.parent
_PALLAS_CALL = pl.pallas_call


def _import_script(name):
    """scripts/<name>.py, as tests/test_evaluation.py imports a script;
    the probes set JAX's compile-cache options when imported, which are
    put back here."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    try:
        return importlib.import_module(name)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


jp1 = _import_script("probe_attention_ceiling")


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))


_TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _f(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _cast(arrays, jdt, tdt):
    """(jax arrays in jdt, torch tensors in tdt) of the numpy arrays;
    1-D ones (LN and bias vectors) stay f32, as the probes keep them."""
    j = [jnp.asarray(a) if a.ndim == 1 else jnp.asarray(a).astype(jdt)
         for a in arrays]
    t = [torch.from_numpy(a) if a.ndim == 1 else torch.from_numpy(a).to(tdt)
         for a in arrays]
    return j, t


def _assert_close(got, want, frac):
    """max |got - want| <= frac * max(1, max |want|)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = float(np.abs(got - want).max())
    tol = frac * max(1.0, float(np.abs(want).max()))
    assert err <= tol, (err, tol)


# ------------------------------------------------------------------ P1

P1_SHAPE = (4, 1024, 128)    # B, N, C; tn_target 512 gives 2 token tiles
# C = 256, the widest both passes take: LN's squares summed in f32, not
# rounded to bf16 first as at C <= 128
P1_SHAPE_256 = (2, 1024, 256)
P1_TN_TARGET = 512
JAX_A_NAME = {"full": "exp"}


def _p1_data(seed, shape=P1_SHAPE):
    rng = np.random.default_rng(seed)
    bsz, _, c = shape
    return (_f(rng, *shape), 1.0 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1),
            _f(rng, c, 256, scale=0.1), _f(rng, bsz, c, c, scale=0.1),
            _f(rng, c, scale=0.1))


def _p1_pass_a(variant, group, jdt, tdt, seed=0, shape=P1_SHAPE):
    x, g, b, w_kv, _, _ = _p1_data(seed, shape)
    (jx, jg, jb, jw), (tx, tg, tb, tw) = _cast((x, g, b, w_kv), jdt, tdt)
    want = jp1.make_pass_a(JAX_A_NAME.get(variant, variant), group,
                           P1_TN_TARGET)(jx, jg, jb, jw)
    got = p1.pass_a(tx, tg, tb, tw, variant, group, P1_TN_TARGET)
    return got, want


def _p1_pass_b(variant, group, jdt, tdt, seed=1, shape=P1_SHAPE):
    x, g, b, _, w_eff, b_out = _p1_data(seed, shape)
    (jx, jg, jb, jw, jbo), (tx, tg, tb, tw, tbo) = _cast(
        (x, g, b, w_eff, b_out), jdt, tdt)
    want = jp1.make_pass_b(variant, group, P1_TN_TARGET)(jx, jg, jb, jw, jbo)
    got = p1.pass_b(tx, tg, tb, tw, tbo, variant, group, P1_TN_TARGET)
    return got, want


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("variant", p1.PASS_A)
def test_p1_pass_a_matches_jax_probe_f32(variant, group):
    got, want = _p1_pass_a(variant, group, jnp.float32, torch.float32)
    assert got.shape == (P1_SHAPE[0], 128, 128)
    # f32 both sides: sums over 1024 tokens in another order
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("variant", p1.PASS_B)
def test_p1_pass_b_matches_jax_probe_f32(variant, group):
    got, want = _p1_pass_b(variant, group, jnp.float32, torch.float32)
    assert got.shape == P1_SHAPE
    # f32 both sides: sums over C in another order
    _assert_close(got, want, 1e-5)


def test_p1_full_passes_match_jax_probe_bf16():
    got, want = _p1_pass_a("full", 4, jnp.bfloat16, torch.bfloat16)
    # the same roundings (LN, p and v to bf16); an LN value one bf16 ulp
    # apart moves a product of A by ~0.4%, averaged over 1024 tokens
    _assert_close(got, want, 1e-2)
    got, want = _p1_pass_b("full", 1, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # y rounded to bf16 on both sides: at most one ulp (0.4-0.8%) apart
    _assert_close(got, want, 1e-2)


@pytest.mark.parametrize("variant", p1.PASS_A)
def test_p1_pass_a_matches_jax_probe_f32_c256(variant):
    got, want = _p1_pass_a(variant, 1, jnp.float32, torch.float32,
                           shape=P1_SHAPE_256)
    assert got.shape == (P1_SHAPE_256[0], 128, 128)
    # f32 both sides: sums over 1024 tokens and 256 channels in another order
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("variant", p1.PASS_B)
def test_p1_pass_b_matches_jax_probe_f32_c256(variant):
    got, want = _p1_pass_b(variant, 1, jnp.float32, torch.float32,
                           shape=P1_SHAPE_256)
    assert got.shape == P1_SHAPE_256
    # f32 both sides: sums over C in another order
    _assert_close(got, want, 1e-5)


def test_p1_full_passes_match_jax_probe_bf16_c256():
    got, want = _p1_pass_a("full", 1, jnp.bfloat16, torch.bfloat16,
                           shape=P1_SHAPE_256)
    # the same roundings as at C = 128 (LN, p and v to bf16)
    _assert_close(got, want, 1e-2)
    got, want = _p1_pass_b("full", 1, jnp.bfloat16, torch.bfloat16,
                           shape=P1_SHAPE_256)
    assert got.dtype == torch.bfloat16
    # y rounded to bf16 on both sides: at most one ulp (0.4-0.8%) apart
    _assert_close(got, want, 1e-2)


def test_p1_token_tile_keeps_the_probe_rule():
    # B = 96 at 128^2 gives 192 blocks for every G
    n = 128 * 128
    assert [p1.token_tile(n, 128, g) for g in p1.GROUPS] == [8192, 2048, 1024]
    assert p1.token_tile(n, 256, 1) == 4096
    assert p1.token_tile(1000, 128, 1, 512) == 8      # halves until it divides
    assert p1.token_tile(1000, 128, 1, 1000) == 1000  # ragged 64-token sub-tiles
    assert all(p1.token_tile(n, 128, g) == jp1._pick_tile(n, max(8192 // g, 512))
               for g in p1.GROUPS)


@pytest.mark.parametrize("ln_scale", [0.5, 0.0])
def test_p1_checks_see_faults_at_main_inputs(ln_scale):
    """main()'s inputs (g, b 0.5 N(0, 1) away from 1, 0): the checks fail
    a pass without LN and a reduce over one of two token tiles.  Pass
    A's check, at TOL_CTX of max |ctx| with no floor, fails them even
    at g = 1, b = 0, where LN(x) of x ~ N(0, 1) is nearly x."""
    gen = torch.Generator().manual_seed(0)
    x, g, b, _, _, b_out, w_kv, w_eff = p1.inputs(2, 4096, 128, gen)
    g, b = 1.0 + ln_scale * (g - 1.0) / 0.5, ln_scale * b / 0.5
    if ln_scale:
        p1.check_sees_faults(x, g, b, w_kv, w_eff, b_out, 2048)
    else:
        want = p1.ctx_plain(x, g, b, w_kv)
        for wrong in (p1.ctx_plain(x, g, b, w_kv, "noln"),
                      p1.ctx_plain(x[:, :2048], g, b, w_kv)):
            assert _util.check_fails("pass A", wrong, want, p1.ctx_tol(want)) > 0


# ------------------------------------------------------------------ P2

jp2 = _import_script("probe_attention_writeback")
P2_SHAPE = (2, 1024, 128)
JAX_P2 = {"base-8192": lambda: jp2.make_base(512),
          "flat-8192": lambda: jp2.make_base(512, flat=True),
          "alias-8192": lambda: jp2.make_base(512, alias=True),
          "manual-8192": lambda: jp2.make_manual(512)}


@pytest.mark.parametrize("variant,dtype", [
    ("base-8192", jnp.float32), ("flat-8192", jnp.float32),
    ("alias-8192", jnp.float32), ("manual-8192", jnp.bfloat16)])
def test_p2_copies_match_jax_probe(variant, dtype):
    x = _f(np.random.default_rng(2), *P2_SHAPE)
    (jx,), (tx,) = _cast((x,), dtype, _TDT[dtype])
    keep = tx.clone()
    want = JAX_P2[variant]()(jx)
    got = p2.copy(tx, variant)
    # a copy: bit for bit, and in place for alias
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert (got is tx) == (variant == "alias-8192")
    assert torch.equal(tx, keep)


def test_p2_variants_and_cost():
    assert [v[0] for v in p2.VARIANTS] == [
        "base-8192", "base-4096", "base-2048", "base-1024", "flat-8192",
        "alias-8192", "manual-8192", "manual-4096", "manual-2048"]
    # B = 96 at 128^2 c128 in bf16: 402.7 MB each way, 0.240 ms at 3.35 TB/s
    c = p2.cost(96, 128 * 128, 128)
    assert c["bytes"] == 2 * 402653184 and c["flops"] == 0


# ------------------------------------------------------------------ P3

jp3 = _import_script("probe_convres_variants")
P3_SHAPE = (1, 32, 16, 64)     # B, H, W, cio: two tiles of 16 rows, one of 32
JAX_P3 = {"base": ("full", "im2col", "f32", 16),
          "rowmask": ("row", "im2col", "f32", 16),
          "nomask": ("none", "im2col", "f32", 16),
          "ninedot": ("row", "ninedot", "f32", 16),
          "bf16mish": ("row", "im2col", "bf16", 16),
          "tile2x": ("row", "im2col", "f32", 32),
          "kitchen": ("none", "ninedot", "bf16", 32)}


def _p3(variant, jdt, tdt, seed=3):
    rng = np.random.default_rng(seed)
    cio, cm = P3_SHAPE[-1], 32
    # biases +1 put mish(b1 ...) well away from zero at the unmasked rows
    ws = (_f(rng, 1, 1, cio, cm, scale=cio ** -0.5), 1.0 + _f(rng, cm, scale=0.1),
          _f(rng, 3, 3, cm, cm, scale=(9 * cm) ** -0.5), 1.0 + _f(rng, cm, scale=0.1),
          _f(rng, 3, 3, cm, cm, scale=(9 * cm) ** -0.5), _f(rng, cm, scale=0.1),
          _f(rng, 1, 1, cm, cio, scale=cm ** -0.5), _f(rng, cio, scale=0.1))
    x = _f(rng, *P3_SHAPE)
    (jx, *jws), (tx, *tws) = _cast((x, *ws), jdt, tdt)
    # the probe takes f32 weights and rounds them to x's dtype itself
    jws = [jnp.asarray(w) for w in ws]
    want = jp3.make_fwd(*JAX_P3[variant])(jx, *jws)
    got = p3.convres(tx, *[torch.from_numpy(w) for w in ws], variant=variant)
    return got, want


@pytest.mark.parametrize("variant", list(p3.VARIANTS))
def test_p3_variants_match_jax_probe_f32(variant):
    got, want = _p3(variant, jnp.float32, torch.float32)
    assert got.shape == P3_SHAPE
    # f32 both sides (bf16mish is mish in x's dtype: f32 here): sums over
    # 9 * 32 products in another order
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("variant", ["base", "bf16mish", "kitchen"])
def test_p3_variants_match_jax_probe_bf16(variant):
    got, want = _p3(variant, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # the same roundings with f32 mish (intermediates and y to bf16): an
    # ulp apart at most (seen 2.4e-4 of 6.5); with mish in bf16, XLA on
    # the CPU rounds its steps in other places than PyTorch's op-by-op
    # bf16 arithmetic: looser (seen 3.1e-2 of 6.5, 0.5%)
    _assert_close(got, want, 1e-2 if variant == "base" else 2e-2)


def test_p3_nomask_differs_only_at_the_border_rows():
    got, _ = _p3("nomask", jnp.float32, torch.float32)
    right, _ = _p3("rowmask", jnp.float32, torch.float32)
    diff = (got - right).abs().amax(dim=(0, 2, 3))
    assert float(diff[2:-2].max()) == 0.0
    assert float(diff[[0, -1]].min()) > 1e-3


def test_p3_checks_see_the_unmasked_border_at_main_inputs():
    x, ws = p3.inputs(1, 32, torch.Generator().manual_seed(0))
    p3.check_sees_faults(x, ws)


# ------------------------------------------------------------------ P4

jp4 = _import_script("probe_cmajor_conv")
P4_SHAPE = (2, 8, 16, 16)     # B, C, H, W


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_p4_matches_jax_probe(dtype):
    rng = np.random.default_rng(4)
    c = P4_SHAPE[1]
    x = _f(rng, *P4_SHAPE)
    w = _f(rng, 3, 3, c, c, scale=(9 * c) ** -0.5)
    wmat = np.ascontiguousarray(w.transpose(3, 0, 1, 2).reshape(c, 9 * c))
    (jx, jw), (tx, tw) = _cast((x, wmat), dtype, _TDT[dtype])
    want = jp4.cmajor_conv(jx, jw)
    got = p4.cmajor_conv(tx, tw)
    assert got.shape == P4_SHAPE and got.dtype == tx.dtype
    np.testing.assert_array_equal(p4.to_wmat(torch.from_numpy(w)).numpy(), wmat)
    # f32: sums in another order; bf16: then one rounding, an ulp apart
    _assert_close(got, want, 1e-5 if dtype == jnp.float32 else 1e-2)


def test_p4_checks_see_the_tap_shift_faults_at_main_inputs():
    """main()'s inputs, at a small size: the plain conv with wmat's kx taps
    mirrored, and the one that reads the band one row off, are each
    further than TOL from the plain conv, so main()'s check fails them."""
    x, _, wmat = p4.inputs(1, 32, torch.Generator().manual_seed(0))
    assert torch.equal(p4.mirrored_kx(p4.mirrored_kx(wmat)), wmat)
    want = p4.plain(x, wmat)
    tol = _util.scaled_tol(want, p4.TOL)
    for wrong in (p4.plain(x, p4.mirrored_kx(wmat)), p4.plain(p4.rows_off(x), wmat)):
        assert float((wrong.float() - want.float()).abs().max()) > tol
    p4.check_sees_faults(x, wmat)


def test_probe_costs_give_the_bounds_at_the_default_sizes():
    mb = lambda c: c["bytes"] / 1e6
    a = p1.cost(96, 128 * 128, 128)
    assert 402.6 < mb(a["pass_a"]["full"]) < 410 and 805 < mb(a["pass_b"]["full"]) < 810
    assert abs(a["pass_a"]["payload"]["flops"] / 1e9 - 154.6) < 0.1
    assert a["pass_a"]["dma"]["flops"] == a["pass_b"]["dma"]["flops"] == 0
    assert abs(mb(p3.cost(32, 256, 256)) - 536.9) < 0.2
    assert abs(p3.cost(32, 256, 256)["flops"] / 1e9 - 94.5) < 3
    c4 = p4.cost(32, 256, 256)
    assert abs(mb(c4) - 268.4) < 0.1 and abs(c4["flops"] / 1e9 - 38.7) < 0.1


@pytest.mark.parametrize("main", [p1.main, p2.main, p3.main, p4.main])
def test_probe_mains_raise_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        main([])
