"""The port's int8 (W8A8) serving mode against the JAX package's
(dddpm_tpu/ops/quant.py, quantize.py, models/blocks.py:Conv3x3Params) on
the same numpy inputs, on the CPU, where ops/quant.py runs its plain
version.

The single conv and its quantizers must agree EXACTLY: both compute the
same integers and round the same way; so must every quantized conv of a
UNet given the input JAX's conv got.  The whole quantized UNet agrees
only to 5e-2 in relative L2: a float op before a quantized conv
rounds differently in the two frameworks, an activation that lands
within that difference of a .5 boundary quantizes one step apart (a
flip), and the flips cascade (test_quantized_unet_matches_jax)."""
import numpy as np
import ctypes

import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu.models.blocks import Block as JaxBlock
from dddpm_tpu.models.blocks import Conv3x3Params
from dddpm_tpu.models.factory import build_model as jax_build_model
from dddpm_tpu.models.unet import Unet as JaxUnet
from dddpm_tpu.ops import quant as jq
from dddpm_tpu.quantize import maybe_calibrate as jax_maybe_calibrate
from dddpm_tpu_torch import quantize
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.models.blocks import Block, Conv2d, quant_buffers, quant_mode
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.models.unet import Unet
from dddpm_tpu_torch.ops import quant as tq
from dddpm_tpu_torch.train.trainer import setup_trainer

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(a, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy (or jax) -> NCHW torch, channels_last, in `dtype`."""
    t = torch.from_numpy(np.array(np.asarray(a, np.float32)))
    return t.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------------ gate

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kk", [1, 2, 3])
def test_gate_is_jax_gate(kk, stride):
    for spatial in (8, 16, 64, 128):
        for cin in (8, 64, 128, 192, 256):
            for cout in (8, 64, 128, 192, 256):
                assert (tq.quant_conv_wins(kk, spatial, cin, cout, stride)
                        == jq.quant_conv_wins(kk, spatial, cin, cout, stride))


# ------------------------------------------------------------ quantizers

def test_quantize_weight_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 64, 48)).astype(np.float32) * 0.05
    w[..., 3] = 0.0                      # an all-zero channel: the 1e-12 floor
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    twq, tws = tq.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    assert twq.dtype == torch.int8 and tws.dtype == torch.float32
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(ws))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_act_and_observed_amax_equal_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 6, 6, 32)) * 3.0, jnp.float32).astype(jdt)
    # values on the .5 boundaries: round half to even in both
    x = x.at[0, 0, 0, :8].set(jnp.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                           126.5, -300.0], jdt))
    xt = _nchw(x.astype(jnp.float32), tdt)
    for amax in (0.0, 1.0, 127.0, 4.0):
        xs = jq.act_scale_from_amax(jnp.float32(amax))
        txs = tq.act_scale_from_amax(torch.tensor(amax))
        assert float(txs) == float(xs)
        np.testing.assert_array_equal(
            tq.quantize_act(xt, txs).permute(0, 2, 3, 1).numpy(),
            np.asarray(jq.quantize_act(x, xs)))
    prev = jnp.float32(2.0)
    np.testing.assert_array_equal(
        float(tq.observed_amax(xt, torch.tensor(2.0))),
        float(jq.observed_amax(x, prev)))


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_conv_plain_equals_jax_exactly(dtype, skip, layout):
    """The plain version equals JAX's int8_conv whatever the operands'
    memory format, and returns NCHW-contiguous, as Q1 does."""
    jdt, tdt = DTYPES[dtype]
    fmt = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}[layout]
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 8, 8, 128)) * 2.0, jnp.float32).astype(jdt)
    s = jnp.asarray(rng.normal(size=(2, 8, 8, 128)) * 5.0, jnp.float32).astype(jdt)
    w = rng.normal(size=(3, 3, 256, 128)).astype(np.float32) * 0.05
    # amax below the inputs' largest magnitude: some values saturate
    ax = jnp.max(jnp.abs(x.astype(jnp.float32))) * 0.7
    a_s = jnp.max(jnp.abs(s.astype(jnp.float32))) * 0.9
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    xt = _nchw(x, tdt).contiguous(memory_format=fmt)
    if skip:
        want = (jq.int8_conv(x, w[:, :, :128], ax)
                + jq.int8_conv(s, w[:, :, 128:], a_s)).astype(jdt)
        got = tq.int8_conv(xt, wt[:, :128], torch.tensor(float(ax)),
                           _nchw(s, tdt).contiguous(memory_format=fmt),
                           wt[:, 128:], torch.tensor(float(a_s)))
    else:
        want = jq.int8_conv(x, w[:, :, :128], ax).astype(jdt)
        got = tq.int8_conv(xt, wt[:, :128], torch.tensor(float(ax)))
    assert got.dtype == tdt and got.shape == (2, 128, 8, 8)
    assert got.is_contiguous()
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want.astype(jnp.float32)))


def test_packed_weights_are_the_kernels_layout():
    """pack_weight: packed[tap, slab, ng, kc, row, byte] is w[n, c, dy,
    dx] with n = 8 ng + row, c = 32 slab + 16 kc + byte, tap = 3 dy + dx;
    the rows past Cout (up to a multiple of 128) are zero."""
    rng = np.random.default_rng(7)
    wq = torch.from_numpy(rng.integers(-127, 128, (192, 64, 3, 3)).astype(np.int8))
    packed = tq.pack_weight(wq)
    assert packed.shape == (9, 2, 32, 2, 8, 16) and packed.dtype == torch.int8
    p = packed.numpy()
    w = wq.numpy()
    for tap, slab, ng, kc, row, byte in [(0, 0, 0, 0, 0, 0), (4, 1, 3, 1, 5, 9),
                                         (8, 1, 23, 1, 7, 15), (5, 0, 17, 0, 2, 11)]:
        assert p[tap, slab, ng, kc, row, byte] == w[8 * ng + row, 32 * slab + 16 * kc + byte,
                                                    tap // 3, tap % 3]
    full = p.transpose(0, 2, 4, 1, 3, 5).reshape(3, 3, 256, 64)
    np.testing.assert_array_equal(full[:, :, :192], w.transpose(2, 3, 0, 1))
    assert not full[:, :, 192:].any()
    # every width packs: Cin 48 to K 64 with zero columns past 48
    ragged = tq.prepare_weight(torch.randn(64, 48, 3, 3)).packed
    assert ragged.shape == (9, 2, 16, 2, 8, 16)
    assert not ragged.numpy()[:, 1, :, 1].any()


@pytest.mark.parametrize("cout,cin", [(144, 144), (160, 160), (130, 130),
                                      (256, 100)])
def test_prepare_weight_packs_every_width(cout, cin):
    """prepare_weight packs any Cin and Cout (Q1 takes every width JAX's
    gate quantizes): K padded to a multiple of 32, Cout to one of 128,
    with zeros, and the rest the quantized weights."""
    qw = tq.prepare_weight(torch.randn(cout, cin, 3, 3,
                                       generator=torch.Generator().manual_seed(cin)))
    kpad, npad = -(-cin // 32) * 32, -(-cout // 128) * 128
    assert qw.packed.shape == (9, kpad // 32, npad // 8, 2, 8, 16)
    full = qw.packed.numpy().transpose(0, 2, 4, 1, 3, 5).reshape(3, 3, npad, kpad)
    np.testing.assert_array_equal(full[:, :, :cout, :cin],
                                  qw.wq.numpy().transpose(2, 3, 0, 1))
    assert not full[:, :, cout:].any() and not full[:, :, :, cin:].any()


def _quantize8_rule(v: np.ndarray, xs: np.float32):
    """csrc/mma_s8_sm90.cuh:quantize8_s8's decision in numpy float32 (each
    op correctly rounded, as the CUDA intrinsics): the integers from p =
    v * (1 / xs), and whether p lies within 1e-4 of a .5 tie."""
    m = np.float32(12582912.0)
    inv = np.float32(1.0) / xs
    p = v * inv
    f = p - ((p + m) - m)
    tie = np.abs(np.abs(f) - np.float32(0.5)) < np.float32(1e-4)
    return np.clip(np.rint(p), -127, 127), tie


def test_quantize8_rule_equals_the_division_away_from_ties():
    """Where Q1's 8-wide quantize takes v * (1 / xs), its integer equals
    round(v / xs) (IEEE float32 division, half to even, clamped) for
    every value; the values whose reciprocal product rounds otherwise
    (next to .5 ties) are all flagged for the division."""
    rng = np.random.default_rng(11)
    with np.errstate(over="ignore", invalid="ignore"):
        for amax in (1e-9, 0.37, 3.0, 17.5, 250.0, 6e4):
            xs = np.float32(max(amax, 1e-12)) / np.float32(127.0)
            v = (rng.standard_normal(400_000) * amax * 0.7).astype(np.float32)
            # values at and beside every tie of the scale, and past the clamp
            ties = ((np.arange(-130, 130) + np.float32(0.5)) * xs).astype(np.float32)
            near = np.concatenate([np.nextafter(ties, np.float32(np.inf)),
                                   np.nextafter(ties, np.float32(-np.inf)), ties])
            v = np.concatenate([v, near, (v[:1000] * 300).astype(np.float32)])
            want = np.clip(np.rint(v / xs), -127, 127)
            got, tie = _quantize8_rule(v, xs)
            np.testing.assert_array_equal(got[~tie], want[~tie])
            assert tie.mean() < 0.05 and tie[-3 * len(ties) - 1000:-1000].any()


class _Recorder:
    """Stands in for Q1's library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def int8_conv(self, *args):
        self.calls.append(args)
        return 0


# (x's layout, the skip's layout or None)
_KERNEL_LAYOUTS = [("nchw", None), ("cl", None), ("nchw", "nchw"),
                   ("cl", "cl"), ("nchw", "cl"), ("cl", "nchw")]
_FMT = {"nchw": torch.contiguous_format, "cl": torch.channels_last}


@pytest.mark.parametrize("x_layout,skip_layout", _KERNEL_LAYOUTS)
def test_kernel_passes_each_operand_in_place(monkeypatch, x_layout, skip_layout):
    """Q1's wrapper, with the library and the stream replaced by a
    recorder, on CPU tensors: each operand's own data_ptr and its layout
    code (1 NCHW, 0 channels_last) reach the C entry, with no copy; y is
    (B, Cout, H, W) NCHW-contiguous in x's dtype."""
    rec = _Recorder()
    monkeypatch.setattr(tq, "_lib", lambda: rec)
    monkeypatch.setattr(tq._build, "stream", lambda t: ctypes.c_void_p(None))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 5, 8, generator=gen).to(torch.bfloat16).contiguous(
        memory_format=_FMT[x_layout])
    qw = tq.prepare_weight(torch.randn(128, 64, 3, 3, generator=gen))
    kw = {}
    if skip_layout:
        kw = dict(skip=torch.randn(2, 64, 5, 8, generator=gen).to(torch.bfloat16)
                  .contiguous(memory_format=_FMT[skip_layout]),
                  qw_skip=tq.prepare_weight(torch.randn(128, 64, 3, 3, generator=gen)),
                  amax_skip=torch.tensor(2.0))
    before = tq.LAUNCHES["int8_conv"]
    y = tq._kernel(x, qw, torch.tensor(3.0), kw.get("skip"), kw.get("qw_skip"),
                   kw.get("amax_skip"), None)
    assert tq.LAUNCHES["int8_conv"] == before + 1
    (args,) = rec.calls
    assert args[0].value == x.data_ptr() and args[1].value == qw.packed.data_ptr()
    assert args[16] == (1 if x_layout == "nchw" else 0)
    if skip_layout:
        assert args[4].value == kw["skip"].data_ptr()
        assert args[5].value == kw["qw_skip"].packed.data_ptr()
        assert args[17] == (1 if skip_layout == "nchw" else 0)
    else:
        assert args[4].value is None
    assert args[9].value == y.data_ptr()
    assert args[10:16] == (2, 5, 8, 64, 128, 1)
    assert y.shape == (2, 128, 5, 8) and y.dtype == torch.bfloat16
    assert y.is_contiguous()


def test_kernel_copies_only_an_operand_it_cannot_read(monkeypatch):
    """An NCHW operand whose rows are not a multiple of 4 values, or a
    view that is not 16-byte aligned, reaches Q1 as a channels_last copy
    (layout code 0); the other operand still goes in place."""
    rec = _Recorder()
    monkeypatch.setattr(tq, "_lib", lambda: rec)
    monkeypatch.setattr(tq._build, "stream", lambda t: ctypes.c_void_p(None))
    qw = tq.prepare_weight(torch.randn(64, 64, 3, 3))
    odd = torch.randn(1, 64, 6, 7)                       # NCHW, W = 7
    whole = torch.randn(2, 64, 6, 8).contiguous(memory_format=torch.channels_last)
    view = whole[1:]                                     # 12 KB in: aligned
    shifted = torch.randn(64 * 6 * 8 + 2)[2:].reshape(1, 6, 8, 64).permute(0, 3, 1, 2)
    assert view.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 8
    tq._kernel(odd, qw, torch.tensor(1.0), None, None, None, None)
    tq._kernel(view, qw, torch.tensor(1.0), torch.randn(1, 64, 6, 8), qw,
               torch.tensor(1.0), None)
    tq._kernel(shifted, qw, torch.tensor(1.0), None, None, None, None)
    (a1,), (a2,), (a3,) = [[c] for c in rec.calls]
    assert a1[0].value != odd.data_ptr() and a1[16] == 0
    assert a2[0].value == view.data_ptr() and a2[16] == 0 and a2[17] == 1
    assert a3[0].value != shifted.data_ptr() and a3[0].value % 16 == 0 and a3[16] == 0


# (C, x's layout): 144 and 160, the widths of an int8 unet_chan 144 / 160
# model, both layouts in place; 130 in bf16 (260-byte pixels): NCHW in
# place, channels_last copied with its channels padded to 136
@pytest.mark.parametrize("c,x_layout", [(144, "nchw"), (144, "cl"), (160, "nchw"),
                                        (160, "cl"), (130, "nchw"), (130, "cl")])
def test_kernel_takes_ragged_widths(monkeypatch, c, x_layout):
    """Q1's wrapper (recorder for the library) at channel counts that are
    not multiples of 32: the packed weights of K rounded up to 32, the
    operands in place where the TMA reads them, and the C entry given
    the operands' channel count."""
    rec = _Recorder()
    monkeypatch.setattr(tq, "_lib", lambda: rec)
    monkeypatch.setattr(tq._build, "stream", lambda t: ctypes.c_void_p(None))
    gen = torch.Generator().manual_seed(c)
    mk = lambda: torch.randn(2, c, 6, 8, generator=gen).to(torch.bfloat16).contiguous(
        memory_format=_FMT[x_layout])
    x, skip = mk(), mk()
    qw = tq.prepare_weight(torch.randn(c, c, 3, 3, generator=gen))
    y = tq._kernel(x, qw, torch.tensor(3.0), skip, qw, torch.tensor(2.0), None)
    (args,) = rec.calls
    assert args[1].value == qw.packed.data_ptr()
    assert qw.packed.shape[1] == -(-c // 32)
    copied = c == 130 and x_layout == "cl"
    assert (args[0].value == x.data_ptr()) != copied
    assert (args[4].value == skip.data_ptr()) != copied
    assert args[16] == args[17] == (1 if x_layout == "nchw" else 0)
    assert args[10:15] == (2, 6, 8, 136 if copied else c, c)
    assert y.shape == (2, c, 6, 8) and y.is_contiguous()


@pytest.mark.parametrize("which", ["x", "skip"])
def test_kernel_refuses_a_layout_it_does_not_take(monkeypatch, which):
    """An operand that is neither NCHW-contiguous nor channels_last (a
    strided view) raises before any launch."""
    rec = _Recorder()
    monkeypatch.setattr(tq, "_lib", lambda: rec)
    monkeypatch.setattr(tq._build, "stream", lambda t: ctypes.c_void_p(None))
    good = torch.randn(1, 64, 6, 6)
    view = torch.randn(1, 64, 6, 12)[..., ::2]
    qw = tq.prepare_weight(torch.randn(64, 64, 3, 3))
    x, skip = (view, good) if which == "x" else (good, view)
    with pytest.raises(ValueError, match="NCHW-contiguous or channels_last"):
        tq._kernel(x, qw, torch.tensor(1.0), skip, qw, torch.tensor(1.0), None)
    assert rec.calls == []


def test_int8_conv_has_no_gradient():
    x = torch.randn(1, 128, 4, 4, requires_grad=True)
    y = tq.int8_conv(x, torch.randn(128, 128, 3, 3), torch.tensor(3.0))
    with pytest.raises(RuntimeError, match="no gradient"):
        y.sum().backward()


# --------------------------------------------------------------- modules

@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantized_conv_module_equals_jax(dtype, skip):
    """Conv3x3Params(quant='int8') calibrated on one input and served on
    another, against Conv2d(quant='int8') on its weights and amax: equal."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    mk = lambda scale: jnp.asarray(rng.normal(size=(2, 8, 8, 128)) * scale,
                                   jnp.float32)
    x_cal, x = mk(1.0), mk(1.5)
    s_cal, s = (mk(4.0), mk(5.0)) if skip else (None, None)
    cin = 256 if skip else 128
    mod = Conv3x3Params(features=128, in_features=cin, dtype=jdt, quant="int8")
    vs = mod.init(jax.random.PRNGKey(0), x_cal, s_cal)
    _, upd = mod.apply(vs, x_cal.astype(jdt),
                       None if s_cal is None else s_cal.astype(jdt),
                       mutable=["quant"])
    vs = {"params": vs["params"], "quant": upd["quant"]}
    want = mod.apply(vs, x.astype(jdt), None if s is None else s.astype(jdt))

    conv = Conv2d(cin, 128, 3, compute_dtype=tdt, quant="int8",
                  split=128 if skip else None)
    conv.weight.data.copy_(torch.from_numpy(
        np.asarray(vs["params"]["kernel"]).transpose(3, 2, 0, 1)))
    conv.bias.data.copy_(torch.from_numpy(np.asarray(vs["params"]["bias"])))
    assert conv.quant_sites == (["amax_x", "amax_skip"] if skip else ["amax_x"])
    for name in conv.quant_sites:
        getattr(conv, name).fill_(float(upd["quant"][name]))
    with torch.no_grad():
        got = conv(_nchw(x.astype(jdt), tdt),
                   None if s is None else _nchw(s.astype(jdt), tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want.astype(jnp.float32)))


def test_quantized_block_matches_jax():
    """Block(quant='int8') (conv, GroupNorm, mish) in f32 on converted
    weights and amax: the conv is exact, GroupNorm's f32 sums differ."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(2, 8, 8, 128)), jnp.float32)
    jblock = JaxBlock(128, 128, quant="int8")
    vs = jblock.init(jax.random.PRNGKey(1), x)
    _, upd = jblock.apply(vs, x, mutable=["quant"])
    vs = {"params": vs["params"], "quant": upd["quant"]}
    want = np.asarray(jblock.apply(vs, x * 1.2))
    block = Block(128, 128, quant="int8")
    block.load_state_dict(jax_to_state_dict(_np_tree(vs), block))
    assert float(block.conv.amax_x) > 0
    with torch.no_grad():
        got = _nhwc(block(_nchw(x * 1.2)))
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol


def _port_name(path) -> str:
    """The port's module name of a JAX Conv3x3Params scope path."""
    *blocks, conv = path
    assert conv == "Conv_0", path
    if len(blocks) == 1:                          # the final Block
        return "final_block.conv"
    rb, blk = blocks
    return f"resnets.{rb.split('_')[1]}.block{blk.split('_')[1]}.conv"


def test_quantized_unet_matches_jax():
    """A unet_chan 128 UNet, dims (1, 2, 2) at 16^2 in f32, calibrated in
    JAX on two inputs and served on a third, against the port on JAX's
    weights and "quant" collection.  23 operands are quantized: the 16^2,
    8^2 and 4^2 stride-1 convs that keep 128 or 256 channels, both halves
    of the 4^2 skip seam among them.

    Each quantized conv, given the input JAX's conv got, gives JAX's
    output exactly.  The whole UNet agrees to 5e-2 in relative L2 and to
    1e-1 of the largest output at any element (measured 2.9e-2 and
    4.0e-2): the first flip (a float input ~1e-7 apart that quantizes one
    step apart) moves nine pixels by ~1e-3; GroupNorm spreads that to
    every pixel, where it flips more values at the next quantized conv,
    and so on, until the two quantized nets differ by about the
    quantization noise itself (~3-4% of the largest output).  The test
    prints the share of flipped values at each quantized conv."""
    from flax import linen as fnn

    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, 16, 16, 8)).astype(np.float32) for _ in range(3)]
    ts = [np.array([3, 17], np.int32), np.array([9, 0], np.int32),
          np.array([12, 5], np.int32)]
    jnet = JaxUnet(dim=128, in_channels=8, dim_mults=(1, 2, 2), quant_conv="int8")
    vs = jnet.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), jnp.asarray(ts[0]))
    quant = vs["quant"]
    for x, t in zip(xs[:2], ts[:2]):
        _, upd = jnet.apply({"params": vs["params"], "quant": quant},
                            jnp.asarray(x), jnp.asarray(t), mutable=["quant"])
        quant = upd["quant"]
    vs = {"params": vs["params"], "quant": quant}
    calls = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, Conv3x3Params)
                and context.method_name == "__call__"):
            calls.append((context.module.scope.path, args, out))
        return out

    with fnn.intercept_methods(record):
        want = np.asarray(jnet.apply(vs, jnp.asarray(xs[2]), jnp.asarray(ts[2])))

    net = Unet(128, 8, (1, 2, 2), use_pallas=False, quant_conv="int8").eval()
    net.load_state_dict(jax_to_state_dict(_np_tree(vs), net))
    bufs = quant_buffers(net)
    assert len(bufs) == len(jax.tree.leaves(quant)) == 23
    assert all(float(b) > 0 for b in bufs.values())
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, a, o, name=name: seen.__setitem__(name, a))
        for name, m in net.named_modules() if isinstance(m, Conv2d) and m.quant_sites]
    with torch.no_grad():
        got = _nhwc(net(_nchw(xs[2]), torch.from_numpy(ts[2]).long()))
    for h in hooks:
        h.remove()

    exact, flips = 0, []
    for path, args, out in calls:
        name = _port_name(path)
        conv = net.get_submodule(name)
        if not conv.quant_sites:
            continue
        ops = [a for a in args if a is not None]
        with torch.no_grad():
            y = conv(*(_nchw(a) for a in ops))
        np.testing.assert_array_equal(_nhwc(y), np.asarray(out), err_msg=name)
        exact += len(ops)
        for a, mine, site in zip(ops, seen[name], conv.quant_sites):
            xs_ = tq.act_scale_from_amax(getattr(conv, site))
            flips.append(float((tq.quantize_act(mine, xs_)
                                != tq.quantize_act(_nchw(a), xs_)).float().mean()))
    assert exact == 23
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"quantized UNet: max_abs_err {err.max():.3e} (tol {1e-1 * scale:.3e}), "
          f"relative L2 {rel:.3e} (tol 5e-2); "
          f"share of flipped s8 values at the 23 quantized operands, in order: "
          + " ".join(f"{f:.1e}" for f in flips))
    assert flips[0] < 1e-3
    assert rel <= 5e-2 and err.max() <= 1e-1 * scale
    # the same weights with the int8 mode off are the float UNet
    ref = Unet(128, 8, (1, 2, 2), use_pallas=False).eval()
    ref.load_state_dict({k: v for k, v in net.state_dict().items()
                         if k not in bufs})
    with torch.no_grad(), quant_mode(net, "off"):
        x2, t2 = _nchw(xs[2]), torch.from_numpy(ts[2]).long()
        assert torch.equal(net(x2, t2), ref(x2, t2))


# ------------------------------------------------------------ calibration

CFG = {
    "model": "dddpm", "dataset": "celeba_hq", "image_size": 16,
    "batch_size": 4, "T": 20, "loss_type": "simple",
    "beta_schedule": "cosine", "loss_flat": "sum",
    "unet_chan": 128, "unet_dims": (1, 2), "unet_dropout": 0.0,
    "unet_in": 8, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 16, "d_n_blocks": 1,
    "u_n_blocks": 1, "ae_loss": True, "t_rec_max": 5,
    "force_latent": True, "compute_dtype": "float32",
    "conv_quant": "int8", "use_pallas_attention": False,
}


@pytest.fixture(scope="module")
def models():
    jnet, _, init_fn, _ = jax_build_model(dict(CFG))
    variables = init_fn(jax.random.PRNGKey(0))
    net, process, _, _ = build_model(dict(CFG), device="cpu")
    net.load_state_dict(jax_to_state_dict(_np_tree(variables), net))
    return jnet, variables, net, process


def test_calibration_observes_jax_amax(models):
    """The same (x_t, t) snapshots through JAX's mutable=["quant"] apply
    and the port's calibration mode.  The first level's three quantized
    convs, whose inputs no quantized conv has touched, observe JAX's amax
    to rtol 1e-5; every later one sees activations after the flips of
    the quantized convs before it (test_quantized_unet_matches_jax) and
    observes it to rtol 3e-2 (measured up to 1.6e-2)."""
    jnet, variables, net, process = models
    rng = np.random.default_rng(6)
    snaps = [(rng.standard_normal((2, 8, 8, 8)).astype(np.float32) * s, t)
             for s, t in ((1.0, 19), (0.7, 10), (1.3, 0))]
    quant = variables["quant"]
    for x, t in snaps:
        _, upd = jnet.apply({"params": variables["params"], "quant": quant},
                            jnp.asarray(x), jnp.full((2,), t, jnp.int32),
                            mutable=["quant"], method=type(jnet).eps)
        quant = upd["quant"]
    want = jax_to_state_dict({"params": _np_tree(variables["params"]),
                              "quant": _np_tree(quant)}, net)
    bufs = quant_buffers(net)
    for b in bufs.values():
        b.zero_()
    quantize.observe(net, process, [(torch.from_numpy(x), t) for x, t in snaps])
    assert len(bufs) == 14
    first_level = ("unet.resnets.0.", "unet.resnets.1.")
    for key, b in bufs.items():
        rtol = 1e-5 if key.startswith(first_level) else 3e-2
        np.testing.assert_allclose(float(b), float(want[key]), rtol=rtol,
                                   err_msg=key)
    assert sum(k.startswith(first_level) for k in bufs) == 3


@pytest.mark.parametrize("mode", ["noise", "trajectory"])
def test_calibrate_fills_every_amax(models, mode):
    _, _, net, process = models
    bufs = quant_buffers(net)
    for b in bufs.values():
        b.zero_()
    quantize.calibrate_conv_quant(CFG, net, process, batch_size=2,
                                  n_points=4, mode=mode, seed=3)
    assert all(float(b) > 0 for b in bufs.values())
    first = {k: float(b) for k, b in bufs.items()}
    for b in bufs.values():
        b.zero_()
    quantize.calibrate_conv_quant(CFG, net, process, batch_size=2,
                                  n_points=4, mode=mode, seed=3)
    assert {k: float(b) for k, b in bufs.items()} == first


def test_maybe_calibrate_recalibrates_a_partly_zero_set(models):
    """The port calibrates unless EVERY amax is > 0; JAX's any-rule keeps
    a partly zero collection as it is (ROADMAP section 3)."""
    jnet, variables, net, process = models
    bufs = quant_buffers(net)
    for i, b in enumerate(bufs.values()):
        b.fill_(0.0 if i % 2 else 1.0)
    quantize.maybe_calibrate(CFG, net, process, batch_size=2, mode="noise")
    assert all(float(b) > 0 for b in bufs.values())
    kept = {k: float(b) for k, b in bufs.items()}
    quantize.maybe_calibrate(CFG, net, process, batch_size=2, mode="noise",
                             seed=9)
    assert {k: float(b) for k, b in bufs.items()} == kept
    # the JAX package leaves the zeros
    leaves, tree = jax.tree.flatten(variables["quant"])
    partial = jax.tree.unflatten(tree, [jnp.float32(0.0 if i % 2 else 1.0)
                                        for i in range(len(leaves))])
    out = jax_maybe_calibrate(dict(CFG), jnet, None,
                              {"params": variables["params"], "quant": partial},
                              jax.random.PRNGKey(0))
    assert sum(float(v) == 0.0 for v in jax.tree.leaves(out["quant"])) > 0


def test_weights_are_quantized_once_until_they_change(models):
    _, _, net, _ = models
    conv = next(m for m in net.modules() if isinstance(m, Conv2d) and m.quant_sites)
    first = conv._quant_weights()
    assert conv._quant_weights() is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    again = conv._quant_weights()
    assert again is not first
    torch.testing.assert_close(again[0].ws, first[0].ws * 2.0)


def test_conv_quant_config_is_checked():
    with pytest.raises(ValueError, match="conv_quant"):
        Unet.from_config({"unet_chan": 8, "unet_in": 3, "unet_dims": (1, 2),
                          "unet_dropout": 0.0, "use_pallas_attention": False,
                          "conv_quant": "int4"})


def test_setup_trainer_refuses_conv_quant():
    cfg = dict(CFG, dataset="synthetic", n_steps=1, lr=1e-3, val_split=0)
    with pytest.raises(ValueError, match="sampling/serving-only"):
        setup_trainer(cfg, mute=True, device="cpu")
