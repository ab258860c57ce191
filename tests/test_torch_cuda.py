"""Card-only tests: each CUDA kernel of the port against its plain
PyTorch version on the card.  They skip where no CUDA card is present;
on the card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX, which the card's machine
need not have.)
"""
import re

import numpy as np
import pytest
import torch

from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.ops import _build
from dddpm_tpu_torch.ops import attention_block as ab
from dddpm_tpu_torch.ops import conv3x3 as c3
from dddpm_tpu_torch.ops import convres as cr
from dddpm_tpu_torch.ops import linear_attention as la
from dddpm_tpu_torch.ops import quant as qt
from dddpm_tpu_torch.ops import winograd as wg
from dddpm_tpu_torch.probes import _util as pu
from dddpm_tpu_torch.probes import attention_ceiling as p1
from dddpm_tpu_torch.probes import attention_writeback as p2
from dddpm_tpu_torch.probes import cmajor_conv as p4
from dddpm_tpu_torch.probes import convres_variants as p3

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(want, dtype):
    # bf16: stages rounded in other places (one bf16 ulp each, 0.4-0.8%);
    # f32: sums in other orders
    return (3e-2 if dtype == torch.bfloat16 else 1e-3) * max(
        1.0, float(want.float().abs().max()))


def _close(got, want, dtype):
    tol = _tol(want, dtype)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


# C = 20 (no 16-byte rows), 40 (K and N padded), 320, 512 and 1024 (the
# weights streamed in K-slabs, pass B in column slabs)
ATTN_WIDTHS = [(2, 1000, 32), (3, 4096, 128), (1, 1024, 256), (2, 777, 64),
               (2, 1000, 96), (1, 1024, 160), (1, 777, 192), (2, 600, 224),
               (2, 1000, 20), (2, 777, 40), (1, 1024, 320), (2, 600, 512),
               (1, 777, 1024)]


def _attn_args(card, bsz, n, c, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    x = r(bsz, n, c).to(dtype)
    # g, b far from 1, 0: LN moves both passes' outputs
    g, b, b_out = 1.0 + 0.5 * r(c), 0.5 * r(c), 0.1 * r(c)
    w_qkv = (r(c, 384) / c ** 0.5).to(dtype)
    w_out = (r(128, c) / 128 ** 0.5).to(dtype)
    w_q, w_k, w_v = (w_qkv.reshape(c, 3, 128)[:, i].contiguous() for i in range(3))
    w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
    return x, g, b, b_out, w_qkv, w_out, w_q, w_kv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,n,c", ATTN_WIDTHS)
def test_attention_kernels_match_plain(card, dtype, bsz, n, c):
    x, g, b, b_out, w_qkv, w_out, w_q, w_kv = _attn_args(card, bsz, n, c, dtype,
                                                         n + c)
    ctx = ab.attention_ctx(x, g, b, w_kv)
    _close(ctx, ab.ctx_reference(x, g, b, w_kv), dtype)
    w_eff = ab.fold_w_eff(w_q, ctx, w_out, dtype)
    want = ab.out_reference(x, g, b, w_eff, b_out)
    _close(ab.attention_out(x, g, b, w_eff, b_out), want, dtype)
    y = x.clone()
    assert ab.attention_out(y, g, b, w_eff, b_out, out=y).data_ptr() == y.data_ptr()
    _close(y, want, dtype)
    with torch.no_grad():
        block = ab.attention_block(x, g, b, w_qkv, w_out, b_out)
    _close(block, ab.reference_impl(x, g, b, w_qkv, w_out, b_out), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_check_fails_transposed_ctx(card, dtype):
    """The check above sees a wrong pass A: the kernel's ctx with each
    head's block transposed (A^T / s instead of A / s) misses the plain
    version by far more than the tolerance, the kernel's own does not."""
    x, g, b, _, _, _, _, w_kv = _attn_args(card, 2, 1024, 128, dtype, 5)
    ctx = ab.attention_ctx(x, g, b, w_kv)
    want = ab.ctx_reference(x, g, b, w_kv)
    _close(ctx, want, dtype)
    heads = ctx.reshape(2, 4, 32, 4, 32)
    wrong = torch.zeros_like(heads)
    for h in range(4):
        wrong[:, h, :, h] = heads[:, h, :, h].transpose(-1, -2)
    err = float((wrong.reshape(ctx.shape) - want).abs().max())
    assert err > 5 * _tol(want, dtype), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 512])
def test_attention_ctx_is_deterministic(card, dtype, c):
    """Pass A twice on the same input gives the same bits: per-chunk
    partials summed in chunk order, no atomics."""
    x, g, b, _, _, _, _, w_kv = _attn_args(card, 8, 4096, c, dtype, 6)
    assert torch.equal(ab.attention_ctx(x, g, b, w_kv),
                       ab.attention_ctx(x, g, b, w_kv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [None, "up", "down"])
# (1, 40, 36, 32), (2, 22, 50, 64): W (and H) not multiples of the bf16
# tile (8 x 16 px); (2, 26, 40, 128): cio 128's 4 x 16 tile, H and W not
# multiples of it; (6, 256, 256, 64): 3072 tiles, more than the
# persistent grid has blocks, so that each block walks several
@pytest.mark.parametrize("bsz,h,w,c", [(2, 32, 64, 64), (1, 40, 36, 32),
                                       (1, 16, 16, 128), (2, 22, 50, 64),
                                       (2, 26, 40, 128), (6, 256, 256, 64)])
def test_convres_kernel_matches_plain(card, dtype, scale, bsz, h, w, c):
    gen = torch.Generator(device=card).manual_seed(h * w + c)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    cm = cr.MID_CHANNELS
    args = (r(bsz, h, w, c).to(dtype),
            r(1, 1, c, cm) / c ** 0.5, 0.1 * r(cm) + 2.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm) + 2.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm),
            r(1, 1, cm, c) / cm ** 0.5, 0.1 * r(c))
    with torch.no_grad():
        for residual in (True, False):
            got = cr.fused_convres_block(*args, residual=residual, scale=scale)
            _close(got, cr.reference_impl(*args, residual=residual,
                                          scale=scale), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convres_check_fails_mirrored_taps(card, dtype):
    """The check above sees a wrong 3x3: K2 given w2 with its kx taps
    mirrored misses the plain version (on the true w2) by far more than
    the tolerance."""
    args, _ = _convres_args(card, 2, 32, 48, 64, dtype, 17)
    mirrored = (*args[:3], args[3].flip(1).contiguous(), *args[4:])
    with torch.no_grad():
        want = cr.reference_impl(*args, residual=False)
        got = cr.fused_convres_block(*mirrored, residual=False)
        _close(cr.fused_convres_block(*args, residual=False), want, dtype)
    assert float((got.float() - want.float()).abs().max()) > 5 * _tol(want, dtype)


def test_attention_kernel_gradients_match_plain(card):
    """The kernel forward's backward is autograd through reference_impl."""
    gen = torch.Generator(device=card).manual_seed(9)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    args = [r(2, 1024, 64), 1.0 + 0.1 * r(64), 0.1 * r(64),
            r(64, 384) / 8.0, r(128, 64) / 11.3, 0.1 * r(64)]
    grads = []
    for fn in (ab.attention_block, ab.reference_impl):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves).square().sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        _close(got, want, torch.float32)


def _convres_args(card, bsz, h, w, c, dtype, seed, cm=cr.MID_CHANNELS):
    gen = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    return (r(bsz, h, w, c).to(dtype),
            r(1, 1, c, cm) / c ** 0.5, 0.1 * r(cm) + 2.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm) + 2.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm),
            r(1, 1, cm, c) / cm ** 0.5, 0.1 * r(c)), gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,h,w,c", [(2, 32, 64, 64), (1, 40, 36, 32),
                                       (1, 16, 16, 128), (3, 8, 8, 64),
                                       (1, 24, 40, 64), (1, 10, 20, 128),
                                       (2, 9, 17, 64)])
def test_convres_backward_kernel_matches_plain(card, dtype, bsz, h, w, c):
    """K3 (dx and the eight dW/db) against backward_reference, with b1/b2
    shifted by +2 so that a halo slip shows; 40x36 leaves partial tiles,
    24x40 partial bf16 tiles (8 x 16 px) in both directions, 10x20 at
    cio 128 partial 4 x 16 tiles in both, and 9x17 over two samples
    partial tiles in both directions at each sample's edge (the weight
    sums' k-steps take whole tile rows, so a pixel outside the image
    must add 0)."""
    args, gen = _convres_args(card, bsz, h, w, c, dtype, h * w + c + 1)
    dy = torch.randn(bsz, h, w, c, generator=gen, device=card).to(dtype)
    for residual in (True, False):
        got = cr._bwd_kernel(*args, dy, residual)
        want = cr.backward_reference(*args, dy, residual)
        for g, t in zip(got, want):
            assert g.shape == t.shape
            _close(g, t, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convres_bwd_check_fails_mirrored_taps(card, dtype):
    """The check above sees a transposed 3x3 that forgets its mirror: K3
    given w3 with its taps mirrored (w3[8 - k] for w3[k]) misses the
    plain version on the true w3 by more than 5x the tolerance."""
    args, gen = _convres_args(card, 2, 32, 48, 64, dtype, 19)
    dy = torch.randn(2, 32, 48, 64, generator=gen, device=card).to(dtype)
    mirrored = (*args[:5], args[5].flip(0).flip(1).contiguous(), *args[6:])
    want = cr.backward_reference(*args, dy, True)
    for g, t in zip(cr._bwd_kernel(*args, dy, True), want):
        _close(g, t, dtype)
    got = cr._bwd_kernel(*mirrored, dy, True)
    miss = max(float((g.float() - t.float()).abs().max()) / _tol(t, dtype)
               for g, t in zip(got, want))
    assert miss > 5, miss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convres_bwd_is_deterministic(card, dtype):
    """Two launches on the same inputs give the same bits: dx and every
    weight and bias gradient (per-block partials summed in block order,
    no atomics), at a shape where each block walks several tiles."""
    args, gen = _convres_args(card, 3, 128, 128, 64, dtype, 23)
    dy = torch.randn(3, 128, 128, 64, generator=gen, device=card).to(dtype)
    first = cr._bwd_kernel(*args, dy, True)
    second = cr._bwd_kernel(*args, dy, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scale", [None, "up", "down"])
def test_convres_autograd_on_card_matches_plain(card, scale):
    """Under autograd a CUDA tensor launches K2 forward and K3 backward;
    the gradients equal autograd through the plain forward (f32)."""
    args, gen = _convres_args(card, 2, 32, 32, 64, torch.float32, 5)
    grads = []
    for use_kernel in (True, False):
        leaves = [a.clone().requires_grad_() for a in args]
        before = dict(cr.LAUNCHES)
        if use_kernel:
            out = cr.fused_convres_block(*leaves, residual=True, scale=scale)
        else:
            out = cr.reference_impl(*leaves, residual=True, scale=scale)
        out.square().sum().backward()
        if use_kernel:
            assert cr.LAUNCHES["convres_fwd"] == before["convres_fwd"] + 1
            assert cr.LAUNCHES["convres_bwd"] == before["convres_bwd"] + 1
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        _close(got, want, torch.float32)


# (cm, cio) of the width-general route (csrc/convres_general.cu): the
# ConvResNet blocks of d_chans 128, 192 and 256, cm 32 at a cio the
# tuned kernels do not take, and cm 96 with cio 160, whose every N (96,
# 160) ends in a half-full 64-channel tile
GENERAL_WIDTHS = [(64, 128), (96, 192), (128, 256), (32, 96), (96, 160)]
# (2, 24, 40): 1920 pixels, 15 whole 128-pixel bf16 tiles (30 of the f32
# route's 64); (1, 70, 66): 4620, the last tile partial (12 pixels) and
# rows that do not start tiles; (1, 38, 50): 1900, the last tile's 108
# pixels ending inside its second warp's third m16 tile, so that 'down'
# pools quads up to a partial m16 tile's last whole rows; at cio 96 and
# cm 96 the last 64-channel tile is half full
GENERAL_SHAPES = [(2, 24, 40), (1, 70, 66), (1, 38, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [None, "up", "down"])
@pytest.mark.parametrize("cm,c", GENERAL_WIDTHS)
@pytest.mark.parametrize("bsz,h,w", GENERAL_SHAPES)
def test_convres_general_matches_plain(card, dtype, scale, cm, c, bsz, h, w):
    """K2's width-general route against reference_impl, with and without
    the residual; its counter moves and the tuned kernel's does not."""
    args, _ = _convres_args(card, bsz, h, w, c, dtype, h * w + c + cm, cm)
    before = dict(cr.LAUNCHES)
    with torch.no_grad():
        for residual in (True, False):
            got = cr.fused_convres_block(*args, residual=residual, scale=scale)
            _close(got, cr.reference_impl(*args, residual=residual,
                                          scale=scale), dtype)
    torch.cuda.synchronize()
    assert cr.LAUNCHES["convres_fwd_general"] == before["convres_fwd_general"] + 2
    assert cr.LAUNCHES["convres_fwd"] == before["convres_fwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cm,c", GENERAL_WIDTHS)
@pytest.mark.parametrize("bsz,h,w", GENERAL_SHAPES)
def test_convres_general_backward_matches_plain(card, dtype, cm, c, bsz, h, w):
    """K3's width-general route (dx and the eight dW/db) against
    backward_reference, with b1/b2 shifted by +2 so that a padding slip
    shows at the border."""
    args, gen = _convres_args(card, bsz, h, w, c, dtype, h * w + c + cm + 1, cm)
    dy = torch.randn(bsz, h, w, c, generator=gen, device=card).to(dtype)
    before = dict(cr.LAUNCHES)
    for residual in (True, False):
        got = cr._bwd_kernel(*args, dy, residual)
        want = cr.backward_reference(*args, dy, residual)
        for g, t in zip(got, want):
            assert g.shape == t.shape and g.dtype == t.dtype
            _close(g, t, dtype)
    torch.cuda.synchronize()
    assert cr.LAUNCHES["convres_bwd_general"] == before["convres_bwd_general"] + 2
    assert cr.LAUNCHES["convres_bwd"] == before["convres_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convres_general_check_fails_mirrored_taps(card, dtype):
    """The checks above see a wrong 3x3 on the general route: forward
    with w2's kx taps mirrored, backward with w3's taps mirrored, each
    misses the plain version on the true weights by more than 5x the
    tolerance."""
    args, gen = _convres_args(card, 2, 24, 40, 128, dtype, 29, cm=64)
    dy = torch.randn(2, 24, 40, 128, generator=gen, device=card).to(dtype)
    fwd = (*args[:3], args[3].flip(1).contiguous(), *args[4:])
    with torch.no_grad():
        want = cr.reference_impl(*args, residual=False)
        got = cr.fused_convres_block(*fwd, residual=False)
    assert float((got.float() - want.float()).abs().max()) > 5 * _tol(want, dtype)
    bwd = (*args[:5], args[5].flip(0).flip(1).contiguous(), *args[6:])
    want = cr.backward_reference(*args, dy, True)
    miss = max(float((g.float() - t.float()).abs().max()) / _tol(t, dtype)
               for g, t in zip(cr._bwd_kernel(*bwd, dy, True), want))
    assert miss > 5, miss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convres_general_runs_a_large_batch_in_chunks(card, dtype):
    """Past 2^19 pixels the general route runs the batch in chunks of
    samples (9 x 256^2: 8 and 1), the backward summing the chunks'
    weight gradients: both against their plain versions ('down' forward,
    which pools in the last conv's epilogue)."""
    args, gen = _convres_args(card, 9, 256, 256, 128, dtype, 37, cm=64)
    with torch.no_grad():
        _close(cr.fused_convres_block(*args, residual=True, scale="down"),
               cr.reference_impl(*args, residual=True, scale="down"), dtype)
    dy = torch.randn(9, 256, 256, 128, generator=gen, device=card).to(dtype)
    for g, t in zip(cr._bwd_kernel(*args, dy, True),
                    cr.backward_reference(*args, dy, True)):
        _close(g, t, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convres_general_bwd_is_deterministic(card, dtype):
    """Two launches of the general backward at cm 128 give the same bits:
    the weight gradients' pixel chunks are summed in chunk order."""
    args, gen = _convres_args(card, 2, 64, 64, 256, dtype, 31, cm=128)
    dy = torch.randn(2, 64, 64, 256, generator=gen, device=card).to(dtype)
    first = cr._bwd_kernel(*args, dy, True)
    second = cr._bwd_kernel(*args, dy, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d_chans", [128, 192, 256])
def test_convresnet_runs_its_blocks_through_the_general_route(card, d_chans):
    """A ConvResNet of d_chans past 64 at 128^2 (the JAX gate's least
    map) sends each block through K2's general route, and under autograd
    through K3's: the plain path does not run instead.  f32 against the
    same module with its gate closed (use_pallas False: the plain path)."""
    from dddpm_tpu_torch.models.resample import ConvResNet

    torch.manual_seed(d_chans)
    net = ConvResNet(d_chans, 8, 3, 1, upsample=True, n_blocks=2).to(card)
    plain = ConvResNet(d_chans, 8, 3, 1, upsample=True, n_blocks=2,
                       use_pallas=False).to(card)
    plain.load_state_dict(net.state_dict())
    x = torch.randn(1, 8, 64, 64, device=card)
    before = dict(cr.LAUNCHES)
    y = net(x)
    # the 'up' block runs at 64^2 (under the gate's 128^2), the plain
    # block at 128^2 through the general route
    assert cr.LAUNCHES["convres_fwd_general"] == before["convres_fwd_general"] + 1
    y.square().sum().backward()
    assert cr.LAUNCHES["convres_bwd_general"] == before["convres_bwd_general"] + 1
    y_plain = plain(x)
    y_plain.square().sum().backward()
    _close(y.detach(), y_plain.detach(), torch.float32)
    for (name, p), q in zip(net.named_parameters(), plain.parameters()):
        _close(p.grad, q.grad, torch.float32)


def test_kernel_paths_refuse_what_they_cannot_take(card):
    x = torch.zeros(1, 1024, 48, device=card)
    g = torch.ones(48, device=card)
    # K1a: any width, but w_kv must be (C, 256)
    with pytest.raises(ValueError):
        ab.attention_ctx(x, g, g, torch.zeros(48, 128, device=card))
    # 48 in/out channels: neither ConvResBlock kernel takes them, with or
    # without autograd
    w = torch.zeros(1, 1, 48, 32, device=card, requires_grad=True)
    rest = (torch.zeros(32, device=card), torch.zeros(3, 3, 32, 32, device=card),
            torch.zeros(32, device=card), torch.zeros(3, 3, 32, 32, device=card),
            torch.zeros(32, device=card), torch.zeros(1, 1, 32, 48, device=card),
            torch.zeros(48, device=card))
    for grad in (True, False):
        with torch.set_grad_enabled(grad), pytest.raises(ValueError):
            cr.fused_convres_block(torch.zeros(1, 8, 8, 48, device=card), w, *rest)
    # K2 on bfloat16: x must be 16-byte aligned
    cw = (torch.zeros(1, 1, 32, 32, device=card), *rest[:5],
          torch.zeros(1, 1, 32, 32, device=card), torch.zeros(32, device=card))
    xm = torch.zeros(8 * 8 * 32 + 1, device=card, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError):
        cr.fused_convres_block(xm.view(1, 8, 8, 32), *cw)
    z = lambda *s, dt=torch.float32: torch.zeros(*s, device=card, dtype=dt)
    # K5: a wrong dtype, weights of another Cin, a lone post_bias (any
    # width runs: the wrapper pads)
    with pytest.raises(TypeError):
        c3.conv3x3_fused(z(1, 8, 8, 64, dt=torch.float16), z(3, 3, 64, 64), z(64))
    with pytest.raises(ValueError):
        c3.conv3x3_fused(z(1, 8, 8, 48), z(3, 3, 40, 64), z(64))
    with pytest.raises(ValueError):
        c3.conv3x3_fused(z(1, 8, 8, 64), z(3, 3, 64, 64), z(64), post_bias=z(1, 64))
    # K6: a wrong dtype, odd H or W, weights of another Cin
    with pytest.raises(TypeError):
        wg.conv3x3_winograd(z(1, 8, 8, 32, dt=torch.float16), z(3, 3, 32, 32), z(32))
    for hw in ((7, 8), (8, 9)):
        with pytest.raises(ValueError):
            wg.conv3x3_winograd(z(1, *hw, 32), z(3, 3, 32, 32), z(32))
    with pytest.raises(ValueError):
        wg.conv3x3_winograd(z(1, 8, 8, 24), z(3, 3, 16, 32), z(32))
    # K4: a wrong dtype, a width that is not whole heads (96 as heads of
    # 40), q, k, v of other shapes (any head width runs: the wrapper pads)
    with pytest.raises(TypeError):
        la.linear_attention(*(z(1, 64, 64, dt=torch.float16),) * 3)
    with pytest.raises(ValueError):
        la.linear_attention(*(z(1, 64, 96),) * 3, dim_head=40)
    with pytest.raises(ValueError):
        la.linear_attention(z(1, 64, 64), z(1, 64, 64), z(1, 32, 64))
    # K1c: a wrong dtype, a w_q of another width than x's (288 against 320)
    with pytest.raises(TypeError):
        ab.attention_1pass(z(1, 1024, 64, dt=torch.float16), z(64), z(64),
                           z(64, 256), z(64, 128), z(128, 64), z(64))
    with pytest.raises(ValueError):
        ab.attention_1pass(z(1, 1024, 320), z(320), z(320), z(320, 256),
                           z(288, 128), z(128, 320), z(320))


def _rand(card, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return lambda *s: torch.randn(*s, generator=gen, device=card)


def _conv3x3_args(r, bsz, cin, mode, dtype):
    if mode == "mish":
        return {"apply_mish": True}
    if not mode.startswith("gn_fold"):
        return {}
    args = {"scale": 1.0 + 0.1 * r(bsz, cin), "shift": 0.5 + 0.2 * r(bsz, cin)}
    if mode == "gn_fold_post_bias":
        args["post_bias"] = (0.2 * r(bsz, cin)).to(dtype)
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["identity", "mish", "gn_fold", "gn_fold_post_bias"])
@pytest.mark.parametrize("bsz,h,w,cin,cout", [
    (2, 16, 16, 128, 128), (1, 13, 20, 128, 256), (2, 32, 40, 256, 128),
    # the three x2 ResnetBlock seams at B = 2
    (2, 128, 128, 128, 128), (2, 64, 64, 256, 256), (2, 32, 32, 256, 256),
    (1, 16, 16, 64, 64),      # Cout 64: half of a 128-wide block masked
    (1, 16, 16, 32, 128),     # Cin 32: two stages of 16
    (1, 20, 36, 64, 192),     # partial bands both ways, Cout 192
    (2, 9, 12, 32, 64),       # W < 16: one partial band a row
    # bf16 takes the 16 x 16 band where it gives a block per SM (132 on
    # an H100 SXM), the 8 x 16 band below that (every case above)
    (3, 128, 128, 128, 128),  # 16 x 16 bands, 192 blocks
    (4, 100, 84, 64, 192),    # 16 x 16 bands, partial both ways, Cout 192
    (1, 12, 20, 40, 72)])     # ragged: padded to 64 -> 128 in the wrapper
def test_conv3x3_kernel_matches_plain(card, dtype, mode, bsz, h, w, cin, cout):
    """K5 in each prologue mode; 13 x 20 and the others leave partial
    bands; shift != 0, so a halo padded with prologue(0) would show."""
    r = _rand(card, h * w + cin + cout)
    x = r(bsz, h, w, cin).to(dtype)
    wt, b = (r(3, 3, cin, cout) / (9 * cin) ** 0.5).to(dtype), 0.1 * r(cout)
    args = _conv3x3_args(r, bsz, cin, mode, dtype)
    before = c3.LAUNCHES["conv3x3"]
    got = c3.conv3x3_fused(x, wt, b, **args)
    assert c3.LAUNCHES["conv3x3"] == before + 1
    _close(got, c3.plain(x, wt, b, **args), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["identity", "gn_fold_post_bias"])
def test_conv3x3_f32_keeps_f32_accuracy(card, mode):
    """f32 K5 splits each operand into bf16 hi + lo and runs three mma a
    product: within 1e-4 of max |y| at Cin 256 (f32 sums in another
    order), where one bf16 pass over K = 2304 lands near 1e-3."""
    r = _rand(card, 7)
    bsz, h, w, cin, cout = 2, 32, 32, 256, 128
    x = r(bsz, h, w, cin)
    wt, b = r(3, 3, cin, cout) / (9 * cin) ** 0.5, 0.1 * r(cout)
    args = _conv3x3_args(r, bsz, cin, mode, torch.float32)
    got = c3.conv3x3_fused(x, wt, b, **args)
    want = c3.plain(x, wt, b, **args)
    tol = 1e-4 * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)
    # the bound tells the two apart: one bf16 pass misses it
    bf = lambda t: t.to(torch.bfloat16).float()
    one_pass = c3.plain(bf(c3.prologue(x, **args)), bf(wt), b)
    assert float((one_pass - want).abs().max()) > tol
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("apply_mish", [False, True])
@pytest.mark.parametrize("bsz,h,w,cin,cout", [
    (2, 16, 16, 128, 128), (1, 14, 22, 128, 256), (1, 32, 32, 256, 64),
    # the three x2 3x3 convs at B = 2
    (2, 128, 128, 128, 128), (2, 64, 64, 256, 256), (2, 32, 32, 256, 256),
    (1, 16, 16, 16, 64),      # Cin 16: a single stage
    (1, 16, 16, 64, 32),      # Cout 32: half of a 64-wide block masked
    (1, 18, 30, 32, 96),      # partial bands both ways, Cout 96
    (3, 20, 36, 48, 160),     # Cout 160: the last 64-wide block half masked
    (1, 12, 20, 24, 40)])     # ragged: padded to 32 -> 64 in the wrapper
def test_winograd_kernel_matches_plain(card, dtype, apply_mish, bsz, h, w, cin,
                                       cout):
    """K6 against the plain version with its bf16 roundings of V and U;
    14 x 22, 18 x 30 and 20 x 36 leave partial 16 x 16-pixel bands; one
    launch of the conv and one of the weight transform."""
    r = _rand(card, h * w + cin + cout + 1)
    x = r(bsz, h, w, cin).to(dtype)
    wt, b = r(3, 3, cin, cout) / (9 * cin) ** 0.5, 0.1 * r(cout)
    before = dict(wg.LAUNCHES)
    got = wg.conv3x3_winograd(x, wt, b, apply_mish=apply_mish)
    assert wg.LAUNCHES == {k: v + 1 for k, v in before.items()}
    _close(got, wg.plain(x, wt, b, apply_mish), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_winograd_weight_transform_matches_plain(card, dtype):
    """K6's weight-transform launch against transform_weights rounded to
    bf16: the same f32 sums, so equal up to the order of three adds (one
    bf16 ulp where a sum lands on a rounding tie)."""
    w = _rand(card, 77)(3, 3, 64, 96).to(dtype)
    got = wg.weights_kernel(w)
    want = wg.transform_weights(w).to(torch.bfloat16).reshape(16, 64, 96)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-6)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,n,hd", [(2, 1000, 32), (3, 4096, 128),
                                      (1, 777, 64), (2, 100, 128),
                                      (8, 16384, 128)])
def test_linear_attention_kernel_matches_plain(card, dtype, bsz, n, hd):
    """K4; N not a multiple of the 64-token tile in three of the five;
    the last is the x2 UNet's 128^2 site at B = 8.  ctx is held to the
    f32 tolerance in either dtype (in bf16 the kernel multiplies p as a
    bf16 pair)."""
    r = _rand(card, n + hd)
    q, k, v = (r(bsz, n, hd).to(dtype) for _ in range(3))
    before = dict(la.LAUNCHES)
    got = la.linear_attention(q, k, v)
    assert la.LAUNCHES == {n: c + 1 for n, c in before.items()}
    _close(got, la.plain(q, k, v), dtype)
    ctx = la.linear_attention_ctx(k, v)
    # f32 from the same inputs in either dtype: sums in another order
    _close(la.blocks_of(ctx), la.ctx_plain(k, v), torch.float32)
    if hd > 32:
        assert float(ctx[:, :32, 32:].abs().max()) == 0.0   # block diagonal
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# heads of 20 (padded to 32 in the wrapper), 48 (padded to 64), 64 and 128
# (the kernels' own widths, (DH / 32)^2 blocks of A a head)
@pytest.mark.parametrize("bsz,n,hd,dim_head", [(2, 777, 60, 20), (2, 300, 96, 48),
                                               (1, 1000, 128, 64), (1, 500, 256, 128)])
def test_linear_attention_heads_of_any_width(card, dtype, bsz, n, hd, dim_head):
    """K4 at head widths other than 32 against its plain version: the
    ctx kernel's diagonal blocks and the whole op (both kernels launch
    once each)."""
    r = _rand(card, n + hd + dim_head)
    q, k, v = (r(bsz, n, hd).to(dtype) for _ in range(3))
    before = dict(la.LAUNCHES)
    got = la.linear_attention(q, k, v, dim_head)
    assert la.LAUNCHES == {name: c + 1 for name, c in before.items()}
    assert got.shape == q.shape
    _close(got, la.plain(q, k, v, dim_head), dtype)
    if dim_head % 32 == 0:
        ctx = la.linear_attention_ctx(k, v, dim_head)
        _close(la.blocks_of(ctx, dim_head), la.ctx_plain(k, v, dim_head),
               torch.float32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_merges_a_skewed_chunk(card, dtype):
    """One token chunk holds keys ~40 above the rest: the merge must
    rescale both s and A of every other chunk by exp(m_i - m) (an
    unrescaled merge is off by ~exp(40))."""
    r = _rand(card, 11)
    q, k, v = (r(2, 16384, 128) for _ in range(3))
    k[:, 9000:9100] += 40.0
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = la.linear_attention(q, k, v)
    assert torch.isfinite(got).all()
    _close(got, la.plain(q, k, v), dtype)
    _close(got, la.reference_impl(q, k, v), dtype)


def test_linear_attention_gradients_on_card(card):
    """The kernel forward's backward is autograd through reference_impl."""
    r = _rand(card, 12)
    args = [r(2, 1024, 128) for _ in range(3)]
    grads = []
    for fn in (la.linear_attention, la.reference_impl):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves).square().sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,n,c", [(2, 1000, 32), (3, 4096, 128),
                                     (1, 1024, 256), (2, 777, 64),
                                     (8, 16384, 128), (1, 1024, 96),
                                     (2, 1000, 160), (1, 777, 192),
                                     (2, 600, 224), (2, 1000, 20),
                                     (2, 777, 40), (1, 1024, 320),
                                     (2, 600, 512), (1, 777, 1024)])
def test_attention_one_pass_matches_plain(card, dtype, bsz, n, c, monkeypatch):
    """K1c against its plain version and against the two-pass route, and
    attention_block under FORCE_ONE_PASS takes it (and not the passes)."""
    r = _rand(card, n + c + 3)
    x = r(bsz, n, c).to(dtype)
    # g, b far from 1, 0: LN moves both passes' outputs
    g, b, b_out = 1.0 + 0.5 * r(c), 0.5 * r(c), 0.1 * r(c)
    w_qkv = (r(c, 384) / c ** 0.5).to(dtype)
    w_out = (r(128, c) / 128 ** 0.5).to(dtype)
    w_q, w_k, w_v = (w_qkv.reshape(c, 3, 128)[:, i].contiguous() for i in range(3))
    w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
    got = ab.attention_1pass(x, g, b, w_kv, w_q, w_out, b_out)
    want = ab.one_pass_reference(x, g, b, w_qkv, w_out, b_out)
    _close(got, want, dtype)
    with torch.no_grad():
        two_pass = ab.attention_block(x, g, b, w_qkv, w_out, b_out)
        monkeypatch.setattr(ab, "FORCE_ONE_PASS", True)
        before = dict(ab.LAUNCHES)
        block = ab.attention_block(x.clone(), g, b, w_qkv, w_out, b_out,
                                   inplace=True)
    assert ab.LAUNCHES["attn_1pass"] == before["attn_1pass"] + 1
    assert ab.LAUNCHES["attn_ctx"] == before["attn_ctx"]
    _close(block, two_pass, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bsz,n,c", [(8, 4096, 128), (2, 1000, 96), (2, 600, 512)])
def test_attention_one_pass_is_deterministic(card, bsz, n, c):
    """K1c twice on the same bf16 input gives the same bits: pass A's
    partials summed in chunk order, the fold in a fixed order, no
    atomics (C = 512: the WIDE items)."""
    x, g, b, b_out, _, w_out, w_q, w_kv = _attn_args(card, bsz, n, c,
                                                     torch.bfloat16, 7)
    w_out = w_out.contiguous()
    first = ab.attention_1pass(x, g, b, w_kv, w_q, w_out, b_out)
    assert torch.equal(ab.attention_1pass(x, g, b, w_kv, w_q, w_out, b_out), first)


# ---------------------------------------------------------------- probes P1-P4


def _err_ok(name, got, want, tol_frac):
    """probes._util.check with tol_frac of the larger of 1 and max |want|
    (0: bit for bit)."""
    torch.cuda.synchronize()
    pu.check(name, got, want, pu.scaled_tol(want, tol_frac) if tol_frac else 0.0)


def _p1_inputs(card, bsz, n, c):
    r = _rand(card, n + c + 40)
    x = r(bsz, n, c).to(torch.bfloat16)
    # g, b far from 1, 0: LN moves both passes' outputs
    g, b, b_out = 1.0 + 0.5 * r(c), 0.5 * r(c), 0.1 * r(c)
    w_kv = (r(c, 256) / c ** 0.5).to(torch.bfloat16)
    w_eff = (r(bsz, c, c) / c ** 0.5).to(torch.bfloat16)
    return x, g, b, b_out, w_kv, w_eff


# (N, C, tn_target): tiles of 1000 tokens end in a ragged 64-token
# sub-tile, and at G = 4, 8 they shrink to 8 tokens; at C = 256, 4096
# tokens give 1, 4 and 8 tiles a sample
P1_CASES = [(1000, 128, 1000), (4096, 256, None)]


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("variant", ["full", "noexp", "noln", "payload", "dma"])
@pytest.mark.parametrize("n,c,tn_target", P1_CASES)
def test_probe_attention_ctx_matches_plain(card, variant, group, n, c, tn_target):
    x, g, b, _, w_kv, _ = _p1_inputs(card, 8, n, c)
    before = p1.LAUNCHES["probe_attn_ctx"]
    got = p1.pass_a(x, g, b, w_kv, variant, group, tn_target)
    assert p1.LAUNCHES["probe_attn_ctx"] == before + 1
    want = p1.ctx_plain(x, g, b, w_kv, variant)
    torch.cuda.synchronize()
    pu.check(f"pass A {variant}", got, want,
             p1.ctx_tol(want, variant))


@pytest.mark.parametrize("n,c,tn_target", P1_CASES)
def test_probe_attention_ctx_check_fails_a_wrong_kernel(card, n, c, tn_target):
    """The kernel's pass A without LN, and its pass A over the first half
    of the tokens alone (a reduce that dropped one of two tiles), both
    fail the full variant's check."""
    x, g, b, _, w_kv, _ = _p1_inputs(card, 8, n, c)
    want = p1.ctx_plain(x, g, b, w_kv)
    half = x[:, : n // 2].contiguous()
    for wrong in (p1.pass_a(x, g, b, w_kv, "noln", 1, tn_target),
                  p1.pass_a(half, g, b, w_kv, "full", 1, n // 2)):
        torch.cuda.synchronize()
        with pytest.raises(AssertionError, match="above tol"):
            pu.check("wrong pass A", wrong, want, p1.ctx_tol(want))


@pytest.mark.parametrize("n,c,tn_target", P1_CASES)
def test_probe_attention_ctx_check_fails_a_masked_or_transposed_a(card, n, c,
                                                                   tn_target):
    """The kernel's own ctx passes the full variant's check; made K1a's
    (the off-diagonal 32 x 32 blocks of its A set to 0) or with its A
    transposed, it fails it: a kernel that reused K1a's head-masked
    product, or read p and v the wrong way round, would not pass."""
    x, g, b, _, w_kv, _ = _p1_inputs(card, 8, n, c)
    got = p1.pass_a(x, g, b, w_kv, "full", 1, tn_target)
    a, s = p1.ctx_parts(x, g, b, w_kv)
    want = a / s.clamp(min=1.0)[..., None]
    torch.cuda.synchronize()
    tol = p1.ctx_tol(want)
    pu.check("pass A full", got, want, tol)
    for name, wrong in p1.ctx_faults(got, s).items():
        with pytest.raises(AssertionError, match="above tol"):
            pu.check(name, wrong, want, tol)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("variant", ["full", "payload"])
@pytest.mark.parametrize("n,c,tn_target", P1_CASES)
def test_probe_attention_ctx_is_deterministic(card, variant, group, n, c, tn_target):
    """Pass A twice on the same input gives the same bits: the partials
    of each (sample, token tile) summed in tile order, no atomics."""
    x, g, b, _, w_kv, _ = _p1_inputs(card, 8, n, c)
    first = p1.pass_a(x, g, b, w_kv, variant, group, tn_target)
    assert torch.equal(p1.pass_a(x, g, b, w_kv, variant, group, tn_target), first)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("variant", ["full", "noln", "dma"])
@pytest.mark.parametrize("n,c,tn_target", P1_CASES)
def test_probe_attention_out_matches_plain(card, variant, group, n, c, tn_target):
    x, g, b, b_out, _, w_eff = _p1_inputs(card, 8, n, c)
    got = p1.pass_b(x, g, b, w_eff, b_out, variant, group, tn_target)
    _err_ok(f"pass B {variant}", got, p1.out_plain(x, g, b, w_eff, b_out, variant),
            0.0 if variant == "dma" else p1.TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", [v[0] for v in p2.VARIANTS])
def test_probe_copies_are_exact(card, variant, dtype):
    x = _rand(card, 50)(2, 16384, 128).to(dtype)
    keep = x.clone()
    got = p2.copy(x, variant)
    torch.cuda.synchronize()
    assert torch.equal(got, keep) and torch.equal(x, keep)
    assert (got.data_ptr() == x.data_ptr()) == variant.startswith("alias")


@pytest.mark.parametrize("tn,c", [(100, 40), (1000, 40), (9, 16)])
def test_probe_copy_ragged_tiles(card, tn, c):
    """Tiles of 8000 and 80000 bytes (less than a stage, two stages and
    a part) and 288 bytes (not a multiple of the copy kernel's 8 x 256
    words)."""
    x = _rand(card, 51)(3, 9 * tn, c).to(torch.bfloat16)
    for y in (p2.copy_async_kernel(x, tn), p2.copy_kernel(x, tn),
              p2.copy_kernel(x, tn, flat=True)):
        torch.cuda.synchronize()
        assert torch.equal(y, x)


def _p3_inputs(card, bsz, h, w, seed):
    r = _rand(card, seed)
    cm = 32
    # biases +1: unmasked halo rows hold mish(b1 ...), far from zero
    return (r(bsz, h, w, 64).to(torch.bfloat16),
            r(1, 1, 64, cm) / 8.0, 0.1 * r(cm) + 1.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm) + 1.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm),
            r(1, 1, cm, 64) / cm ** 0.5, 0.1 * r(64))


# (1, 5, 9): H under one 16-row tile and W under 16, the partial tiles of
# both tile heights
@pytest.mark.parametrize("variant", list(p3.VARIANTS))
@pytest.mark.parametrize("bsz,h,w", [(2, 40, 36), (1, 64, 64), (1, 5, 9)])
def test_probe_convres_matches_plain(card, variant, bsz, h, w):
    args = _p3_inputs(card, bsz, h, w, h * w + 60)
    got = p3.convres(*args, variant=variant)
    tol = p3.TOL_BF16_MISH if p3.VARIANTS[variant][2] == "bf16" else p3.TOL
    _err_ok(variant, got, p3.plain(*args, variant=variant), tol)


def test_probe_convres_nomask_is_wrong_only_at_the_border_rows(card):
    args = _p3_inputs(card, 1, 40, 36, 61)
    diff = (p3.convres(*args, variant="nomask").float()
            - p3.convres(*args, variant="rowmask").float()).abs().amax(dim=(0, 2, 3))
    tol = pu.scaled_tol(p3.plain(*args, variant="rowmask"), p3.TOL)
    assert float(diff[2:-2].max()) == 0.0 and float(diff[[0, -1]].min()) > tol


# (2, 20, 70), (1, 3, 9): rows not 16-byte aligned (W % 8 != 0), the second
# narrower than one tile; (2, 13, 64): H not a multiple of the band
# height; (1, 256, 256): the aligned, fast staging; (3, 256, 256): the
# probe's size at a small B
@pytest.mark.parametrize("bsz,h,w", [(2, 20, 70), (1, 64, 64), (1, 3, 9), (2, 13, 64),
                                     (1, 256, 256), (3, 256, 256)])
def test_probe_cmajor_conv_matches_plain(card, bsz, h, w):
    r = _rand(card, h * w + 70)
    x = r(bsz, 32, h, w).to(torch.bfloat16)
    wmat = p4.to_wmat(r(3, 3, 32, 32) / 17.0).to(torch.bfloat16)
    _err_ok("cmajor conv", p4.cmajor_conv(x, wmat), p4.plain(x, wmat), p4.TOL)


def test_probe_cmajor_conv_takes_a_misaligned_x(card):
    """x a view 2 bytes into its storage: rows not 16-byte aligned at W =
    64, which the kernel stages by 2-byte loads."""
    r = _rand(card, 71)
    x = r(2 * 32 * 16 * 64 + 1).to(torch.bfloat16)[1:].view(2, 32, 16, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    wmat = p4.to_wmat(r(3, 3, 32, 32) / 17.0).to(torch.bfloat16)
    _err_ok("cmajor conv", p4.cmajor_conv(x, wmat), p4.plain(x, wmat), p4.TOL)


def _ring():
    """copy_async_kernel's STAGE (bytes) and STAGES, read from its source."""
    src = (_build.CSRC / "probe_copy.cu").read_text()
    get = lambda k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
    return get("STAGE"), get("STAGES")


@pytest.mark.parametrize("case", ["ring_and_a_part", "under_a_stage", "tiles_per_block"])
def test_probe_copy_async_ring_is_exact(card, case):
    """P2b's ring: a tile of STAGES + 1/2 chunks (the ring wraps, a
    part-chunk last); a tile smaller than one stage; B = 1 and 2000
    tiles, several to a block of the persistent grid."""
    stage, stages = _ring()
    c = 64                                   # 128 bytes a bf16 token
    tn, n = {"ring_and_a_part": ((2 * stages + 1) * stage // 256, None),
             "under_a_stage": (8, None),
             "tiles_per_block": (16, 16 * 2000)}[case]
    x = _rand(card, 52)(1 if n else 2, n or 3 * tn, c).to(torch.bfloat16)
    y = p2.copy_async_kernel(x, tn)
    torch.cuda.synchronize()
    assert torch.equal(y, x)


def test_probe_kernels_refuse_what_they_cannot_take(card):
    x, g, b, b_out, w_kv, w_eff = _p1_inputs(card, 8, 1024, 128)
    with pytest.raises(TypeError):
        p1.pass_a(x.float(), g, b, w_kv.float())
    with pytest.raises(ValueError):
        p1.pass_a(x, g, b, w_kv, group=3)
    with pytest.raises(ValueError):
        p1.pass_b(x[:, :, :64].contiguous(), g[:64], b[:64], w_eff[:, :64, :64],
                  b_out[:64])
    with pytest.raises(ValueError):
        p2.copy_kernel(x, 1000)
    with pytest.raises(ValueError):
        p3.convres(torch.zeros(1, 8, 8, 32, device=card, dtype=torch.bfloat16),
                   *_p3_inputs(card, 1, 8, 8, 0)[1:])
    with pytest.raises(ValueError):
        p4.cmajor_conv(torch.zeros(1, 16, 8, 8, device=card, dtype=torch.bfloat16),
                       torch.zeros(32, 288, device=card))


SMALL_X2 = dict(model="dddpm", dataset="synthetic", image_size=256, T=50,
                loss_type="simple", beta_schedule="linear", loss_flat="sum",
                unet_chan=32, unet_dims=(1, 2), unet_dropout=0.0, unet_in=8,
                n_downsamples=1, d_mode="convolutional_res",
                u_mode="convolutional_res", d_dropout=0, d_chans=64,
                d_n_blocks=2, u_n_blocks=2, ae_loss=True, t_rec_max=5,
                force_latent=True, compute_dtype="bfloat16")


def _small_x2(card, **selectors):
    """A small x2 dDDPM at 256^2 (latent 128^2 x 8, UNet 32 wide with
    attention sites of 16384 and 4096 tokens; decoder blocks cio 64 /
    cm 32, which the fused ConvResBlock takes), bf16, on the card."""
    net, _, init_fn, cfg = build_model(dict(SMALL_X2, **selectors), device=card)
    init_fn(0)
    return net, cfg


@pytest.mark.parametrize("value,kernels", [("auto", True), (True, True),
                                           (False, False)])
def test_attention_selector_on_card(card, value, kernels):
    """use_pallas_attention: 'auto' pins True on the card; False runs
    a UNet forward with no K1a/K1b (or K1c) launch."""
    net, cfg = _small_x2(card, use_pallas_attention=value)
    assert cfg["use_pallas_attention"] is kernels
    gen = torch.Generator(device=card).manual_seed(3)
    z = torch.randn(2, 8, 128, 128, generator=gen, device=card)
    before = dict(ab.LAUNCHES)
    with torch.no_grad():
        out = net.unet(z, torch.tensor([3, 40], device=card))
    torch.cuda.synchronize()
    launched = {k: ab.LAUNCHES[k] - before[k] for k in before}
    if kernels:
        assert launched["attn_ctx"] > 0 and launched["attn_out"] > 0, launched
    else:
        assert not any(launched.values()), launched
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("value", [True, False])
def test_resample_selector_on_card(card, value):
    """use_pallas_resample False: a decode launches no K2."""
    net, _ = _small_x2(card, use_pallas_resample=value)
    gen = torch.Generator(device=card).manual_seed(4)
    z = torch.randn(1, 8, 128, 128, generator=gen, device=card)
    before = cr.LAUNCHES["convres_fwd"]
    with torch.no_grad():
        x = net.upsample(z)
    torch.cuda.synchronize()
    assert (cr.LAUNCHES["convres_fwd"] > before) is value
    assert x.shape == (1, 3, 256, 256) and torch.isfinite(x).all()


def test_attention_width_on_card(card):
    """A UNet 256 channels wide with dims (1, 2) (attention sites of 256,
    512, 512 and 256 channels above 512 tokens on a 64^2 latent; at 512
    the weights stream in K-slabs and pass B writes a new tensor that is
    copied over x) runs K1a/K1b at every site with use_pallas_attention
    True, and matches the same UNet with it False."""
    outs = []
    for value in (True, False):
        cfg = dict(model="dddpm", dataset="synthetic", image_size=128, T=50,
                   loss_type="simple", beta_schedule="linear",
                   loss_flat="sum", unet_chan=256, unet_dims=(1, 2),
                   unet_dropout=0.0, unet_in=8, n_downsamples=1,
                   d_mode="convolutional_res", u_mode="convolutional_res",
                   d_dropout=0, d_chans=64, d_n_blocks=2, u_n_blocks=2,
                   ae_loss=True, t_rec_max=5, force_latent=True,
                   compute_dtype="bfloat16", use_pallas_attention=value)
        net, _, init_fn, cfg = build_model(cfg, device=card)
        init_fn(0)
        assert cfg["use_pallas_attention"] is value
        assert [m.norm.g.shape[0] for m in net.unet.attns] == [256, 512, 512, 256]
        gen = torch.Generator(device=card).manual_seed(3)
        z = torch.randn(1, 8, 64, 64, generator=gen, device=card)
        before = dict(ab.LAUNCHES)
        with torch.no_grad():
            outs.append(net.unet(z, torch.tensor([40], device=card)))
        torch.cuda.synchronize()
        launched = {k: ab.LAUNCHES[k] - before[k] for k in before}
        want = 4 if value else 0
        assert launched == {"attn_ctx": want, "attn_out": want,
                            "attn_1pass": 0}, launched
        del net
    assert torch.isfinite(outs[0]).all()
    _close(outs[0], outs[1], torch.bfloat16)


def test_ddim_chain_attention_selector_on_card(card):
    """A 5-step DDIM chain (eta 0.5) of the small x2 model in f32 from one
    seed: every step with use_pallas_attention True (K1a/K1b) equals the
    step with it False from the same state; the whole chain with True
    launches K1a and K1b at each site of each step, and its samples are
    finite and in range."""
    procs = []
    for value in (True, False):
        net, proc, init_fn, _ = build_model(
            dict(SMALL_X2, compute_dtype="float32", use_pallas_attention=value),
            device=card)
        init_fn(0)
        procs.append(proc)
    kern, plain = procs
    taus = kern.ddim_taus(5)
    coefs = kern.ddim_coefficients(taus, 0.5)
    img = kern.init_latent(2, seed=6)
    with torch.no_grad():
        for i, t in enumerate(taus):
            z = torch.randn(img.shape, generator=torch.Generator(
                device=card).manual_seed(t), device=card)
            want = plain.ddim_step(img, t, coefs[i], z)
            _close(kern.ddim_step(img, t, coefs[i], z), want, torch.float32)
            img = want
    before = dict(ab.LAUNCHES)
    x, latent = kern.ddim_sample(2, seed=6, num_steps=5, eta=0.5)
    torch.cuda.synchronize()
    launched = {k: ab.LAUNCHES[k] - before[k] for k in before}
    assert launched["attn_ctx"] == launched["attn_out"] > 0, launched
    assert launched["attn_ctx"] % 5 == 0 and launched["attn_1pass"] == 0
    assert x.shape == (2, 256, 256, 3) and latent.shape == (2, 128, 128, 8)
    assert torch.isfinite(x).all() and float(x.abs().max()) <= 1.0


def test_inception_on_card_matches_cpu(card):
    """The extractor on the card (f32, TF32 off inside, whatever the
    global flags say, and the flags restored) against the CPU, the same
    random-init weights, all three heads at 1e-3 of max |want|; and the
    pairwise-distance tile against float64 numpy at 1e-4 relative, on
    rows with pool3's large common offset, where the form cancels: the
    same function without its full-f32 pin (a TF32 product) misses the
    limit there."""
    import contextlib
    from unittest import mock

    from dddpm_tpu_torch.evaluation import prec_recall
    from dddpm_tpu_torch.evaluation.inception import FeatureExtractor
    from dddpm_tpu_torch.evaluation.prec_recall import pairwise_sq_dists

    imgs = np.random.RandomState(0).randint(0, 255, (6, 64, 64, 3), np.uint8)
    want = FeatureExtractor(batch_size=4, device="cpu")(imgs)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = FeatureExtractor(batch_size=4, device=card)(imgs)
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        rng = np.random.RandomState(1)
        a, b = 1 + 0.3 * rng.randn(300, 2048), 1 + 0.3 * rng.randn(200, 2048)
        ta, tb = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
        d = pairwise_sq_dists(ta, tb).cpu().numpy()
        assert torch.backends.cuda.matmul.allow_tf32
        with mock.patch.object(prec_recall, "full_f32", contextlib.nullcontext):
            d_tf32 = pairwise_sq_dists(ta, tb).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for k in ("pool3", "spatial", "softmax"):
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= 1e-3 * float(np.abs(want[k]).max()), (k, err)
    exact = ((a[:, None] - b[None]) ** 2).sum(-1)
    assert float(np.abs(d - exact).max()) <= 1e-4 * float(exact.max())
    assert float(np.abs(d_tf32 - exact).max()) > 1e-4 * float(exact.max())


# Q1, the int8 conv: the five shape classes of the x2 UNet's quantized
# convs (B = 2) and ragged shapes with other widths: Cin and Cout not
# multiples of 32 or 64 (160: unet_chan 160; 144 at 13 x 21, whose NCHW
# rows are copied channels_last; 130: channels_last pixels of 260 or
# 520 bytes, copied with the channels padded)
INT8_SHAPES = [(2, 128, 128, 128, 128), (2, 64, 64, 256, 256),
               (2, 64, 64, 128, 128), (2, 32, 32, 256, 256),
               (2, 16, 16, 256, 256), (1, 13, 21, 96, 192),
               (2, 16, 16, 160, 160), (1, 13, 21, 144, 144),
               (1, 8, 8, 130, 130)]


def _int8_args(card, bsz, h, w, cin, cout, dtype, seed, skip):
    r = _rand(card, seed)
    x = (2.0 * r(bsz, cin, h, w)).to(dtype).contiguous(memory_format=torch.channels_last)
    qw = qt.prepare_weight(0.05 * r(cout, cin, 3, 3))
    # amax below the input's largest magnitude: some values saturate
    amax = (x.float().abs().amax() * 0.8).reshape(())
    extra = {"bias": 0.1 * r(cout)}
    if skip:
        s = (5.0 * r(bsz, cin, h, w)).to(dtype).contiguous(memory_format=torch.channels_last)
        extra.update(skip=s, qw_skip=qt.prepare_weight(0.05 * r(cout, cin, 3, 3)),
                     amax_skip=(s.float().abs().amax() * 0.9).reshape(()))
    return (x, qw, amax), extra


# (skip, x's layout, the skip's layout): Q1 reads each operand as it lies
INT8_LAYOUTS = [(False, "nchw", None), (False, "cl", None),
                (True, "nchw", "nchw"), (True, "cl", "cl"),
                (True, "nchw", "cl"), (True, "cl", "nchw")]
_FMT = {"nchw": torch.contiguous_format, "cl": torch.channels_last}


@pytest.mark.parametrize("skip,x_layout,skip_layout", INT8_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,h,w,cin,cout", INT8_SHAPES)
def test_int8_conv_kernel_equals_plain(card, dtype, skip, x_layout, skip_layout,
                                       bsz, h, w, cin, cout):
    """Q1 against its plain version: equal, bit for bit, whatever the
    operands' layouts; one launch, an NCHW-contiguous output."""
    args, extra = _int8_args(card, bsz, h, w, cin, cout, dtype, h + cin, skip)
    args = (args[0].contiguous(memory_format=_FMT[x_layout]),) + args[1:]
    if skip:
        extra["skip"] = extra["skip"].contiguous(memory_format=_FMT[skip_layout])
    before = qt.LAUNCHES["int8_conv"]
    got = qt.int8_conv_q(*args, **extra)
    assert qt.LAUNCHES["int8_conv"] == before + 1
    want = qt.plain(*args, **extra)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bsz, cout, h, w)
    assert got.is_contiguous()
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


def test_int8_block_runs_with_no_layout_copy(card):
    """One quantized Block (64^2, c128, bf16) fed what the Block before
    it gives (GroupNorm -> mish, NCHW): Q1 gets that very tensor, writes
    NCHW, and GroupNorm reads Q1's output with no copy kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dddpm_tpu_torch.models.blocks import Block

    torch.manual_seed(0)
    blocks = [Block(128, 128, compute_dtype=torch.bfloat16, quant="int8").to(card)
              for _ in range(2)]
    for b in blocks:
        b.conv.amax_x.fill_(3.0)
    x0 = torch.randn(2, 128, 64, 64, device=card).to(torch.bfloat16)
    with torch.no_grad():
        h = blocks[0](x0)
    assert h.is_contiguous() and h.dtype == torch.bfloat16
    passed, conv_out = [], []
    lib = qt._lib()

    class Recorder:
        def int8_conv(self, *a):
            passed.append(a[0].value)
            return lib.int8_conv(*a)

    hook = blocks[1].conv.register_forward_hook(lambda m, a, y: conv_out.append(y))
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(qt, "_lib", lambda: Recorder())
        blocks[1](h)
    hook.remove()
    assert passed == [h.data_ptr()]
    y = conv_out[0].float()
    assert y.is_contiguous()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        blocks[1].norm(y)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert names, "the profiler saw no kernel"
    assert not [n for n in names if "copy" in n.lower()], names


def _reciprocal_flips(xs: float, n: int = 16) -> np.ndarray:
    """Up to n values v in [-127 xs, 127 xs] where round(v / xs) and
    round(v * (1 / xs)) differ (f32, half to even): within 16 ulps of the
    .5 ties."""
    xs32 = np.float32(xs)
    inv = np.float32(1.0) / xs32
    found = []
    for k in range(-127, 127):
        tie = np.float32((k + 0.5) * xs32)
        for d in range(-16, 17):
            v = np.float32(tie + np.float32(d) * np.spacing(tie))
            if np.round(v / xs32) != np.round(v * inv):
                found.append(v)
                break
        if len(found) == n:
            break
    return np.array(found, np.float32)


@pytest.mark.parametrize("fault", ["transposed_taps", "reciprocal"])
def test_int8_conv_check_fails_a_wrong_plain(card, fault, monkeypatch):
    """The exact check sees a plain version with the 3x3 taps transposed,
    or with x * (1 / xs) in place of x / xs (x holds values where the
    two round to other integers)."""
    args, extra = _int8_args(card, 2, 64, 64, 128, 128, torch.float32, 5, False)
    x, qw, amax = args
    if fault == "reciprocal":
        # an amax whose scale has such values (for a few scales 1 / xs
        # rounds so closely that none lies near a tie)
        for frac in (0.8, 0.77, 0.73, 0.7, 0.66, 0.6, 0.55, 0.5):
            amax = (x.float().abs().amax() * frac).reshape(())
            flips = _reciprocal_flips(float(qt.act_scale_from_amax(amax)))
            if len(flips) >= 8:
                break
        assert len(flips) >= 8
        x[0, 0, 0, :len(flips)] = torch.from_numpy(flips).to(card)
    got = qt.int8_conv_q(x, qw, amax, **extra)
    assert torch.equal(got, qt.plain(x, qw, amax, **extra))
    if fault == "transposed_taps":
        qw = qt.QWeight(qw.wq.transpose(2, 3).contiguous(), qw.ws, qw.packed)
    else:
        monkeypatch.setattr(qt, "quantize_act", lambda v, s: torch.clamp(
            torch.round(v.float() * (1.0 / s)), -127, 127).to(torch.int8))
    assert not torch.equal(got, qt.plain(x, qw, amax, **extra))


def test_int8_conv_refuses_what_it_cannot_take(card):
    z = lambda *s, dt=torch.float32: torch.zeros(*s, device=card, dtype=dt)
    qw = qt.prepare_weight(z(64, 48, 3, 3))
    with pytest.raises(ValueError):          # weights packed for Cin 48
        qt.int8_conv_q(z(1, 96, 8, 8), qw, z(()))
    with pytest.raises(ValueError):          # a bias of 64 for Cout 96
        qt.int8_conv_q(z(1, 64, 8, 8), qt.prepare_weight(z(96, 64, 3, 3)), z(()),
                       bias=z(64))
    qw = qt.prepare_weight(z(64, 64, 3, 3))
    with pytest.raises(TypeError):
        qt.int8_conv_q(z(1, 64, 8, 8, dt=torch.float16), qw, z(()))
    with pytest.raises(ValueError):          # a skip of another shape
        qt.int8_conv_q(z(1, 64, 8, 8), qw, z(()), z(1, 64, 8, 4), qw, z(()))
    with pytest.raises(ValueError):          # amax of two values
        qt.int8_conv_q(z(1, 64, 8, 8), qw, z(2))


INT8_CFG = {
    "model": "dddpm", "dataset": "synthetic", "image_size": 32,
    "batch_size": 2, "T": 20, "loss_type": "simple",
    "beta_schedule": "cosine", "loss_flat": "sum", "unet_chan": 128,
    "unet_dims": (1, 2), "unet_dropout": 0.0, "unet_in": 8,
    "n_downsamples": 1, "d_mode": "convolutional_res",
    "u_mode": "convolutional_res", "d_dropout": 0, "d_chans": 64,
    "d_n_blocks": 1, "u_n_blocks": 1, "ae_loss": True, "t_rec_max": 5,
    "force_latent": True, "compute_dtype": "bfloat16", "conv_quant": "int8",
}


def test_int8_path_launches_q1_at_every_quantized_conv(card):
    """Calibration (noise, 2 points) and a 3-step chain on the card: Q1
    launches once per quantized operand per UNet eval (14 at a 16^2
    latent, dims (1, 2)), and the chain's states stay finite."""
    from dddpm_tpu_torch.models.blocks import quant_buffers
    from dddpm_tpu_torch.quantize import calibrate_conv_quant

    net, process, init_fn, config = build_model(INT8_CFG)
    init_fn(0)
    bufs = quant_buffers(net)
    assert len(bufs) == 14
    qt.LAUNCHES["int8_conv"] = 0
    calibrate_conv_quant(config, net, process, batch_size=2, n_points=2,
                         mode="noise")
    assert qt.LAUNCHES["int8_conv"] == 14 * 3
    assert all(float(b) > 0 for b in bufs.values())
    qt.LAUNCHES["int8_conv"] = 0
    z = process.p_sample_chain(process.init_latent(2, seed=1), [3, 2, 1], seed=1)
    torch.cuda.synchronize()
    assert qt.LAUNCHES["int8_conv"] == 14 * 3
    assert torch.isfinite(z).all()
