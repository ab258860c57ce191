"""Card-only tests: each CUDA kernel of the port against its plain
PyTorch version on the card.  They skip where no CUDA card is present;
on the card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX, which the card's machine
need not have.)
"""
import pytest
import torch

from dddpm_tpu_torch.ops import attention_block as ab
from dddpm_tpu_torch.ops import convres as cr

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    # bf16: stages rounded in other places (one bf16 ulp each, 0.4-0.8%);
    # f32: sums in other orders
    tol = (3e-2 if dtype == torch.bfloat16 else 1e-3) * max(
        1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,n,c", [(2, 1000, 32), (3, 4096, 128),
                                     (1, 1024, 256), (2, 777, 64)])
def test_attention_kernels_match_plain(card, dtype, bsz, n, c):
    gen = torch.Generator(device=card).manual_seed(n + c)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    x = r(bsz, n, c).to(dtype)
    g, b, b_out = 1.0 + 0.1 * r(c), 0.1 * r(c), 0.1 * r(c)
    w_qkv = (r(c, 384) / c ** 0.5).to(dtype)
    w_out = (r(128, c) / 128 ** 0.5).to(dtype)
    w_q, w_k, w_v = (w_qkv.reshape(c, 3, 128)[:, i] for i in range(3))
    w_kv = torch.cat([w_k, w_v], dim=1).contiguous()
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
@pytest.mark.parametrize("scale", [None, "up", "down"])
@pytest.mark.parametrize("bsz,h,w,c", [(2, 32, 64, 64), (1, 40, 36, 32),
                                       (1, 16, 16, 128)])
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


def _convres_args(card, bsz, h, w, c, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    cm = cr.MID_CHANNELS
    return (r(bsz, h, w, c).to(dtype),
            r(1, 1, c, cm) / c ** 0.5, 0.1 * r(cm) + 2.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm) + 2.0,
            r(3, 3, cm, cm) / (9 * cm) ** 0.5, 0.1 * r(cm),
            r(1, 1, cm, c) / cm ** 0.5, 0.1 * r(c)), gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,h,w,c", [(2, 32, 64, 64), (1, 40, 36, 32),
                                       (1, 16, 16, 128), (3, 8, 8, 64)])
def test_convres_backward_kernel_matches_plain(card, dtype, bsz, h, w, c):
    """K3 (dx and the eight dW/db) against backward_reference, with b1/b2
    shifted by +2 so that a halo slip shows; 40x36 leaves partial tiles."""
    args, gen = _convres_args(card, bsz, h, w, c, dtype, h * w + c + 1)
    dy = torch.randn(bsz, h, w, c, generator=gen, device=card).to(dtype)
    for residual in (True, False):
        got = cr._bwd_kernel(*args, dy, residual)
        want = cr.backward_reference(*args, dy, residual)
        for g, t in zip(got, want):
            assert g.shape == t.shape
            _close(g, t, dtype)
    torch.cuda.synchronize()


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


def test_kernel_paths_refuse_what_they_cannot_take(card):
    x = torch.zeros(1, 1024, 48, device=card)
    g = torch.ones(48, device=card)
    with pytest.raises(ValueError):
        ab.attention_ctx(x, g, g, torch.zeros(48, 256, device=card))
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
