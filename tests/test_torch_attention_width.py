"""The attention block's channel widths (dddpm_tpu_torch/ops/attention_block.py):
the kernels take every width C, as JAX's kernel does, with no width table
or limit left in the source or the wrapper; a tensor off the CPU at any
width reaches the kernels' device check; the CPU's plain version equals
the JAX package's kernel at widths on both sides of 256; the kernels take
heads of 32 only (a deliberate difference, ROADMAP.md section 3); and the
persistent grid's plan.  The card tests beside these are
tests/test_torch_cuda.py::test_attention_kernels_match_plain,
::test_attention_one_pass_matches_plain (C = 20, 40, 320, 512 and 1024
among their cases) and ::test_attention_width_on_card."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dddpm_tpu.ops.pallas import attention_block as jab
from dddpm_tpu_torch.ops import attention_block as tab

HIDDEN = 128
SOURCE = (pathlib.Path(tab.__file__).resolve().parents[1] / "csrc"
          / "attention_block.cu")


def _inputs(seed, bsz, n, c):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(bsz, n, c), 1.0 + 0.1 * f(c), 0.1 * f(c),
            f(c, 3 * HIDDEN) / np.sqrt(c), f(HIDDEN, c) / np.sqrt(HIDDEN),
            0.1 * f(c))


def _refuse(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel entry was called")

    for entry in ("attention_ctx", "attention_out", "attention_1pass"):
        monkeypatch.setattr(tab, entry, refuse)


def test_the_source_has_no_width_table_or_limit():
    """No list of instantiated widths and no width refusal is left: not in
    csrc/attention_block.cu (no DDDPM_WIDTHS, no C % 32 or C > 256 test
    in the C entries) and not in the wrapper (no fused_width_ok or
    MAX_WIDTH)."""
    text = SOURCE.read_text()
    assert "DDDPM_WIDTHS" not in text
    entries = text[text.index('extern "C" {'):]
    for refusal in ("C % 32", "C > 256", "C > NS) return (int)cudaError"):
        assert refusal not in entries, refusal
    assert not hasattr(tab, "fused_width_ok")
    assert not hasattr(tab, "MAX_WIDTH")


@pytest.mark.parametrize("c", [40, 160, 320, 512])
@pytest.mark.parametrize("one_pass", [False, True])
def test_the_cpu_plain_path_matches_jax_at_any_width(monkeypatch, c, one_pass):
    """A CPU tensor at N = 520 (just above the plain-path token gate), B =
    1, runs the plain version at widths below and above 256 and not a
    multiple of 32 (40), calls no kernel entry (they are patched to raise)
    whichever route FORCE_ONE_PASS picks, and equals the JAX package's
    fused kernel (interpret mode), which takes every width."""
    args = _inputs(c, 1, 520, c)
    _refuse(monkeypatch)
    monkeypatch.setattr(tab, "FORCE_ONE_PASS", one_pass)
    got = tab.attention_block(*map(torch.from_numpy, args), 32)
    want = tab.reference_impl(*map(torch.from_numpy, args), 32)
    assert torch.equal(got, want)
    jax_fused = jab.attention_block(*map(jnp.asarray, args), 32, True)
    # f32 both sides; the JAX kernel sums exp(k) unshifted and tiles the
    # token sums, the plain version shifts by the max
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_fused), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("c", [320, 40])
@pytest.mark.parametrize("one_pass", [False, True])
def test_any_width_reaches_the_device_check_off_the_cpu(monkeypatch, c, one_pass):
    """Off the CPU there is no plain route and no width refusal: a (meta)
    tensor of 320 or 40 channels above the token gate reaches the kernels'
    check, which refuses it for its device alone, on either route."""
    monkeypatch.setattr(tab, "FORCE_ONE_PASS", one_pass)
    args = [torch.from_numpy(a).to("meta") for a in _inputs(0, 1, 1024, c)]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor, got meta"):
        tab.attention_block(*args, 32)


@pytest.mark.parametrize("c", [20, 40, 96, 288, 320, 512, 1024])
def test_the_kernels_check_passes_every_width(c):
    """_check has no width test: at every width it fails only on the
    device (a CPU tensor here), for both passes and the one-pass kernel."""
    x = torch.zeros(1, 1024, c)
    g = torch.ones(c)
    z = lambda *s: torch.zeros(*s)
    for call in (lambda: tab.attention_ctx(x, g, g, z(c, 2 * HIDDEN)),
                 lambda: tab.attention_out(x, g, g, z(1, c, c), g),
                 lambda: tab.attention_1pass(x, g, g, z(c, 2 * HIDDEN),
                                             z(c, HIDDEN), z(HIDDEN, c), g)):
        with pytest.raises(ValueError, match="CUDA tensor, got cpu"):
            call()


@pytest.mark.parametrize("dim_head,hidden", [(16, 128), (32, 64)])
def test_the_kernels_take_heads_of_32_only(dim_head, hidden):
    """The deliberate difference of ROADMAP.md section 3: the kernels form
    4 heads of 32 (every UNet of the repo builds that shape), where JAX's
    function takes any dim_head; off the CPU another shape raises before
    any kernel, on the CPU the plain version takes it."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    args = (f(1, 1024, 64), f(64), f(64), f(64, 3 * hidden), f(hidden, 64), f(64))
    with pytest.raises(ValueError, match=f"heads of {tab.DIM_HEAD}"):
        tab.attention_block(*(a.to("meta") for a in args), dim_head)
    out = tab.attention_block(*args, dim_head)
    assert torch.equal(out, tab.reference_impl(*args, dim_head))


@pytest.mark.parametrize("bsz,ntiles,slots", [(8, 256, 132), (8, 256, 264),
                                              (32, 16, 132), (192, 256, 132),
                                              (192, 64, 264), (1, 17, 132)])
def test_plan_keeps_the_busiest_block_near_the_least_span(bsz, ntiles, slots):
    """The persistent grid's plan: the busiest block's tiles (items dealt
    out in turn) within 5% of the least any chunking gives, and no
    chunking with fewer chunks does as well."""
    def span(tpc):
        return -(-bsz * -(-ntiles // tpc) // slots) * tpc

    nchunks, tpc = tab.plan(bsz, ntiles, slots)
    assert nchunks == -(-ntiles // tpc) and 1 <= tpc <= ntiles
    least = min(span(t) for t in range(1, ntiles + 1))
    assert span(tpc) <= 1.05 * least
    assert all(span(t) > 1.05 * least for t in range(tpc + 1, ntiles + 1)
               if -(-ntiles // t) < nchunks)


def test_plan_of_the_main_paths():
    """The x2 chain's 128^2 site (B = 8, 256 tiles) on 132 blocks: 16
    chunks of 16 tiles, a block each; the bulk sampler's (B = 192): two
    chunks a sample, not a chunk a tile (a partial each)."""
    assert tab.plan(8, 256, 132) == (16, 16)
    assert tab.plan(192, 256, 132) == (2, 130)
