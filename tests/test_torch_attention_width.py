"""The attention block's channel widths (dddpm_tpu_torch/ops/attention_block.py:
fused_width_ok): the kernels take every C % 32 == 0 up to 256, a wider
tensor off the CPU raises, and the CPU's plain version equals the JAX
package's kernel at those widths and beyond.  The card tests beside
these are tests/test_torch_cuda.py::test_attention_kernels_match_plain,
::test_attention_one_pass_matches_plain (the widths 96-224 among their
cases) and ::test_attention_width_on_card."""
import pathlib
import re

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


def test_the_source_instantiates_every_width_the_gate_passes():
    """Pass B and the one-pass kernel are instantiated for C = 32 * NC over
    the NC that DDDPM_WIDTHS lists: exactly the widths fused_width_ok
    passes, so no width the wrapper lets through meets a missing case."""
    text = SOURCE.read_text()
    line = re.search(r"#define DDDPM_WIDTHS\(X\)(.*)", text).group(1)
    built = {32 * int(nc) for nc in re.findall(r"X\((\d+)\)", line)}
    passed = {c for c in range(1, 1025) if tab.fused_width_ok(c)}
    assert built == passed == set(range(32, 257, 32))
    for switch in ("DDDPM_OUT", "DDDPM_RESIDENT", "DDDPM_CASE_1P"):
        assert f"DDDPM_WIDTHS({switch})" in text, switch


@pytest.mark.parametrize("c", [160, 320])
@pytest.mark.parametrize("one_pass", [False, True])
def test_the_cpu_plain_path_matches_jax_at_any_width(monkeypatch, c, one_pass):
    """A CPU tensor at N = 1024 (above the plain-path token gate) runs the
    plain version at a width the kernels take (160) and one they do not
    (320), calls no kernel entry (they are patched to raise) whichever
    route FORCE_ONE_PASS picks, and equals the JAX package's fused kernel
    (interpret mode), which takes every width."""
    args = _inputs(c, 1, 1024, c)
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


@pytest.mark.parametrize("one_pass", [False, True])
def test_a_width_the_kernels_do_not_take_raises_off_the_cpu(monkeypatch,
                                                           one_pass):
    """Off the CPU there is no plain route for a width: a (meta) tensor of
    320 channels above the token gate reaches the kernels' check, which
    refuses it, on either route."""
    monkeypatch.setattr(tab, "FORCE_ONE_PASS", one_pass)
    args = [torch.from_numpy(a).to("meta") for a in _inputs(0, 1, 1024, 320)]
    with torch.no_grad(), pytest.raises(ValueError, match="channel width 320"):
        tab.attention_block(*args, 32)


@pytest.mark.parametrize("c", [96, 128, 160, 256, 288, 320])
def test_the_gate_and_the_kernels_check_agree(c):
    """_check refuses a width exactly when fused_width_ok does (it reads
    the width before the device, so a CPU tensor shows it)."""
    x = torch.zeros(1, 1024, c)
    g = torch.ones(c)
    w_kv = torch.zeros(c, 2 * HIDDEN)
    match = "CUDA" if tab.fused_width_ok(c) else "channel width"
    with pytest.raises(ValueError, match=match):
        tab.attention_ctx(x, g, g, w_kv)
    assert tab.fused_width_ok(c) is (c <= 256)
