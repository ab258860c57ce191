"""Kernels: K1a + K1b's least time at the UNet's kernel attention sites
(frozen costs) over their device time in the traced steps (%)."""
from benchmark.harness.readers import k1_least_s, roofline


def read(run):
    least = k1_least_s(run)
    return None if least is None else roofline(
        run, ("K1a attn_ctx", "K1b attn_out"), least)
