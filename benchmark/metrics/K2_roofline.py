"""Kernels: K2's least time at the shapes launched in the traced steps
(frozen costs: the full-batch downsample and the recon rows' passes)
over its device time (%)."""
from benchmark.harness.readers import convres_least_s, roofline


def read(run):
    least = convres_least_s(run, backward=False)
    return None if least is None else roofline(run, ("K2 convres",), least)
