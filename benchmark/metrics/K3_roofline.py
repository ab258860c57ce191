"""Kernels: K3's least time at the shapes launched in the traced steps
(frozen costs, the recon rows drawn) over its device time (%)."""
from benchmark.harness.readers import convres_least_s, roofline


def read(run):
    least = convres_least_s(run, backward=True)
    return None if least is None else roofline(run, ("K3 convres_bwd",), least)
