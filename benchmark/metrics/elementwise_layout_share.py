"""Networks: % of the device's busy time in elementwise and layout-copy
kernels (kernel names sorted by harness/trace.py's categories)."""
from benchmark.harness.readers import share


def read(run):
    return share(run, ("elementwise", "layout copy"))
