"""Kernels: Q1's least time at the int8 mode's convs (frozen costs, the
s8 peak) over its device time in the traced steps (%)."""
from benchmark.harness.readers import q1_least_s, roofline


def read(run):
    least = q1_least_s(run)
    return None if least is None else roofline(run, ("Q1 int8_conv",), least)
