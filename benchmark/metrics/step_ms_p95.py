"""Trainer: the 95th percentile of the untraced window's step times,
each step closed by a synchronize (ms)."""
from benchmark.harness.readers import p95_ms


def read(run):
    return p95_ms(run.step_times)
