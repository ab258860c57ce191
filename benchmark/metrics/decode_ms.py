"""Bulk sampler: one rescaled_upsample + fix_samples of the batch, host
clock closed by a synchronize (ms)."""


def read(run):
    return None if run.decode_s is None else run.decode_s * 1e3
