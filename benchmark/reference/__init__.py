"""Plain PyTorch reference of the benchmarked model, float32 by default.

Nothing here imports jax, the JAX package or dddpm_tpu_torch: the
reference is written from the published model's equations and takes
only what the benchmark hands it (weights drawn from the seed, inputs,
and the program's outputs to judge).
"""
