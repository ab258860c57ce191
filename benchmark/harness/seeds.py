"""Everything a run draws comes from (--seed, a key): splitmix64 of the
pair, so a seed of any size gives its own independent streams."""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1

# keys of the streams a run draws (chain steps and train steps use their
# own index as the key, at or above 0)
WEIGHTS, START, CHECKS, ORDER, CALIB = -1, -2, -3, -4, -5


def mix(seed: int, *keys: int) -> int:
    """A 63-bit generator seed for (seed, *keys)."""
    z = seed & _MASK64
    for key in keys:
        z = (z * 0x9E3779B97F4A7C15 + (key + 1) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 31)) * 0x94D049BB133111EB) & _MASK64
        z = z ^ (z >> 29)
    return z & ((1 << 63) - 1)


def generator(device, seed: int, *keys: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, *keys))
    return gen
