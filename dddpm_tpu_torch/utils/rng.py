"""Deterministic seeding (port of dddpm_tpu/utils/rng.py).

The port's draws are keyed explicitly (fold_seed in models/ddpm.py); the
global generators that remain (python, numpy, torch's) are seeded here;
train_step reseeds torch's at each step for its dropout masks."""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch


def seed_everything(seed: Optional[int]) -> int:
    """Seeds python, numpy and torch; returns the run's base seed.  With
    seed None nothing is seeded and a fresh base seed is returned."""
    if seed is None:
        return int(np.random.SeedSequence().entropy % (2 ** 31))
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
