"""Eval helpers (port of dddpm_tpu/evaluation/helpers.py).

- generator_batches: eval-transformed loader -> [0, 255] NHWC numpy;
- compute_test_losses: mean full-chain VLB (bits/dim) and mean L_simple
  over a test loader, batch i keyed fold_seed(seed, i).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from dddpm_tpu_torch.models.ddpm import fold_seed


def generator_batches(loader) -> Iterator[np.ndarray]:
    """Yield [0, 255] NHWC numpy batches from a [0, 1] eval loader."""
    for batch in loader:
        x = batch[0] if isinstance(batch, tuple) else batch
        yield np.asarray(x, np.float32) * 255.0


def compute_test_losses(process, seed: int, test_loader,
                        max_batches: Optional[int] = None
                        ) -> Tuple[float, float]:
    """Mean full-chain VLB over the test images and the mean over
    batches of the summed L_simple; the results are read once, after the
    last batch."""
    vlbs, l_simples = [], []
    for i, (x, _) in enumerate(test_loader):
        if max_batches is not None and i >= max_batches:
            break
        out = process.test_losses(
            torch.as_tensor(x).to(process.device), seed=fold_seed(seed, i))
        vlbs.append(out["vlb"])
        l_simples.append(out["L_simple"])
    vlb = float(torch.cat(vlbs).double().mean())
    l_simple = float(torch.stack(l_simples).double().mean())
    return vlb, l_simple
