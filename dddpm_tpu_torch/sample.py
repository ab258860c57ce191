"""Bulk sampling for FID (port of dddpm_tpu/sample.py), one device.

generate_samples draws ceil(fid_samples / batch_size) batches; batch i
uses seed fold_seed(seed, i).  The output arrays are (n_batches, B, H,
W, C) float32 in [0, 255], NHWC.  That is the JAX package's layout and
dtype at float32 configs only: under compute_dtype bfloat16 its
fix_samples returns bfloat16 (saved as a '<V2' npy that np.load cannot
read back as numbers), where the port keeps float32 at every config.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dddpm_tpu_torch.models.ddpm import fold_seed
from dddpm_tpu_torch.models.dddpm import DownsampleDiffusion
from dddpm_tpu_torch.ops.math import min_max_norm_image


def fix_samples(samples: torch.Tensor) -> np.ndarray:
    """Per-image min-max -> x255, NHWC float32 numpy."""
    return (min_max_norm_image(samples.float()) * 255.0).cpu().numpy()


def make_bulk_sampler(process, batch_size: int,
                      early_stop: Optional[int] = None,
                      ddim_steps: Optional[int] = None,
                      ddim_eta: float = 0.0) -> Callable:
    """sampler(seed) -> (x, z) for dDDPM, x for plain DDPM.  ddim_steps
    selects the strided DDIM sampler instead of the ancestral chain."""
    def sampler(seed: int):
        if ddim_steps is not None:
            return process.ddim_sample(batch_size, seed=seed,
                                       num_steps=ddim_steps, eta=ddim_eta)
        return process.sample(batch_size, seed=seed, early_stop=early_stop)
    return sampler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_samples(process, seed: int = 0, fid_samples: int = 50000,
                     batch_size: int = 192, early_stop: Optional[int] = None,
                     ddim_steps: Optional[int] = None, ddim_eta: float = 0.0,
                     progress: bool = True
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[str, float]]:
    """Generate >= fid_samples images; returns (samples, latents, timing)."""
    sampler = make_bulk_sampler(process, batch_size, early_stop, ddim_steps,
                                ddim_eta)
    is_downsampled = isinstance(process, DownsampleDiffusion)
    n_batches = int(np.ceil(fid_samples / batch_size))

    sample_list, latent_list = [], []
    _sync(process.device)
    start = time.time()
    for i in range(n_batches):
        out = sampler(fold_seed(seed, i))
        if is_downsampled:
            sample_list.append(fix_samples(out[0]))
            latent_list.append(fix_samples(out[1]))
        else:
            sample_list.append(fix_samples(out))
        if progress:
            print(f"sampling batch {i + 1}/{n_batches}", flush=True)
    total = time.time() - start

    timing = {
        "total_s": total,
        "per_sample_s": total / fid_samples,
        "per_batch_s": total / n_batches,
        "imgs_per_sec": (n_batches * batch_size) / total,
    }
    latents = np.stack(latent_list) if latent_list else None
    return np.stack(sample_list), latents, timing
