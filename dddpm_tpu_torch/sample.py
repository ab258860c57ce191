"""Bulk sampling for FID (port of dddpm_tpu/sample.py).

generate_samples draws ceil(fid_samples / batch_size) batches; batch i
uses seed fold_seed(seed, i).  The output arrays are (n_batches, B, H,
W, C) float32 in [0, 255], NHWC.  That is the JAX package's layout and
dtype at float32 configs only: under compute_dtype bfloat16 its
fix_samples returns bfloat16 (saved as a '<V2' npy that np.load cannot
read back as numbers), where the port keeps float32 at every config.

On a mesh (parallel/mesh.py) batch_size is the global batch and each
rank runs its B / N rows of it: the start latent and every step's noise
are the global batch's draws (step_noise(seed, key, global shape)) with
the rank's rows taken, so each row is the one a single process draws.
The fixed samples, and dDDPM's latents, are all-gathered: every rank
returns the arrays one process returns.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dddpm_tpu_torch.models.ddpm import INIT_KEY, fold_seed, step_noise
from dddpm_tpu_torch.models.dddpm import DownsampleDiffusion
from dddpm_tpu_torch.ops.math import min_max_norm_image
from dddpm_tpu_torch.parallel.mesh import all_gather_rows, batch_sharding


def fix_samples(samples: torch.Tensor, mesh=None) -> np.ndarray:
    """Per-image min-max -> x255, NHWC float32 numpy; on a mesh, of the
    global batch gathered from every rank's rows."""
    fixed = min_max_norm_image(samples.float()) * 255.0
    return all_gather_rows(fixed, mesh).cpu().numpy()


def make_bulk_sampler(process, batch_size: int,
                      early_stop: Optional[int] = None,
                      ddim_steps: Optional[int] = None,
                      ddim_eta: float = 0.0, mesh=None) -> Callable:
    """sampler(seed) -> (x, z) for dDDPM, x for plain DDPM: on a mesh,
    this rank's rows of the global batch.  ddim_steps selects the
    strided DDIM sampler instead of the ancestral chain."""
    rows = batch_sharding(mesh, batch_size)
    shape = (batch_size, *process.sample_shape)

    @torch.no_grad()
    def sampler(seed: int):
        def draw(key: int) -> torch.Tensor:
            return step_noise(seed, key, shape, process.device)[rows]

        if ddim_steps is not None:
            z = process.ddim_sample_chain(draw(INIT_KEY),
                                          process.ddim_taus(ddim_steps),
                                          ddim_eta, seed, noise=draw)
        else:
            z = process.p_sample_chain(draw(INIT_KEY),
                                       process.chain_ts(early_stop), seed,
                                       noise=draw)
        if isinstance(process, DownsampleDiffusion):
            return process.rescaled_upsample(z), z
        return z
    return sampler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_samples(process, seed: int = 0, fid_samples: int = 50000,
                     batch_size: int = 192, early_stop: Optional[int] = None,
                     ddim_steps: Optional[int] = None, ddim_eta: float = 0.0,
                     progress: bool = True, mesh=None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[str, float]]:
    """Generate >= fid_samples images; returns (samples, latents, timing),
    timing in global images."""
    sampler = make_bulk_sampler(process, batch_size, early_stop, ddim_steps,
                                ddim_eta, mesh)
    is_downsampled = isinstance(process, DownsampleDiffusion)
    n_batches = int(np.ceil(fid_samples / batch_size))

    sample_list, latent_list = [], []
    _sync(process.device)
    start = time.time()
    for i in range(n_batches):
        out = sampler(fold_seed(seed, i))
        if is_downsampled:
            sample_list.append(fix_samples(out[0], mesh))
            latent_list.append(fix_samples(out[1], mesh))
        else:
            sample_list.append(fix_samples(out, mesh))
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
