"""Improved precision and recall by kNN manifolds (port of
dddpm_tpu/evaluation/prec_recall.py; Kynkaenniemi et al.).

The features live on the run's device.  Each pairwise-distance tile is
|a|^2 - 2ab + |b|^2 with ab one torch.matmul in full float32: that form
cancels badly, so TF32 is off inside the product whatever the global
flag says (JAX pins Precision.HIGHEST for the same reason).  A row
block's k+1 smallest distances are merged tile by tile on the device
(torch.topk), so 50k x 50k never round-trips a tile through the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dddpm_tpu_torch.utils.device import DeviceLike, full_f32, resolve_device


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between the rows of a and of b, float32."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(dim=1, keepdim=True)
    b2 = (b * b).sum(dim=1, keepdim=True)
    with full_f32():
        ab = torch.matmul(a, b.T)
    return torch.clamp(a2 - 2.0 * ab + b2.T, min=0.0)


class ManifoldEstimator:
    """kNN-radius manifold of a feature set; membership tests for probes."""

    def __init__(self, features: np.ndarray, nhood_size: int = 3,
                 row_batch: int = 2048, col_batch: int = 2048,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.features = torch.as_tensor(
            np.ascontiguousarray(features, np.float32), device=self.device)
        self.nhood_size = nhood_size
        self.row_batch = row_batch
        self.col_batch = col_batch
        self._radii = self._compute_radii()
        self.radii = self._radii.cpu().numpy()

    def _compute_radii(self) -> torch.Tensor:
        n, k = len(self.features), self.nhood_size
        radii = torch.empty(n, dtype=torch.float32, device=self.device)
        for r0 in range(0, n, self.row_batch):
            rows = self.features[r0:r0 + self.row_batch]
            # the k+1 smallest over all columns, merged tile by tile
            best = torch.full((len(rows), k + 1), float("inf"),
                              device=self.device)
            for c0 in range(0, n, self.col_batch):
                d = pairwise_sq_dists(rows, self.features[c0:c0 + self.col_batch])
                best = torch.topk(torch.cat([best, d], dim=1), k + 1, dim=1,
                                  largest=False, sorted=True).values
            # the k-th neighbour excluding self (distance 0 is the point)
            radii[r0:r0 + len(rows)] = best[:, k]
        return radii

    def evaluate(self, probes: np.ndarray) -> np.ndarray:
        """1 if a probe falls inside any manifold hypersphere."""
        probes = torch.as_tensor(np.ascontiguousarray(probes, np.float32),
                                 device=self.device)
        out = torch.zeros(len(probes), dtype=torch.int32, device=self.device)
        for r0 in range(0, len(probes), self.row_batch):
            rows = probes[r0:r0 + self.row_batch]
            hit = torch.zeros(len(rows), dtype=torch.bool, device=self.device)
            for c0 in range(0, len(self.features), self.col_batch):
                d = pairwise_sq_dists(rows, self.features[c0:c0 + self.col_batch])
                hit |= (d <= self._radii[None, c0:c0 + self.col_batch]).any(dim=1)
            out[r0:r0 + len(rows)] = hit.int()
        return out.cpu().numpy()


def compute_prec_recall(real_features: np.ndarray, fake_features: np.ndarray,
                        nhood_size: int = 3, device: DeviceLike = None
                        ) -> Tuple[float, float]:
    """precision = frac(fake in real manifold); recall = frac(real in fake)."""
    real_m = ManifoldEstimator(real_features, nhood_size, device=device)
    fake_m = ManifoldEstimator(fake_features, nhood_size, device=device)
    precision = real_m.evaluate(fake_features).mean()
    recall = fake_m.evaluate(real_features).mean()
    return float(precision), float(recall)
