"""Frechet distance statistics (FID / sFID) and the inception score
(port of dddpm_tpu/evaluation/fid.py).

mu / sigma over activation batches, the Frechet distance via scipy's
sqrtm with the eps-offset retry for singular products (the canonical
TTUR / OpenAI FID code).  Host float64 numpy: O(d^3) LAPACK work.
"""
from __future__ import annotations

import inspect
import warnings

import numpy as np
from scipy import linalg

# scipy < 1.18 returns (sqrtm, error estimate) and prints a warning
# unless disp=False; 1.18 dropped the argument and returns sqrtm alone
_SQRTM_DISP = "disp" in inspect.signature(linalg.sqrtm).parameters


def _sqrtm(m: np.ndarray) -> np.ndarray:
    return linalg.sqrtm(m, disp=False)[0] if _SQRTM_DISP else linalg.sqrtm(m)


class FIDStatistics:
    """Gaussian fit (mu, sigma) to a set of activations."""

    def __init__(self, mu: np.ndarray, sigma: np.ndarray):
        self.mu = mu
        self.sigma = sigma

    @classmethod
    def from_activations(cls, acts: np.ndarray) -> "FIDStatistics":
        if acts.ndim != 2:
            raise ValueError(f"expected (N, D) activations, got {acts.shape}")
        return cls(np.mean(acts, axis=0), np.cov(acts, rowvar=False))

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6) -> float:
        """d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))."""
        mu1, mu2 = np.atleast_1d(self.mu), np.atleast_1d(other.mu)
        sigma1, sigma2 = np.atleast_2d(self.sigma), np.atleast_2d(other.sigma)
        if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
            raise ValueError("statistics of different dimensions")

        diff = mu1 - mu2
        covmean = _sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            warnings.warn(
                f"covariance product is singular; retrying sqrtm with {eps} "
                "added to the diagonal of both covariance estimates")
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))

        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                m = np.max(np.abs(covmean.imag))
                raise ValueError(f"Imaginary component {m}")
            covmean = covmean.real

        return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                     - 2 * np.trace(covmean))


def compute_fid(acts1: np.ndarray, acts2: np.ndarray) -> float:
    return FIDStatistics.from_activations(acts1).frechet_distance(
        FIDStatistics.from_activations(acts2))


def compute_inception_score(softmax_out: np.ndarray,
                            split_size: int = 5000) -> float:
    """Split-KL inception score (reference evaluator.py:133-146)."""
    softmax_out = np.asarray(softmax_out)
    scores = []
    for i in range(0, len(softmax_out), split_size):
        part = softmax_out[i:i + split_size]
        kl = part * (np.log(part) - np.log(np.expand_dims(np.mean(part, 0), 0)))
        scores.append(np.exp(np.mean(np.sum(kl, 1))))
    return float(np.mean(scores))
