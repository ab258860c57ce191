"""The end-to-end sample evaluator: FID, sFID, IS, precision, recall
(port of dddpm_tpu/evaluation/evaluator.py), on one device.

Activations come from the InceptionV3 extractor in batches; statistics
and the Frechet distance stay host float64; precision / recall run as
pairwise-distance tiles on the device.  Takes the reference's npy
artifact format: (n_batches, B, H, W, C) or (N, H, W, C), values in
[0, 255].  With a mesh the Inception pass is split over the ranks
(evaluation/inception.py) and every rank computes the same metrics.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np

from dddpm_tpu_torch.evaluation.fid import (
    FIDStatistics,
    compute_inception_score,
)
from dddpm_tpu_torch.evaluation.inception import FeatureExtractor
from dddpm_tpu_torch.evaluation.prec_recall import compute_prec_recall
from dddpm_tpu_torch.utils.device import DeviceLike


def require_inception_optin(weights_npz: Optional[str], allow_random: bool,
                            prog: str) -> None:
    """Refuse to produce metrics from a random-init Inception unless the
    caller opted in explicitly.

    Without real weights the extractor is deterministic-random-init: the
    metric machinery is exact but the absolute numbers are meaningless,
    so a bare CLI run must not print something a user could mistake for
    real FID.  Called before any model is built, so refusal is instant.
    """
    if weights_npz or os.environ.get("INCEPTION_WEIGHTS_NPZ"):
        return
    if allow_random:
        return
    sys.exit(
        f"{prog}: no real InceptionV3 weights available — refusing to "
        "print FID/sFID/IS/precision/recall from a random-init extractor "
        "(the numbers would not be comparable to anything). Pass "
        "--inception-weights <npz> (export one with "
        "scripts/setup_real_inception.py) or set INCEPTION_WEIGHTS_NPZ; "
        "to exercise the metric machinery anyway, opt in with "
        "--allow-random-inception.")


def flatten_batches(arr: np.ndarray) -> np.ndarray:
    """(n_batches, B, H, W, C) -> (N, H, W, C); passthrough for 4-D."""
    arr = np.asarray(arr)
    if arr.ndim == 5:
        arr = arr.reshape(-1, *arr.shape[2:])
    if arr.ndim != 4:
        raise ValueError(f"expected image batch array, got {arr.shape}")
    return arr


class Evaluator:
    """Computes all sample-quality metrics against a reference batch."""

    def __init__(self, weights_npz: Optional[str] = None, batch_size: int = 64,
                 device: DeviceLike = None, mesh=None):
        self.extractor = FeatureExtractor(weights_npz, batch_size, device,
                                          mesh)

    def read_activations(self, images) -> Dict[str, np.ndarray]:
        """images: array, or .npy/.npz path (streamed in bounded memory)."""
        if isinstance(images, (str, os.PathLike)):
            return self.extractor(images)
        return self.extractor(flatten_batches(images))

    def compute_statistics(self, acts: Dict[str, np.ndarray]):
        return (FIDStatistics.from_activations(acts["pool3"]),
                FIDStatistics.from_activations(acts["spatial"]))

    def evaluate(self, reference, samples,
                 prec_recall_subset: Optional[int] = None) -> Dict[str, float]:
        """prec_recall_subset: None (default) runs the manifold estimate
        on the full feature sets, as the reference's ManifoldEstimator
        does; an int subsamples (faster, not reference-comparable)."""
        ref_acts = self.read_activations(reference)
        sample_acts = self.read_activations(samples)

        ref_stats, ref_stats_spatial = self.compute_statistics(ref_acts)
        stats, stats_spatial = self.compute_statistics(sample_acts)

        prec, recall = compute_prec_recall(
            ref_acts["pool3"][:prec_recall_subset],
            sample_acts["pool3"][:prec_recall_subset],
            device=self.extractor.device)
        return {
            "is": compute_inception_score(sample_acts["softmax"]),
            "fid": stats.frechet_distance(ref_stats),
            "sfid": stats_spatial.frechet_distance(ref_stats_spatial),
            "precision": prec,
            "recall": recall,
            "inception_weights": ("real" if self.extractor.has_real_weights
                                  else "random-init"),
        }
