"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference works out, and the verdict against a
cell's limits.

Sampling (per checked chain step, and the decode):

- step_gap: |x_prog - x_ref| over the batch, divided by
  coef_x0(t) * sqrt(1/ab_t - 1) * |eps_ref| taken over the elements
  whose x0 estimate the clip leaves alone.  Elsewhere the step does not
  depend on eps, so this is the relative error of the eps the program's
  step used where it mattered, plus any error of the posterior math.
- decode_gap: |fixed_prog - fixed_ref| / |fixed_ref - its image means|
  over the fixed samples (0..255), the reference decoding the program's
  final latent.

Training (over the first optimizer steps; a leaf is one parameter
tensor):

- loss_gap: the largest |L_prog - L_ref| / |L_ref| over the steps.
- grad_gap: over leaves, the largest | |g_prog| - |g_ref| | of the first
  step's clipped gradient, divided by the larger of |g_ref| of that leaf
  and of the median leaf.
- change_gap: the same, of each leaf's change (parameters and EMA) over
  the steps, leaving out the leaves whose first reference gradient is
  under a thousandth of the median leaf's (they move by round-off).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch


def fix(x: torch.Tensor) -> torch.Tensor:
    """Per-image min-max to [0, 255], float32."""
    flat = x.float().reshape(x.shape[0], -1)
    lo = flat.amin(1).reshape(-1, *[1] * (x.ndim - 1))
    hi = flat.amax(1).reshape(-1, *[1] * (x.ndim - 1))
    return (x.float() - lo) / (hi - lo) * 255.0


def step_gap(x_prog, x_ref, eps_ref, inside, weight: float) -> float:
    num = float((x_prog.float() - x_ref).square().sum().sqrt())
    den = weight * float((eps_ref * inside).square().sum().sqrt())
    return num / den if den > 0 else float("inf")


def decode_gap(fixed_prog: np.ndarray, fixed_ref: torch.Tensor) -> float:
    ref = fixed_ref.double().cpu()
    prog = torch.from_numpy(np.asarray(fixed_prog)).double()
    if prog.shape != ref.shape:
        return float("inf")
    centred = ref - ref.reshape(ref.shape[0], -1).mean(1).reshape(
        -1, *[1] * (ref.ndim - 1))
    return float((prog - ref).norm() / centred.norm())


def leaf_gaps(prog: List[float], ref: List[float], keep: List[bool]) -> List[float]:
    """Each kept leaf's | |prog| - |ref| | over the larger of |ref| and the
    median leaf's |ref|."""
    if len(prog) != len(ref):
        return [float("inf")]
    med = statistics.median(ref)
    return [abs(p - r) / max(r, med, 1e-30)
            for p, r, k in zip(prog, ref, keep) if k] or [float("inf")]


TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
                 "change_gap_median")


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The training numbers (TRAIN_NUMBERS) from two readings of
    train_readings' form (the program's from its optimizer state, see
    the train job)."""
    if len(prog["losses"]) != len(ref["losses"]):
        return dict.fromkeys(TRAIN_NUMBERS, float("inf"))
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref)
    moving = [g >= 1e-3 * med for g in g_ref]
    grad = leaf_gaps(prog["grad_norms"], g_ref, [True] * len(g_ref))
    change = leaf_gaps(prog["change_norms"], ref["change_norms"],
                       moving + moving)
    return {"loss_gap": loss, "grad_gap": max(grad), "change_gap": max(change),
            "grad_gap_median": statistics.median(grad),
            "change_gap_median": statistics.median(change)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} and whether every number is within its
    limit (a number that is missing or not finite fails)."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"checks": checks, "correct": bool(ok),
            "failed": sum(not (np.isfinite(c["value"]) and c["value"] <= c["limit"])
                          for c in checks.values())}
