"""Tiny cells for the CPU tests: each benchmark cell with its
configuration cut to a few channels and 32^2 images, its traffic to a
few rows, and its real limits.  The program runs its plain PyTorch path
on the CPU, in bfloat16 as on the card."""
from __future__ import annotations

from benchmark.harness import spec

SHRINK = {"image_size": 32, "unet_chan": 16, "unet_dims": [1, 2],
          "d_chans": 16}
# the int8 mode gates convs of 128 channels or more; its calibration
# runs a whole chain, so T is cut too
SHRINK_INT8 = dict(SHRINK, unet_chan=128, T=100)
TRAFFIC = {"sample": {"batch_size": 4, "min_steps": 6, "segment_steps": 2,
                      "reference_rows": 2},
           "train": {"batch_size": 4, "reference_rows": 3,
                     "recon_rows": [1, 0, 2, 3]}}


def cell(name: str) -> spec.Cell:
    real = spec.load(name)
    return spec.Cell(f"tiny_{name}", 1, dict(real.config, **SHRINK),
                     dict(real.traffic, **TRAFFIC[real.traffic["job"]]),
                     real.limits, real.end_to_end, real.per_layer)


def int8_cell() -> spec.Cell:
    """The int8 mode's cell, with the int8 mode's own cuts."""
    real = spec.load("x2int8_sample_b192")
    return spec.Cell("tiny_x2int8_sample_b192", 1,
                     dict(real.config, **SHRINK_INT8),
                     dict(real.traffic, **TRAFFIC["sample"]), real.limits,
                     real.end_to_end, real.per_layer)
