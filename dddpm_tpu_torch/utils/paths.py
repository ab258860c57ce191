"""Artifact directories (port of dddpm_tpu/utils/paths.py).

Every directory is env-overridable with a repo-local default.  The data
root defaults to ./data, the port's --data-root default (the JAX
package's is ../data).  Every entry of the port and the trainer take
their defaults from here: train_main, resume_main, evaluate_main and
ref_batch_main read DATA_DIR, the trainer writes its checkpoints and
logs under CHECKPOINT_DIR and LOGGING_DIR unless given a workdir, and
generate_main and ref_batch_main write under the sample and reference
directories.
"""
from __future__ import annotations

import os

_ROOT = os.environ.get("DDDPM_WORK_DIR", "./results")

WORK_DIR = _ROOT
SAMPLE_DIR = os.environ.get("DDDPM_SAMPLE_DIR", os.path.join(_ROOT, "samples"))
SAMPLE_LATENT_DIR = os.environ.get(
    "DDDPM_SAMPLE_LATENT_DIR", os.path.join(_ROOT, "samples_latent"))
CHECKPOINT_DIR = os.environ.get(
    "DDDPM_CHECKPOINT_DIR", os.path.join(_ROOT, "checkpoints"))
REFERENCE_DIR = os.environ.get(
    "DDDPM_REFERENCE_DIR", os.path.join(_ROOT, "reference"))
LOGGING_DIR = os.environ.get(
    "DDDPM_LOGGING_DIR", os.path.join(_ROOT, "logging"))
DATA_DIR = os.environ.get("DDDPM_DATA_DIR", "./data/")
