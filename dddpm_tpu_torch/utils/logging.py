"""Run logging (port of dddpm_tpu/utils/logging.py): scalar metrics to a
JSONL file and image grids to PNGs, under the run's own directory.
wandb is mirrored when it is importable and the run is not muted."""
from __future__ import annotations

import json
import os
import uuid
from typing import Dict, Optional

import numpy as np

from dddpm_tpu_torch.utils.images import save_image_grid


def generate_run_id() -> str:
    return uuid.uuid4().hex[:8]


class RunLogger:
    """JSONL metrics logger with optional wandb mirroring."""

    def __init__(self, project: str, config: Dict, log_dir: str,
                 run_id: Optional[str] = None, mute: bool = False):
        self.run_id = run_id or generate_run_id()
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.metrics_path = os.path.join(
            log_dir, f"metrics_{config.get('model', 'run')}_{self.run_id}.jsonl")
        self._file = open(self.metrics_path, "a")
        self._wandb = None
        if not mute:
            try:  # pragma: no cover - wandb is optional
                import wandb

                wandb.init(project=project, config=config, resume="allow",
                           id=self.run_id)
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: int):
        row = {"step": int(step)}
        row.update({k: float(np.asarray(v)) for k, v in metrics.items()})
        self._file.write(json.dumps(row) + "\n")
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(row, step=step)

    def log_images(self, images: Dict[str, np.ndarray], step: int,
                   nrow: int = 5):
        """Save image grids as PNGs named like the reference's wandb keys."""
        for name, batch in images.items():
            path = os.path.join(self.log_dir, f"{step}_{name}_{self.run_id}.png")
            save_image_grid(np.asarray(batch), path, nrow=nrow)
            if self._wandb is not None:  # pragma: no cover
                self._wandb.log({name: self._wandb.Image(path)}, step=step)

    def flush(self):
        self._file.flush()

    def finish(self):
        self._file.close()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()
