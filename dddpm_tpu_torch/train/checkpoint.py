"""Checkpoints (port of dddpm_tpu/train/checkpoint.py): one torch file
{params, ema, opt_state, step, seed} plus the config.json and
train_losses.json sidecars, and an eval-time load that prefers the EMA
weights (reference utils/utils.py:51-54).  Importing the JAX package's
orbax checkpoints is left for a later slice.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import torch

from dddpm_tpu_torch.train.state import TrainState

_CONFIG_FILE = "config.json"
_LOSSES_FILE = "train_losses.json"
_STATE_FILE = "state.pt"


def _jsonable(config: Dict) -> Dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in config.items()}


def save_checkpoint(ckpt_dir: str, state: TrainState, config: Dict,
                    train_losses=None) -> str:
    """Write a full checkpoint under ckpt_dir (replaced atomically)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = {
        "params": {k: p.detach().cpu() for k, p in state.params.items()},
        "ema": {k: v.cpu() for k, v in state.ema_params.items()},
        "opt_state": state.opt.state_dict(),
        "step": state.step,
        "seed": state.seed,
    }
    path = os.path.join(ckpt_dir, _STATE_FILE)
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)
    with open(os.path.join(ckpt_dir, _CONFIG_FILE), "w") as f:
        json.dump(_jsonable(config), f, indent=2)
    if train_losses is not None:
        with open(os.path.join(ckpt_dir, _LOSSES_FILE), "w") as f:
            json.dump([float(x) for x in train_losses], f)
    return ckpt_dir


def load_config(ckpt_dir: str) -> Dict:
    with open(os.path.join(os.path.abspath(ckpt_dir), _CONFIG_FILE)) as f:
        return json.load(f)


def load_losses(ckpt_dir: str):
    path = os.path.join(os.path.abspath(ckpt_dir), _LOSSES_FILE)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def _load(ckpt_dir: str) -> dict:
    return torch.load(os.path.join(os.path.abspath(ckpt_dir), _STATE_FILE),
                      map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state: TrainState) -> TrainState:
    """Load a checkpoint into `state` in place (its tensors keep their
    devices); returns it."""
    blob = _load(ckpt_dir)
    for name, p in state.params.items():
        p.copy_(blob["params"][name])
    for name, e in state.ema_params.items():
        e.copy_(blob["ema"][name])
    state.opt.load_state_dict(blob["opt_state"])
    state.step = int(blob["step"])
    state.seed = int(blob["seed"])
    return state


def load_step(ckpt_dir: str) -> int:
    """The checkpoint's step, without reading its tensors (memory map)."""
    blob = torch.load(os.path.join(os.path.abspath(ckpt_dir), _STATE_FILE),
                      map_location="cpu", weights_only=True, mmap=True)
    return int(blob["step"])


def load_model_params(ckpt_dir: str, prefer_ema: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """Eval-time load: the EMA weights when present, else the raw ones,
    as a state dict for the net (on the CPU)."""
    blob = _load(ckpt_dir)
    return blob["ema"] if prefer_ema and blob.get("ema") else blob["params"]
