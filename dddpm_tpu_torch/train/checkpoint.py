"""Checkpoints (port of dddpm_tpu/train/checkpoint.py): one torch file
{params, ema, opt_state, step, seed} plus the config.json and
train_losses.json sidecars, and an eval-time load that prefers the EMA
weights (reference utils/utils.py:51-54).  JAX's orbax checkpoints
come in through convert_jax_checkpoint.py.

The file always holds the one-process layout.  On a mesh, rank 0 alone
writes it: under FSDP every rank first takes part in gathering the
shards of the params, the EMA and the Adam moments.  Every rank reads it
back and keeps its own shards, so a checkpoint moves between world
sizes, with FSDP on or off, both ways.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import torch
import torch.distributed as dist

from dddpm_tpu_torch.parallel.fsdp import gather_tensor, shard_tensor
from dddpm_tpu_torch.parallel.mesh import is_main
from dddpm_tpu_torch.train.state import TrainState, replicate_state

_CONFIG_FILE = "config.json"
_LOSSES_FILE = "train_losses.json"
_STATE_FILE = "state.pt"


def _jsonable(config: Dict) -> Dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in config.items()}


def _each_sharded(state: TrainState, params: Dict, ema: Dict, opt: Dict,
                  fn) -> tuple:
    """(params, ema, opt_state) with fn(tensor, dim) applied to the
    entries of the parameters `state` holds as shards: the params, their
    EMA and their Adam moments; the rest as they are."""
    dims = {} if state.fsdp is None else state.fsdp.dims
    names = list(state.params)
    each = lambda k, v: v if k not in dims else fn(v, dims[k])
    opt = dict(opt, state={i: {s: (v if s == "step" else each(names[i], v))
                               for s, v in entry.items()}
                           for i, entry in opt["state"].items()})
    return ({k: each(k, v) for k, v in params.items()},
            {k: each(k, v) for k, v in ema.items()}, opt)


@torch.no_grad()
def gathered_state(state: TrainState) -> tuple:
    """(params, ema, opt_state) in the one-process layout; under FSDP
    every rank takes part in the gathers."""
    return _each_sharded(
        state, {k: p.detach() for k, p in state.params.items()},
        state.ema_params, state.opt.state_dict(),
        lambda v, d: gather_tensor(v, d, state.mesh))


@torch.no_grad()
def save_checkpoint(ckpt_dir: str, state: TrainState, config: Dict,
                    train_losses=None) -> str:
    """Write a full checkpoint under ckpt_dir (replaced atomically).  On a
    mesh every rank calls this (FSDP gathers), rank 0 writes, and all
    return once the file is there."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    mesh = state.mesh
    params, ema, opt = gathered_state(state)
    if mesh is None or is_main():
        _write(ckpt_dir, {"params": _cpu(params), "ema": _cpu(ema),
                          "opt_state": _cpu(opt), "step": state.step,
                          "seed": state.seed}, config, train_losses)
    if mesh is not None:
        dist.barrier()
    return ckpt_dir


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _write(ckpt_dir: str, blob: dict, config: Dict, train_losses) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, _STATE_FILE)
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)
    with open(os.path.join(ckpt_dir, _CONFIG_FILE), "w") as f:
        json.dump(_jsonable(config), f, indent=2)
    if train_losses is not None:
        with open(os.path.join(ckpt_dir, _LOSSES_FILE), "w") as f:
            json.dump([float(x) for x in train_losses], f)


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
    devices); returns it.  Under FSDP each rank keeps its shards; the
    rest is rank 0's on every rank."""
    blob = _load(ckpt_dir)
    params, ema, opt = _each_sharded(
        state, blob["params"], blob["ema"], blob["opt_state"],
        lambda v, d: shard_tensor(v, d, state.mesh))
    for name, p in state.params.items():
        p.copy_(params[name])
    for name, e in state.ema_params.items():
        e.copy_(ema[name])
    state.opt.load_state_dict(opt)
    replicate_state(state)
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
