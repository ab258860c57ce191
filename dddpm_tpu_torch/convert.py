"""JAX parameter tree -> the port's state_dict.

The tree is the JAX package's flax params (nested dicts of numpy
arrays, with or without the top 'params' level).  Module names map by
the owner-typed rules of _CHILDREN; leaves by the kind of module:

- Conv2d kernels HWIO -> OIHW;
- Linear (flax Dense) kernels (in, out) -> (out, in);
- ConvTranspose2d kernels (4, 4, in, out) -> (in, out, 4, 4), flipped in
  both spatial dims (flax applies the kernel as given, torch as the
  transpose of a correlation; tests/test_torch_unet.py pins it);
- biases, GroupNorm scale/bias and ChannelLayerNorm g/b map straight.

The qkv columns keep their (3, heads, dim_head) order.  A tree with a
'params' level may also hold the int8 mode's 'quant' collection
(`amax_x` / `amax_skip` under each quantized Conv_0): it maps onto the
amax buffers of the same convs.  Amax buffers the tree does not hold
come back as 0, the uncalibrated value.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from dddpm_tpu_torch.models import blocks, resample, unet
from dddpm_tpu_torch.models.blocks import quant_buffers

# JAX child name -> torch attribute path, by the type of the torch owner
# (checked in order; first match wins)
_CHILDREN = [
    (unet.Unet, [(r"ResnetBlock_(\d+)", r"resnets.\1"),
                 (r"PreNormLinearAttention_(\d+)", r"attns.\1"),
                 (r"Downsample_(\d+)", r"downsamples.\1"),
                 (r"Upsample_(\d+)", r"upsamples.\1"),
                 (r"TimeMLP_0", "time_mlp"), (r"Block_0", "final_block")]),
    (blocks.ResnetBlock, [(r"Block_(\d+)", r"block\1")]),
    (blocks.Block, [(r"Conv_0", "conv"), (r"GroupNorm_0", "norm")]),
    (blocks.TimeMLP, [(r"Dense_(\d+)", r"dense\1")]),
    # Downsample / Upsample are the conv itself
    ((blocks.Downsample, blocks.Upsample), [(r"(Conv|ConvTranspose)_0", "")]),
    (resample.ConvResNet, [(r"Conv_0", "explode"), (r"Conv_1", "condense"),
                           (r"ConvResBlock_(\d+)", r"blocks.\1")]),
    ((resample.ConvResBlock, resample.SimpleDownConv, resample.SimpleUpConv),
     [(r"(?:Conv|ConvTranspose)_(\d+)", r"convs.\1")]),
]
_LEAVES = {"kernel": "weight", "scale": "weight"}


def _child(owner: nn.Module, name: str) -> str:
    for cls, rules in _CHILDREN:
        if isinstance(owner, cls):
            for pat, rep in rules:
                if re.fullmatch(pat, name):
                    return re.sub(pat, rep, name)
    return name


def _walk(tree, owner: nn.Module, prefix: str, out: dict) -> None:
    """Collects torch key -> (JAX leaf name, owning module, array)."""
    for name, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            sub = _child(owner, str(name))
            child = owner.get_submodule(sub) if sub else owner
            key = f"{prefix}{sub}." if sub else prefix
            _walk(value, child, key, out)
        else:
            leaf = _LEAVES.get(name, name)
            out[f"{prefix}{leaf}"] = (name, owner, np.asarray(value))


def _layout(arr: np.ndarray, module: nn.Module, leaf: str) -> np.ndarray:
    if leaf != "weight":
        return arr
    if isinstance(module, nn.ConvTranspose2d):
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        return arr.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear):
        return arr.T
    return arr


def jax_to_state_dict(tree, net: nn.Module) -> Dict[str, torch.Tensor]:
    """Converts the JAX tree for `net` (a whole model or any module of
    it); raises if a key is missing or unknown, or a shape disagrees."""
    want = net.state_dict()
    found: dict = {}
    _walk(tree.get("params", tree), net, "", found)
    if "params" in tree and "quant" in tree:
        _walk(tree["quant"], net, "", found)
    out = {}
    for key, (name, owner, arr) in found.items():
        if key not in want:
            raise KeyError(f"JAX param {name} maps to unknown key {key}")
        t = torch.from_numpy(np.array(_layout(arr, owner, key.rsplit(".", 1)[-1]),
                                      dtype=np.float32))
        if t.shape != want[key].shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{tuple(want[key].shape)}")
        out[key] = t
    for key in quant_buffers(net):
        out.setdefault(key, torch.zeros_like(want[key]))
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"no JAX params for {missing[:5]}")
    return out
