"""FSDP-style parameter sharding over the data axis (port of
dddpm_tpu/parallel/fsdp.py).

The rule is the JAX package's (spec_for = its _spec_for): a parameter
of at least min_size elements is sharded along its largest dimension
that the axis size divides, the last one on a tie; smaller parameters,
and those with no such dimension, stay replicated.  The port's layouts
permute JAX's (OIHW against HWIO), so the dimension chosen may be
another one, of the same size.

Where XLA's partitioner inserts the collectives, the port calls them:
a sharded parameter's master copy, its EMA and its Adam moments live
on each rank as its 1/N slice along that dimension, as plain tensors,
so Optimizer, ema_update and the checkpoint run on them unchanged.  The
net's full parameters exist only within a step: gather_params fills
them (all_gather_into_tensor) before the first micro-batch,
reduce_gradients reduce-scatters their gradients into the masters'
after the last, and release_params frees them.  The step counter and
the seed stay replicated.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from dddpm_tpu_torch.parallel.mesh import all_reduce_mean, mesh_coords

DEFAULT_MIN_SIZE = 2 ** 16


@dataclass
class FsdpLayout:
    """Which parameters a TrainState holds as shards, and where."""

    dims: Dict[str, int]             # sharded parameters: name -> dim
    full: Dict[str, nn.Parameter]    # the net's own parameters, by name
    mesh: Any
    axis: str = "data"


def spec_for(shape: Sequence[int], axis_size: int,
             min_size: int = DEFAULT_MIN_SIZE) -> Optional[int]:
    """The dimension to shard `shape` along, or None (replicated)."""
    if not shape or math.prod(shape) < min_size:
        return None
    best = None
    for i in reversed(range(len(shape))):
        if shape[i] % axis_size == 0 and (best is None
                                          or shape[i] > shape[best]):
            best = i
    return best


def fsdp_sharding(params: Mapping[str, torch.Tensor], mesh,
                  axis: str = "data", min_size: int = DEFAULT_MIN_SIZE
                  ) -> Dict[str, Optional[int]]:
    """name -> the dimension each parameter is sharded along, or None."""
    _, n = mesh_coords(mesh, axis)
    return {k: spec_for(tuple(p.shape), n, min_size) for k, p in params.items()}


def shard_tensor(t: torch.Tensor, dim: int, mesh, axis: str = "data"
                 ) -> torch.Tensor:
    """This rank's slice of `t` along dim, as a tensor of its own."""
    r, n = mesh_coords(mesh, axis)
    size = t.shape[dim] // n
    return t.detach().narrow(dim, r * size, size).contiguous()


def gather_tensor(shard: torch.Tensor, dim: int, mesh, axis: str = "data"
                  ) -> torch.Tensor:
    """The full tensor from every rank's slice along dim."""
    _, n = mesh_coords(mesh, axis)
    shape = tuple(shard.shape)
    buf = shard.new_empty((n * shape[0],) + shape[1:])   # dim-0 concatenation
    dist.all_gather_into_tensor(buf, shard.detach().contiguous(),
                                group=mesh.get_group(axis))
    full = list(shape)
    full[dim] *= n
    return buf.view((n,) + shape).movedim(0, dim).reshape(full)


def reduce_scatter_tensor(full: torch.Tensor, dim: int, mesh,
                          axis: str = "data") -> torch.Tensor:
    """This rank's slice along dim of the sum over ranks of `full`."""
    _, n = mesh_coords(mesh, axis)
    shape = list(full.shape)
    shape[dim:dim + 1] = [n, shape[dim] // n]
    chunks = full.reshape(shape).movedim(dim, 0).contiguous()
    out = full.new_empty(chunks.shape[1:])
    dist.reduce_scatter_tensor(out, chunks.flatten(0, 1),   # dim-0 chunks
                               group=mesh.get_group(axis))
    return out


def shard_params_fsdp(params: Mapping[str, torch.Tensor], mesh,
                      axis: str = "data", min_size: int = DEFAULT_MIN_SIZE
                      ) -> Dict[str, torch.Tensor]:
    """This rank's view of `params`: the sharded ones as slices, the rest
    as they are."""
    dims = fsdp_sharding(params, mesh, axis, min_size)
    return {k: p if dims[k] is None else shard_tensor(p, dims[k], mesh, axis)
            for k, p in params.items()}


def _opt_entries(opt, names):
    """name -> Adam's state of that parameter (empty before a step)."""
    return {k: opt.adam.state.get(p, {}) for k, p in zip(names, opt.params)}


@torch.no_grad()
def shard_state_fsdp(state, mesh, axis: str = "data",
                     min_size: int = DEFAULT_MIN_SIZE):
    """The TrainState `state` (replicated, or restored) with its params,
    EMA and Adam moments sharded: a new state whose optimizer steps the
    masters; the net's full parameters are released.  Without a mesh
    (one process) there is nothing to shard: `state` itself."""
    from dddpm_tpu_torch.train.state import Optimizer

    if mesh is None:
        return state

    names = list(state.params)
    dims = {k: d for k, d in fsdp_sharding(state.params, mesh, axis,
                                           min_size).items() if d is not None}
    masters = {k: nn.Parameter(v) if k in dims else v for k, v in
               shard_params_fsdp(state.params, mesh, axis, min_size).items()}
    ema = shard_params_fsdp(state.ema_params, mesh, axis, min_size)
    old = _opt_entries(state.opt, names)
    opt = Optimizer(masters.values(), state.opt.adam.param_groups[0]["lr"],
                    state.opt.clip_norm)
    for k, p in masters.items():
        if old[k]:
            opt.adam.state[p] = {
                s: (shard_tensor(v, dims[k], mesh, axis)
                    if k in dims and s != "step" else v)
                for s, v in old[k].items()}
    layout = FsdpLayout(dims=dims, full=dict(state.params), mesh=mesh,
                        axis=axis)
    new = dataclasses.replace(state, params=masters, ema_params=ema, opt=opt,
                              mesh=mesh, fsdp=layout)
    release_params(new)
    return new


@torch.no_grad()
def gather_params(state, source: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> None:
    """Fills the net's sharded parameters in full from `source`'s shards
    (the masters by default, or the EMA)."""
    layout = state.fsdp
    source = state.params if source is None else source
    for k, d in layout.dims.items():
        layout.full[k].data = gather_tensor(source[k], d, layout.mesh,
                                            layout.axis)


def release_params(state) -> None:
    """Frees the net's full copies of the sharded parameters."""
    for k in state.fsdp.dims:
        p = state.fsdp.full[k]
        p.data = p.data.new_empty(0)
        p.grad = None


@torch.no_grad()
def reduce_gradients(state) -> None:
    """The mean over ranks of the net's gradients: reduce-scattered into
    the sharded masters' .grad, all-reduced in place for the replicated
    parameters."""
    layout = state.fsdp
    _, n = mesh_coords(layout.mesh, layout.axis)
    for k, d in layout.dims.items():
        g = reduce_scatter_tensor(layout.full[k].grad, d, layout.mesh,
                                  layout.axis)
        state.params[k].grad = g.div_(n)
        layout.full[k].grad = None
    all_reduce_mean([p.grad for k, p in state.params.items()
                     if k not in layout.dims], layout.mesh, layout.axis)


@torch.no_grad()
def grad_norm(state) -> torch.Tensor:
    """The global norm of the gradient, float32: the squares of the
    sharded gradients summed over ranks, plus the replicated ones'
    counted once."""
    layout = state.fsdp
    sharded = [p.grad for k, p in state.params.items() if k in layout.dims]
    rest = [p.grad for k, p in state.params.items() if k not in layout.dims]
    device = next(iter(state.params.values())).device
    sq = [_sq(sharded, device), _sq(rest, device)]
    dist.all_reduce(sq[0], group=layout.mesh.get_group(layout.axis))
    return torch.sqrt(sq[0] + sq[1])


def _sq(grads, device) -> torch.Tensor:
    if not grads:
        return torch.zeros((), dtype=torch.float32, device=device)
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms)) ** 2
