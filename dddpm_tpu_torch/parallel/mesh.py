"""Process group, mesh and batch split on torch.distributed (port of
dddpm_tpu/parallel/mesh.py).

One process per card (torchrun), NCCL between cards, gloo between CPU
processes.  A mesh is a DeviceMesh over every rank, 1-D ('data',) by
default.  The global batch is split over the 'data' axis: rank r of N
takes rows [r B / N, (r + 1) B / N).  Parameters, their EMA and the
optimizer state are replicated (a broadcast from rank 0), or sharded by
parallel/fsdp.py.  Where XLA inserts the collectives from the JAX
package's shardings, the port calls them itself: the train step's
gradient all-reduce (train/state.py), the samplers' and the Inception
extractor's all-gathers (sample.py, evaluation/inception.py).

mesh=None means one process and no collective, whether or not a
process group exists.

Deliberate difference: a mesh shape whose product is not the world size
raises, where JAX takes a prefix of its devices.
"""
from __future__ import annotations

import math
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dddpm_tpu_torch.utils.device import DeviceLike, resolve_device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: DeviceLike = None) -> int:
    """Joins this process to the run's process group; returns its rank.

    Omitted arguments come from torchrun's environment (MASTER_ADDR /
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).  coordinator_address is
    'host:port' or an init-method URL ('tcp://...', 'file://...').  With
    no coordinator and one process this is a no-op that returns 0, as is
    a second call (it returns the rank).  The backend is NCCL for a CUDA
    device (the default, see utils/device.py) and gloo for the CPU; on a
    card the process binds cuda:LOCAL_RANK before the group forms."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        if (num_processes or 1) == 1:
            return 0
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address (or torchrun's MASTER_ADDR / MASTER_PORT)")
    if num_processes is None or process_id is None:
        raise ValueError("the number of processes and this process's id "
                         "are needed (or torchrun's WORLD_SIZE / RANK)")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    kw = dict(init_method=init_method, world_size=num_processes,
              rank=process_id)
    if resolve_device(device).type == "cuda":
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return dist.get_rank()


def rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, the one process that writes files and prints."""
    return rank() == 0


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data",)):
    """A DeviceMesh over every rank: by default one 'data' axis.  None
    without a process group (one process), where a shape other than a
    single device raises."""
    if not dist.is_initialized():
        if shape is not None and math.prod(shape) != 1:
            raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                             "processes; no process group is initialized")
        return None
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    shape = (n,) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, the "
                         f"world has {n}")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh {shape} needs {len(shape)} axis names, got "
                         f"{tuple(axis_names)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def mesh_coords(mesh, axis: str = "data") -> Tuple[int, int]:
    """(this rank's index along `axis`, the axis's size); (0, 1) for
    mesh None."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def batch_sharding(mesh, batch_size: int, axis: str = "data") -> slice:
    """This rank's rows of a global batch of batch_size; raises when the
    axis does not divide it (as JAX's sharding does)."""
    r, n = mesh_coords(mesh, axis)
    if batch_size % n:
        raise ValueError(f"batch size {batch_size} is not divisible by the "
                         f"{n} ranks of the '{axis}' axis")
    local = batch_size // n
    return slice(r * local, (r + 1) * local)


def shard_batch(batch, mesh, axis: str = "data", dim: int = 0):
    """This rank's rows of `batch` (a tensor or an array) along `dim`."""
    rows = batch_sharding(mesh, batch.shape[dim], axis)
    return batch[(slice(None),) * dim + (rows,)]


def replicated(mesh):
    """The process group that replicated state spans: every rank of the
    mesh (create_mesh spans the world)."""
    return None if mesh is None else dist.group.WORLD


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Broadcasts each tensor from rank 0 in place; returns them."""
    tensors = list(tensors)
    if mesh is not None:
        for t in tensors:
            dist.broadcast(t, src=0, group=replicated(mesh))
    return tensors


def broadcast_object(obj, mesh):
    """Rank 0's `obj` (picklable) on every rank."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=replicated(mesh))
    return box[0]


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh,
                    axis: str = "data") -> None:
    """Replaces each tensor by its mean over the ranks of `axis`: one
    all-reduce (SUM, then a division: gloo has no AVG) of a flat bucket
    per dtype."""
    _, n = mesh_coords(mesh, axis)
    if mesh is None or not tensors:
        return
    group = mesh.get_group(axis)
    for dtype in dict.fromkeys(t.dtype for t in tensors):   # rank-stable order
        part = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        torch._foreach_copy_(part, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in part]), part)])


def all_gather_rows(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The global batch from every rank's rows (dim 0, equal counts), in
    rank order, on every rank."""
    _, n = mesh_coords(mesh, axis)
    if mesh is None:
        return x
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.get_group(axis))
    return out
