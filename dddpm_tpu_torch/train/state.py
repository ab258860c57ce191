"""Train state and the training step (port of dddpm_tpu/train/state.py).

A step: the gradients of `grad_accum` micro-batches, averaged; their
global norm; the clip; Adam; the EMA.  Metrics stay device tensors until
the trainer flushes them, so a step waits on the device only where the
loss itself must (the recon gate's row count is read from the host-side
t, without a sync).

Deliberate differences from JAX: the clip is optax's clip_by_global_norm
(scale by max_norm / |g| only when |g| >= max_norm), not
torch.nn.utils.clip_grad_norm_, which divides by |g| + 1e-6.  Dropout
masks come from torch's default generators, which each step reseeds from
its own key (fold_seed(fold_seed(seed, step), DROPOUT_KEY)), as JAX keys
dropout by fold_in(rng, step): a run resumed at step s draws the masks
an unbroken run draws.  They are other numbers than JAX's, so
comparisons with the JAX package run with dropout 0 and inject JAX's t
and eps.

On a mesh (parallel/mesh.py) the batch is the rank's rows of the global
batch.  Every rank draws the global micro-batch's t and eps from the
same key and takes its own rows, so each row sees the draws the
one-process step gives it; the gradients are averaged over the ranks
once a step, after the accumulation and before the clip, so the clip,
Adam and the EMA see the global gradient and the replicated parameters
stay equal on every rank.  Rank r seeds its dropout masks from
fold_seed(step_key, DROPOUT_KEY + r): rank 0, and every one-process run,
keeps the one-process masks; an N-rank step with dropout on is not the
one-process step (deliberate).  Under FSDP (parallel/fsdp.py) the net's
sharded parameters are gathered before the first micro-batch and their
gradients reduce-scattered after the last.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from dddpm_tpu_torch.models.ddpm import draw_eps, fold_seed
from dddpm_tpu_torch.parallel import fsdp
from dddpm_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    batch_sharding,
    mesh_coords,
    replicate,
)
from dddpm_tpu_torch.train.ema import ema_update

# fold_seed key of a step's dropout seed; the micro-batches take keys
# 0 .. grad_accum - 1
DROPOUT_KEY = 1 << 20


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, float32 (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Global-norm clip (optax's rule), then torch.optim.Adam with
    optax's defaults b1 0.9, b2 0.999, eps 1e-8 (reference
    trainer_ddpm.py:142-143).  Adam is plain XLA in the JAX package, so
    the library optimizer stands in for it here."""

    def __init__(self, params: Sequence[nn.Parameter], lr: float,
                 clip_norm: float = 1.0):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    @torch.no_grad()
    def step(self, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clips the params' .grad in place, steps Adam; returns the
        norm before the clip (computed here unless given: under FSDP the
        norm spans every rank's shards)."""
        grads = [p.grad for p in self.params]
        norm = global_norm(grads) if norm is None else norm
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        self.adam.step()
        return norm

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def create_optimizer(net: nn.Module, lr: float,
                     clip_norm: float = 1.0) -> Optimizer:
    return Optimizer(net.parameters(), lr, clip_norm)


@dataclass
class TrainState:
    """All mutable training state: the net's own parameters, their EMA,
    the optimizer (its Adam moments) and the step, 0-based.  On a mesh,
    `mesh` is set; under FSDP `fsdp` says which params, EMA entries and
    moments are this rank's shards (params then holds the masters)."""

    step: int
    params: Dict[str, nn.Parameter]
    ema_params: Dict[str, torch.Tensor]
    opt: Optimizer
    seed: int
    mesh: Any = None
    fsdp: Optional[fsdp.FsdpLayout] = None


def create_train_state(net: nn.Module, opt: Optimizer, seed: int,
                       mesh=None) -> TrainState:
    """The state of `net`, its EMA a copy of its params; on a mesh both
    are rank 0's on every rank."""
    params = dict(net.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()}
    state = TrainState(step=0, params=params, ema_params=ema, opt=opt,
                       seed=seed, mesh=mesh)
    replicate_state(state)
    return state


def replicate_state(state: TrainState) -> None:
    """Broadcasts rank 0's params and EMA, all but FSDP's shards."""
    dims = {} if state.fsdp is None else state.fsdp.dims
    replicate([t for k, p in state.params.items() if k not in dims
               for t in (p.detach(), state.ema_params[k])], state.mesh)


def make_train_step(process, grad_accum: int = 2, ema_decay: float = 0.995,
                    ema_start: int = 2000, ema_every: int = 10) -> Callable:
    """Builds train_step(state, batch, t=None, eps=None) -> metrics.

    batch is (grad_accum, B, H, W, C) on the net's device: on a mesh, the
    rank's rows of a global batch of B x N.  Micro-batch i of step s
    draws its t and eps for the global batch from key
    fold_seed(fold_seed(seed, s), i) and takes the rank's rows; t
    (grad_accum, B x N) and eps (grad_accum, B x N, *sample_shape) may be
    given instead.  The default generators (dropout) are seeded from
    fold_seed(fold_seed(seed, s), DROPOUT_KEY + rank).  The state is
    updated in place; the metrics are global means."""
    use_ema = ema_decay > 0

    def train_step(state: TrainState, batch: torch.Tensor,
                   t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        rank, n = mesh_coords(state.mesh)
        global_batch = batch.shape[1] * n
        rows = batch_sharding(state.mesh, global_batch)
        if state.fsdp is not None:
            fsdp.gather_params(state)
        net_params: List[nn.Parameter] = list(
            (state.params if state.fsdp is None else state.fsdp.full).values())
        for p in net_params:   # every param gets a gradient, zero if unused
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        step_key = fold_seed(state.seed, state.step)
        torch.manual_seed(fold_seed(step_key, DROPOUT_KEY + rank))  # CUDA too
        metrics = []
        for i in range(grad_accum):
            key = fold_seed(step_key, i)
            t_i = process.t_sample(key, global_batch) if t is None else t[i]
            eps_i = (draw_eps(key, (global_batch, *process.sample_shape),
                              batch.device) if eps is None else eps[i])
            obj, m = process.loss_fn(batch[i], key, t=t_i[rows],
                                     eps=eps_i[rows])
            obj.backward()
            metrics.append({k: v.detach() for k, v in m.items()})
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in net_params], grad_accum)
        if state.fsdp is not None:
            fsdp.reduce_gradients(state)
            grad_norm = state.opt.step(fsdp.grad_norm(state))
            fsdp.release_params(state)
        else:
            all_reduce_mean([p.grad for p in net_params], state.mesh)
            grad_norm = state.opt.step()
        if use_ema:
            ema_update(state.ema_params.values(), state.params.values(),
                       state.step, ema_decay, ema_start, ema_every)
        state.step += 1
        names = list(metrics[0])
        out = torch.stack([torch.stack([m[k] for m in metrics]).mean()
                           for k in names])
        all_reduce_mean([out], state.mesh)
        out = dict(zip(names, out.unbind()))
        out["grad_norm"] = grad_norm
        return out

    return train_step
