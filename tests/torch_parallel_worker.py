"""The rank side of tests/test_torch_parallel.py: one spawned gloo process
of a CPU process group.  It imports only torch and the port.

run(rank, world, workdir) joins the group through a file store in
workdir (world 0: one process, no group, no mesh), reads the cases and
their inputs from workdir/inputs.pt, runs each case and saves what the
test compares to workdir/out_<rank>.pt.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from dddpm_tpu_torch import resume_main, train_main
from dddpm_tpu_torch.evaluation.inception import FeatureExtractor
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.parallel import fsdp
from dddpm_tpu_torch.parallel.dryrun import dryrun_multichip
from dddpm_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    initialize_distributed,
    mesh_coords,
    shard_batch,
)
from dddpm_tpu_torch.sample import generate_samples
from dddpm_tpu_torch.train.checkpoint import gathered_state
from dddpm_tpu_torch.train.state import (
    create_optimizer,
    create_train_state,
    make_train_step,
)

# tests/test_parallel.py's CFG: a tiny DDPM, global batch 16
CFG = {
    "model": "ddpm", "dataset": "synthetic", "image_size": 8,
    "batch_size": 16, "lr": 1e-3, "T": 10, "loss_type": "simple",
    "beta_schedule": "cosine", "loss_flat": "sum",
    "unet_chan": 8, "unet_dims": (1, 2), "unet_dropout": 0.0,
    "ema_decay": 0.995, "compute_dtype": "float32",
}
# __graft_entry__.py's dDDPM, dropout off, recon rows at t < 5
DD_CFG = {
    "model": "dddpm", "dataset": "synthetic", "image_size": 16,
    "batch_size": 8, "T": 10, "loss_type": "simple",
    "beta_schedule": "cosine", "loss_flat": "sum",
    "unet_chan": 8, "unet_dims": (1, 2), "unet_dropout": 0.0,
    "unet_in": 4, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 8, "d_n_blocks": 2, "u_n_blocks": 2,
    "ae_loss": True, "t_rec_max": 5, "force_latent": True,
    "compute_dtype": "float32", "lr": 1e-3, "ema_decay": 0.995,
}
FSDP_MIN_SIZE = 512
# train_main's CLI run: a full-width x2 UNet on 16^2 synthetic images
TRAIN_ARGV = ["-d", "synthetic", "-e", "1", "-bs", "4", "-is", "16",
              "-downsample", "1", "--T", "50", "--compute-dtype", "float32",
              "--device", "cpu", "-mute", "--prefetch", "0", "--fsdp"]


def model(config, weights=None):
    """(net, process) on the CPU in train mode, with `weights` or init(0)."""
    net, process, init_fn, _ = build_model(config, device="cpu")
    if weights is None:
        init_fn(0)
    else:
        net.load_state_dict(weights)
    net.train()
    return net, process


def full_state(state, mesh) -> dict:
    """The state in the one-process layout (gathered under FSDP): params,
    EMA, Adam moments and the masters' clipped gradients."""
    params, ema, opt = gathered_state(state)
    dims = {} if state.fsdp is None else state.fsdp.dims
    grads = {k: (fsdp.gather_tensor(p.grad, dims[k], mesh) if k in dims
                 else p.grad) for k, p in state.params.items()}
    names = list(state.params)
    moments = {names[i]: (e["exp_avg"], e["exp_avg_sq"])
               for i, e in opt["state"].items()}
    return {"params": params, "ema": ema, "grads": grads, "moments": moments}


def train_steps(config, weights, batch, mesh, steps=1, use_fsdp=False,
                t=None, eps=None):
    """`steps` train steps (accumulation 2) of the global batch (steps,
    2, B, ...) on the mesh; (state, metrics per step)."""
    net, process = model(config, weights)
    state = create_train_state(net, create_optimizer(net, config["lr"]),
                               seed=1, mesh=mesh)
    if use_fsdp:
        state = fsdp.shard_state_fsdp(state, mesh, min_size=FSDP_MIN_SIZE)
    step = make_train_step(process, 2, config["ema_decay"])
    metrics = []
    for s in range(steps):
        m = step(state, shard_batch(batch[s], mesh, dim=1),
                 t=None if t is None else t[s],
                 eps=None if eps is None else eps[s])
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def case_mesh(inp, mesh):
    r, n = mesh_coords(mesh)
    errors = []
    for shape in ((n + 1,), (n, 1)):
        try:
            create_mesh(shape)
        except ValueError as e:
            errors.append(str(e))
    try:
        batch_sharding(mesh, 4 * n + 1)
    except ValueError as e:
        errors.append(str(e))
    return {"coords": (r, n), "rows": shard_batch(torch.arange(4 * n), mesh),
            "rows_dim1": shard_batch(np.arange(8 * n).reshape(2, 4 * n),
                                     mesh, dim=1),
            "errors": errors}


def case_steps(inp, mesh):
    """The replicated and the FSDP step with the seeded draws, 2 steps
    each; the replicated step with injected draws (jax_draws), 1 step."""
    out = {}
    runs = [("rep", False, None)]
    if mesh is not None:
        runs.append(("fsdp", True, None))
    if inp.get("jax_draws") is not None:
        runs.append(("rep_jax", False, inp["jax_draws"]))
    for name, use_fsdp, draws in runs:
        t, eps = (None, None) if draws is None else draws
        state, metrics = train_steps(CFG, inp["weights"], inp["batch"], mesh,
                                     steps=2 if draws is None else 1,
                                     use_fsdp=use_fsdp, t=t, eps=eps)
        res = full_state(state, mesh)
        res["metrics"] = metrics
        if use_fsdp:
            res["dims"] = dict(state.fsdp.dims)
            res["local"] = {k: (state.params[k].numel(),
                                state.ema_params[k].numel(),
                                *(state.opt.adam.state[state.params[k]][s]
                                  .numel() for s in ("exp_avg", "exp_avg_sq")))
                            for k in state.fsdp.dims}
            res["released"] = sum(state.fsdp.full[k].numel()
                                  for k in state.fsdp.dims)
        out[name] = res
    return out


def case_compact(inp, mesh):
    """The dDDPM step with the compact recon branch and with the dense
    one, on the same weights, batch, t and eps."""
    out = {}
    for compact in (True, False):
        cfg = dict(DD_CFG, recon_compact=compact)
        state, metrics = train_steps(cfg, inp["dd_weights"], inp["dd_batch"],
                                     mesh, t=inp["dd_t"], eps=inp["dd_eps"])
        out[compact] = dict(full_state(state, mesh), metrics=metrics)
    return out


def case_sample(inp, mesh):
    out = {}
    for name, config, kw in inp["sample_runs"]:
        net, process = model(config, inp["sample_weights"][name])
        net.eval()
        out[name] = generate_samples(process, seed=3, progress=False,
                                     mesh=mesh, **kw)[:2]
    return out


def case_inception(inp, mesh):
    fe = FeatureExtractor(batch_size=inp["inception_batch"], device="cpu",
                          mesh=mesh)
    return {"batch_size": fe.batch_size, "features": fe(inp["images"])}


def case_cli(inp, mesh):
    """train_main on the mesh with --mesh-shape N --fsdp, then
    resume_main of a one-process checkpoint, each rank in a directory of
    its own."""
    r, n = mesh_coords(mesh)
    home = os.path.join(inp["workdir"], f"rank{r}")
    os.makedirs(home)
    cwd = os.getcwd()
    os.chdir(home)
    try:
        trainer = train_main.main(TRAIN_ARGV + ["--mesh-shape", str(n)])
        resumed = resume_main.main(["--checkpoint", inp["one_process_ckpt"],
                                    "--device", "cpu", "-mute"])
    finally:
        os.chdir(cwd)
    # the EMA weights gathered for an evaluation (every rank enters)
    x_recon, _ = trainer.recon(trainer.val_batch, seed=5)
    return {"ckpt": os.path.join(home, trainer.checkpoint_dir),
            "recon": x_recon,
            "resumed_ckpt": os.path.join(home, resumed.checkpoint_dir),
            "sharded": len(trainer.state.fsdp.dims),
            "files": sorted(os.path.relpath(os.path.join(d, f), home)
                            for d, _, fs in os.walk(home) for f in fs)}


def case_dryrun(inp, mesh):
    return dryrun_multichip(mesh_coords(mesh)[1], device="cpu")


CASES = {"mesh": case_mesh, "steps": case_steps, "compact": case_compact,
         "sample": case_sample, "inception": case_inception,
         "cli": case_cli, "dryrun": case_dryrun}


def run(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    inp["workdir"] = workdir
    out = {}
    if world:
        store = f"file://{os.path.join(workdir, 'store')}"
        out["rank"] = initialize_distributed(store, world, rank, device="cpu")
        out["again"] = initialize_distributed(store, world, rank, device="cpu")
    mesh = create_mesh()
    for name in inp["cases"]:
        out[name] = CASES[name](inp, mesh)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    if world:
        dist.destroy_process_group()
