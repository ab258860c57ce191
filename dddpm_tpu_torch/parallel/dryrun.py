"""A dry run of the port's sharded paths over every rank of a process
group (counterpart of __graft_entry__.py:dryrun_multichip).

    torchrun --nproc-per-node N -m dddpm_tpu_torch.parallel.dryrun [--device cpu]

With the JAX dry run's tiny dDDPM config: one full train step over the
ranks (accumulation, clip, Adam, EMA) with the batch split over them,
the checkpoint round trip of the FSDP-sharded state compared bit for
bit, and the sharded bulk sampler with its batch spread over every rank.
Runs on the cards (NCCL) unless --device cpu (gloo).

    torchrun --standalone --nproc-per-node N -m dddpm_tpu_torch.parallel.dryrun --full

runs chip_smoke.py's phase 14 instead (run_full): the sharded paths at
full width on the cards, each held against the run without the mesh.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dddpm_tpu_torch.evaluation.inception import FeatureExtractor
from dddpm_tpu_torch.models.ddpm import draw_t, fold_seed
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.ops import attention_block as ab
from dddpm_tpu_torch.ops import convres as cr
from dddpm_tpu_torch.parallel import fsdp
from dddpm_tpu_torch.parallel.mesh import (
    all_gather_rows,
    batch_sharding,
    broadcast_object,
    create_mesh,
    initialize_distributed,
    is_main,
    shard_batch,
    world_size,
)
from dddpm_tpu_torch.probes._util import card_line
from dddpm_tpu_torch.quantize import load_float_weights
from dddpm_tpu_torch.sample import (
    fix_samples,
    generate_samples,
    make_bulk_sampler,
)
from dddpm_tpu_torch.train import checkpoint as ckpt
from dddpm_tpu_torch.train.state import (
    create_optimizer,
    create_train_state,
    make_train_step,
)
from dddpm_tpu_torch.train.trainer import setup_trainer
from dddpm_tpu_torch.utils.device import DeviceLike, resolve_device

# __graft_entry__.py:dryrun_multichip's config; batch_size is 2 a rank
CONFIG = {
    "model": "dddpm", "dataset": "synthetic", "image_size": 16,
    "T": 10, "loss_type": "simple",
    "beta_schedule": "cosine", "loss_flat": "sum",
    "unet_chan": 8, "unet_dims": (1, 2), "unet_dropout": 0.1,
    "unet_in": 4, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 8, "d_n_blocks": 2, "u_n_blocks": 2,
    "ae_loss": True, "t_rec_max": 1, "force_latent": True,
    "compute_dtype": "float32", "lr": 1e-3,
}
FSDP_MIN_SIZE = 512   # the tiny model's larger convs get sharded


def same_on_every_rank(tensors, mesh) -> bool:
    """Whether each tensor equals rank 0's, bit for bit, on every rank."""
    if mesh is None:
        return True
    ok = torch.ones((), device=tensors[0].device)
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, src=0)
        ok *= float(torch.equal(ref, t.detach()))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok)


def shared_tempdir(mesh) -> str:
    """A directory rank 0 makes, named on every rank."""
    return broadcast_object(tempfile.mkdtemp(prefix="dryrun_") if is_main()
                            else None, mesh)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """The dry run on the n_devices ranks of the current process group;
    returns what rank 0 prints."""
    if world_size() != n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) runs on {n_devices} ranks; the "
            f"process group has {world_size()} (start it under torchrun "
            f"--nproc-per-node {n_devices})")
    dev = resolve_device(device)
    say = print if is_main() else (lambda *a, **k: None)
    mesh = create_mesh((n_devices,))
    config = dict(CONFIG, batch_size=2 * n_devices)
    net, process, init_fn, config = build_model(config, dev)
    init_fn(0)
    net.train()
    state = create_train_state(net, create_optimizer(net, config["lr"]),
                               seed=0, mesh=mesh)
    step_fn = make_train_step(process, grad_accum=2, ema_decay=0.995)
    gen = torch.Generator().manual_seed(1)
    batch = torch.rand((2, config["batch_size"], 16, 16, 3), generator=gen)
    metrics = step_fn(state, shard_batch(batch * 2 - 1, mesh, dim=1).to(dev))
    obj = float(metrics["train_obj"])
    assert np.isfinite(obj), f"non-finite loss {obj}"
    assert state.step == 1
    assert same_on_every_rank(list(state.params.values()), mesh), \
        "replicated params differ across ranks"
    say(f"dryrun_multichip({n_devices}): ok, train_obj={obj:.4f}, params "
        f"equal on every rank")

    # checkpoint round trip of the FSDP-sharded state, then one more step
    state = fsdp.shard_state_fsdp(state, mesh, min_size=FSDP_MIN_SIZE)
    n_sharded = 0 if state.fsdp is None else len(state.fsdp.dims)
    assert mesh is None or n_sharded, "no parameter was sharded"
    step_fn(state, shard_batch(batch * 2 - 1, mesh, dim=1).to(dev))
    tmp = shared_tempdir(mesh)
    try:
        ckpt.save_checkpoint(tmp, state, config)
        net2, _, _, _ = build_model(config, dev)
        fresh = fsdp.shard_state_fsdp(
            create_train_state(net2, create_optimizer(net2, config["lr"]),
                               seed=5, mesh=mesh), mesh,
            min_size=FSDP_MIN_SIZE)
        ckpt.restore_checkpoint(tmp, fresh)
        assert fresh.step == 2 and fresh.seed == 0
        for k, p in state.params.items():
            assert torch.equal(p, fresh.params[k]), k
            assert torch.equal(state.ema_params[k], fresh.ema_params[k]), k
        for p, p2 in zip(state.opt.params, fresh.opt.params):
            for s in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(state.opt.adam.state[p][s],
                                   fresh.opt.adam.state[p2][s]), s
        sample_params = ckpt.load_model_params(tmp, prefer_ema=True)
        if mesh is not None:
            dist.barrier()   # every rank has read it
    finally:
        if is_main():
            shutil.rmtree(tmp, ignore_errors=True)
    say(f"dryrun_multichip({n_devices}): FSDP checkpoint round trip ok "
        f"({n_sharded} of {len(state.params)} params sharded)")

    # the sharded bulk sampler: the batch spread over every rank
    net3, process3, _, _ = build_model(config, dev)
    load_float_weights(net3, sample_params)
    x_s, z_s = make_bulk_sampler(process3, config["batch_size"],
                                 mesh=mesh)(2)
    assert x_s.shape == (2, 16, 16, 3), x_s.shape
    assert bool(torch.isfinite(x_s).all() and torch.isfinite(z_s).all())
    samples = fix_samples(x_s, mesh)
    assert samples.shape == (config["batch_size"], 16, 16, 3), samples.shape
    say(f"dryrun_multichip({n_devices}): sharded sample batch "
        f"{samples.shape} produced across {n_devices} ranks")
    return {"train_obj": obj, "sharded": n_sharded,
            "samples": samples.shape}


# ------------------------------------------------- --full: the card's phase

# bench.py:_sample_config(192): dDDPM x2 at CelebA-HQ 256^2 widths, and
# bench.py:run_train's x3 step on it (B = 32 x accumulation 2), on
# synthetic 256^2 images; chip_smoke.py's X2_CONFIG and X3_CONFIG
X2_CONFIG = {
    "model": "dddpm", "dataset": "celeba_hq", "image_size": 256,
    "batch_size": 192, "T": 1000, "loss_type": "simple",
    "beta_schedule": "linear", "loss_flat": "sum",
    "unet_chan": 128, "unet_dims": (1, 2, 2, 2), "unet_dropout": 0.1,
    "unet_in": 8, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 64, "d_n_blocks": 3, "u_n_blocks": 3,
    "ae_loss": True, "t_rec_max": 100, "force_latent": True,
    "compute_dtype": "bfloat16",
}
X3_CONFIG = dict(X2_CONFIG, dataset="synthetic", batch_size=32,
                 n_downsamples=3, lr=2e-4, grad_accum=2, ema_decay=0.995,
                 prefetch=2, val_split=0, rnd_flip=False, recon_compact=True)
TRAIN_STEPS, TIMED_STEPS = 3, 8
CHAIN_STEPS = 20
# the x3 step's launches a micro-batch (chip_smoke.py phase 5): K2 13 with
# recon rows (9 under autograd + the downsampler's 4), 4 without; K3 9
# with, 0 without; K1a and K1b 1 each (the one site above 512 tokens)
FWD_PER_MB, BWD_PER_MB, FWD_NO_ROWS = 13, 9, 4


def _launches() -> dict:
    return {**ab.LAUNCHES, **cr.LAUNCHES}


def _reset_launches() -> None:
    for d in (ab.LAUNCHES, cr.LAUNCHES):
        for k in d:
            d[k] = 0


def _predicted(seed: int, steps: int, rows: slice) -> dict:
    """Each kernel's launches on this rank in `steps` steps from step 0,
    from the recon rows of its share of each micro-batch's t."""
    cfg = X3_CONFIG
    gated = [int((draw_t(fold_seed(fold_seed(seed, s), i), cfg["batch_size"],
                         cfg["T"])[rows] < cfg["t_rec_max"]).sum())
             for s in range(steps) for i in range(2)]
    return {"attn_ctx": 2 * steps, "attn_out": 2 * steps,
            "convres_fwd": sum(FWD_PER_MB if n else FWD_NO_ROWS for n in gated),
            "convres_bwd": sum(BWD_PER_MB if n else 0 for n in gated),
            "gated_rows": gated}


def _sampler_launches() -> dict:
    """The launches of a CHAIN_STEPS-step x2 chain and its decode on a
    rank: K1a and K1b at the five sites above 512 tokens a step, K2 at
    the decoder's three fused blocks."""
    return {"attn_ctx": 5 * CHAIN_STEPS, "attn_out": 5 * CHAIN_STEPS,
            "convres_fwd": 3}


def _pick_seed(rows: slice) -> int:
    """The first seed whose steps give this rank micro-batches with and
    without recon rows (so both launch counts are checked)."""
    for seed in range(1000):
        gated = _predicted(seed, TRAIN_STEPS, rows)["gated_rows"]
        if min(gated) == 0 and max(gated) > 0:
            return seed
    raise AssertionError("no seed gives both kinds of micro-batch")


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _timed_ms(step, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _profiled(step, n: int) -> dict:
    """Kernels and kernel time a step over n steps (torch.profiler)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"kernels": len(kernels) / n,
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels)
            / 1e3 / n}


def _peak_gib(base: int) -> list:
    """Each rank's peak of allocated device memory since the last reset,
    above `base` bytes (what it held before), in GiB."""
    peaks = [None] * world_size()
    dist.all_gather_object(
        peaks, (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    return peaks


def _train_run(seed, workdir, use_fsdp, recorded):
    """setup_trainer on the mesh, then TRAIN_STEPS counted train_steps
    (the device batches appended to `recorded`): (trainer, losses, launches,
    the params and EMA in the one-process layout, peak GiB a rank above
    what it held before)."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer, _ = setup_trainer(dict(X3_CONFIG, n_steps=TRAIN_STEPS,
                                    fsdp=use_fsdp),
                               mute=True, seed=seed, workdir=workdir)
    take = trainer._next_batch

    def record():
        recorded.append(take())
        return recorded[-1]
    trainer._next_batch = record
    torch.cuda.synchronize()
    _reset_launches()
    losses = [float(trainer.train_step()["train_obj"])
              for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launched = _launches()
    trainer._next_batch = take
    params, ema, _ = ckpt.gathered_state(trainer.state)
    full = ({k: v.clone() for k, v in params.items()},
            {k: v.clone() for k, v in ema.items()})
    return trainer, losses, launched, full, _peak_gib(base)


def _plain_run(seed, batches, mesh):
    """The same steps without the mesh, on the global batches: (the
    state, its step function, the global batches, peak GiB above what
    was held before)."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net, process, init_fn, config = build_model(X3_CONFIG)
    init_fn(seed)
    net.train()
    state = create_train_state(net, create_optimizer(net, config["lr"]), seed)
    step_fn = make_train_step(process, 2, config["ema_decay"])
    glob = [torch.stack([all_gather_rows(b[i], mesh) for i in range(2)])
            for b in batches]
    for b in glob:
        step_fn(state, b)
    torch.cuda.synchronize()
    return state, step_fn, glob, _peak_gib(base)


def run_full(workdir: str) -> dict:
    """chip_smoke.py's phase 14 on every rank of an NCCL group at full
    width: the x3 train step replicated and FSDP-sharded, the sharded x2
    bulk sampler, the sharded Inception pass and the FSDP checkpoint
    round trip, each held against the run without the mesh.  Rank 0
    prints one {"multigpu_path": ...} line; any disagreement raises."""
    if dist.get_backend() != "nccl":
        raise RuntimeError("the full dry run runs on the cards, under NCCL")
    # chip_smoke.py's flags (TF32 off); the runs compared bit for bit take
    # the deterministic algorithms, and ops with none are named
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    n = world_size()
    mesh = create_mesh()
    out = {"world_size": n, "backend": dist.get_backend(), "card": card_line()}
    say = print if is_main() else (lambda *a, **k: None)

    # the x3 train step: replicated, without the mesh, FSDP
    rows = batch_sharding(mesh, X3_CONFIG["batch_size"])
    seed = broadcast_object(_pick_seed(rows), mesh)   # rank 0's pick
    want = _predicted(seed, TRAIN_STEPS, rows)
    recorded: list = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep, losses, launched, rep_full, rep_peak = _train_run(
            seed, workdir, False, recorded)
        plain, plain_step, glob, plain_peak = _plain_run(seed, recorded, mesh)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    got = {k: launched[k] for k in ("attn_ctx", "attn_out", "convres_fwd",
                                    "convres_bwd")}
    assert got == {k: want[k] for k in got}, (got, want)
    assert np.isfinite(losses).all(), losses
    diff = {"params": _max_diff(rep_full[0], plain.params),
            "ema": _max_diff(rep_full[1], plain.ema_params)}
    lr = X3_CONFIG["lr"]
    if n == 1:
        assert diff == {"params": 0.0, "ema": 0.0}, (diff, nondet)
    else:   # other batch splits: within Adam's step a step (not verified)
        assert max(diff.values()) <= 2.2 * lr * TRAIN_STEPS, diff

    fsdp_tr, f_losses, f_launched, f_full, fsdp_peak = _train_run(
        seed, workdir, True, [])
    f_got = {k: f_launched[k] for k in got}
    assert f_got == got, (f_got, got)
    f_diff = {"params": _max_diff(f_full[0], rep_full[0]),
              "ema": _max_diff(f_full[1], rep_full[1])}
    for part in (0, 1):   # JAX's FSDP bounds (tests/test_parallel.py:163)
        for k, v in rep_full[part].items():
            torch.testing.assert_close(f_full[part][k], v, rtol=5e-3,
                                       atol=1.1e-3, msg=k)

    # ms a step, each run over the same steps from TRAIN_STEPS: the
    # replicated trainer takes them untimed first (a conv's first call at
    # a new count of recon rows sets cuDNN up), then every window
    # rewinds.  The step functions on the first recorded batch (the
    # mesh's cost alone) in turns, plain / replicated / FSDP and back;
    # the trainers' steps (their loaders included) once each
    for _ in range(TIMED_STEPS):
        rep.train_step()
    local = recorded[0]
    runs = {"plain": (plain, lambda: plain_step(plain, glob[0])),
            "replicated": (rep.state, lambda: rep._step_fn(rep.state, local)),
            "fsdp": (fsdp_tr.state,
                     lambda: fsdp_tr._step_fn(fsdp_tr.state, local)),
            "replicated_trainer": (rep.state, rep.train_step),
            "fsdp_trainer": (fsdp_tr.state, fsdp_tr.train_step)}
    ms: dict = {}
    for name in ("plain", "replicated", "fsdp", "fsdp", "replicated", "plain",
                 "replicated_trainer", "fsdp_trainer"):
        state, fn = runs[name]
        state.step = TRAIN_STEPS
        ms.setdefault(name, []).append(_timed_ms(fn, TIMED_STEPS))
    profiles = {}
    for name in ("plain", "replicated", "fsdp"):
        state, fn = runs[name]
        state.step = TRAIN_STEPS
        profiles[name] = _profiled(fn, 2)
    out["train"] = {
        "config": "bench.py:run_train (x3, B=32 x accumulation 2, bf16, "
                  "synthetic 256^2)", "seed": seed,
        "gated_rows_this_rank": want["gated_rows"],
        "launches_replicated": got, "launches_fsdp": f_got,
        "replicated_vs_plain_max_abs": diff, "fsdp_vs_replicated_max_abs": f_diff,
        "nondeterministic_ops": nondet,
        "sharded_params": len(fsdp_tr.state.fsdp.dims),
        "timed_steps": TIMED_STEPS, "ms_per_step": ms,
        "profile_per_step": profiles,
        "peak_gib_per_rank_above_held": {"replicated": rep_peak,
                                         "plain": plain_peak,
                                         "fsdp": fsdp_peak}}
    say(f"multi-GPU x3 step, world {n}: launches {got}, replicated vs plain "
        f"{diff}, FSDP vs replicated {f_diff}; ms a step "
        + ", ".join(f"{k} {' / '.join(f'{v:.1f}' for v in vs)}"
                    for k, vs in ms.items())
        + f"; kernels and kernel ms a step {profiles}"
        + f"; peak GiB above held: replicated {rep_peak}, plain {plain_peak},"
        f" FSDP {fsdp_peak} [{out['card']}]")
    del rep, plain, glob, recorded, local, runs
    torch.cuda.empty_cache()

    # the FSDP checkpoint round trip, bit for bit
    fsdp_tr.save_checkpoint()
    net, _, _, config = build_model(X3_CONFIG)
    fresh = fsdp.shard_state_fsdp(
        create_train_state(net, create_optimizer(net, config["lr"]), 0, mesh),
        mesh)
    ckpt.restore_checkpoint(fsdp_tr.checkpoint_dir, fresh)
    mine = fsdp_tr.state
    assert fresh.step == mine.step and fresh.seed == mine.seed
    for k, p in mine.params.items():
        assert torch.equal(p, fresh.params[k]), k
        assert torch.equal(mine.ema_params[k], fresh.ema_params[k]), k
    for p, p2 in zip(mine.opt.params, fresh.opt.params):
        for s in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(mine.opt.adam.state[p][s],
                               fresh.opt.adam.state[p2][s]), s
    out["checkpoint_round_trip"] = {"step": fresh.step, "exact": True}
    del fsdp_tr, fresh, mine, net
    torch.cuda.empty_cache()

    # the sharded bulk sampler: x2, B = 192 over the ranks, a cut chain
    net, process, init_fn, config = build_model(X2_CONFIG)
    init_fn(0)
    bsz, size = config["batch_size"], config["image_size"]
    cut = dict(fid_samples=bsz, batch_size=bsz, progress=False,
               early_stop=config["T"] - CHAIN_STEPS)
    generate_samples(process, seed=9, mesh=mesh,
                     **dict(cut, early_stop=config["T"] - 2))   # warm-up
    _reset_launches()
    s_mesh, z_mesh, t_mesh = generate_samples(process, seed=0, mesh=mesh,
                                              **cut)
    s_launched = {k: v for k, v in _launches().items() if v}
    s_plain, z_plain, t_plain = generate_samples(process, seed=0, **cut)
    assert s_mesh.shape == (1, bsz, size, size, 3), s_mesh.shape
    assert np.isfinite(s_mesh).all() and np.isfinite(z_mesh).all()
    s_diff = float(np.abs(s_mesh - s_plain).max())
    z_diff = float(np.abs(z_mesh - z_plain).max())
    local = bsz // n
    assert s_launched == _sampler_launches(), s_launched
    if n == 1:
        assert s_diff == 0.0 and z_diff == 0.0, (s_diff, z_diff)
    out["sampler"] = {
        "config": "bench.py:_sample_config(192), chain cut to "
                  f"{CHAIN_STEPS} steps + decode + fix_samples",
        "rows_per_rank": local, "launches_per_rank": s_launched,
        "samples_max_abs": s_diff, "latents_max_abs": z_diff,
        "imgs_per_s": {"mesh": t_mesh["imgs_per_sec"],
                       "plain": t_plain["imgs_per_sec"]}}
    say(f"multi-GPU sampler, world {n}: {local} rows a rank, launches "
        f"{s_launched}, max |diff| samples {s_diff} latents {z_diff}; "
        f"{t_mesh['imgs_per_sec']:.3f} imgs/s on the mesh, "
        f"{t_plain['imgs_per_sec']:.3f} without [{out['card']}]")
    del net, process
    torch.cuda.empty_cache()

    # the sharded Inception pass: the 192 samples + 192 other images
    gen = np.random.default_rng(4)
    images = np.concatenate([s_mesh[0], gen.uniform(
        0, 255, s_mesh[0].shape).astype(np.float32)])
    f_mesh = FeatureExtractor(mesh=mesh)(images)
    f_plain = FeatureExtractor()(images)
    i_diff = {k: float(np.abs(f_mesh[k] - v).max()) for k, v in f_plain.items()}
    for k, v in f_plain.items():
        assert f_mesh[k].shape == v.shape, k
        np.testing.assert_allclose(f_mesh[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    out["inception"] = {"images": len(images), "max_abs": i_diff}
    say(f"multi-GPU Inception, world {n}: {len(images)} images, max |diff| "
        f"{i_diff}")
    if is_main():
        print(json.dumps({"multigpu_path": out}), flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card of each rank; "
                        "'cpu' runs gloo processes on the plain path)")
    p.add_argument("--full", action="store_true",
                   help="chip_smoke.py's multi-GPU phase at full width "
                        "(the cards only)")
    p.add_argument("--workdir", default="results/chip_smoke/multigpu",
                   help="--full: where the trainers write")
    args = p.parse_args(argv)
    initialize_distributed(device=args.device)
    if args.full:
        run_full(args.workdir)
    else:
        dryrun_multichip(world_size(), args.device)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
