"""The port's multi-GPU layer (dddpm_tpu_torch/parallel/) on the CPU:
process groups of 2 and 4 spawned gloo ranks against one process and
against the JAX package's mesh.

Each world size is spawned once per module (torch_parallel_worker.py
runs every case on its ranks and saves what they return), and so is the
one-process reference, in a fresh process of its own; the tests read
those results.  Every spawned process runs one thread with MKL's strict
reproducibility mode (MKL_CBWR=AVX2,STRICT): without it a CPU GEMM's
row depends on how many rows it is given (the time MLP's Linear layers
differ by ~1e-8 between batches of 8 and 4, which a 10-step chain
amplifies to ~1e-3 of the [0, 255] samples), so the comparisons of the
samplers would measure MKL rather than the sharding.  Held: spec_for against JAX's _spec_for; the
initialization rules; the row split and the mesh-shape rule; the
replicated step against the one-process step on the global batch and
against JAX's step on a 2-device mesh; the FSDP step against the
replicated one, with each rank's persistent bytes of the sharded
parameters 1/N; the compact recon branch against the dense one on two
ranks; the sharded samplers and Inception pass against one process;
train_main and resume_main on two ranks with a checkpoint moving
between world sizes; dryrun_multichip(2).  Dropout is 0 wherever two
runs are compared (the masks are per rank).
"""
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

from dddpm_tpu.models.factory import build_model as jax_build_model
from dddpm_tpu.parallel.fsdp import _spec_for as jax_spec_for
from dddpm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from dddpm_tpu.parallel.mesh import replicated as jax_replicated
from dddpm_tpu.train.state import TrainState as JaxTrainState
from dddpm_tpu.train.state import create_optimizer as jax_create_optimizer
from dddpm_tpu.train.state import make_train_step as jax_make_train_step
from dddpm_tpu_torch import train_main
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.parallel.fsdp import spec_for
from dddpm_tpu_torch.parallel.mesh import (
    create_mesh,
    initialize_distributed,
    shard_batch,
)
from dddpm_tpu_torch.train import checkpoint as ckpt
from dddpm_tpu_torch.train.trainer import setup_trainer

import torch_parallel_worker as W

SPAWN_TIMEOUT_S = 600


def _spawn(world, workdir, inputs):
    """Runs W.run on `world` spawned ranks (world 0: one process without
    a group); their outputs, by rank."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    saved = os.environ.get("MKL_CBWR")
    os.environ["MKL_CBWR"] = "AVX2,STRICT"   # read by the spawned processes
    try:
        ctx = mp.start_processes(W.run, args=(world, str(workdir)),
                                 nprocs=max(world, 1), start_method="spawn",
                                 join=False)
    finally:
        if saved is None:
            del os.environ["MKL_CBWR"]
        else:
            os.environ["MKL_CBWR"] = saved
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(max(world, 1))]


def _jax_params(config, seed=0):
    """The JAX tree of `config`, drawn with numpy (kernels U(+-1/sqrt(fan
    in)), norm scales near 1, biases near 0; JAX's init compiles long)."""
    _, _, init_j, _ = jax_build_model(config)
    shapes = jax.eval_shape(init_j, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        u = rng.uniform(-1.0, 1.0, s.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(u / np.sqrt(np.prod(s.shape[:-1])))
        return jnp.asarray(0.1 * u + (1.0 if ("scale" in name or "'g'" in name)
                                      else 0.0))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _to_torch(tree, config):
    net, _, _, _ = build_model(config, device="cpu")
    return jax_to_state_dict(jax.tree.map(np.asarray, tree), net)


def _jax_step(params, batch):
    """JAX's step on a 2-device mesh (batch sharded on 'data', state
    replicated) and the t and eps it draws."""
    _, proc_j, _, _ = jax_build_model(W.CFG)
    tx = jax_create_optimizer(W.CFG["lr"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          ema_params=params, opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(1))
    step_rng = jax.random.fold_in(state.rng, 0)
    ts, epss = [], []
    for i in range(2):   # loss_fn's splits of fold_in(step_rng, i)
        rng_t, rng_l = jax.random.split(jax.random.fold_in(step_rng, i))
        ts.append(np.asarray(proc_j.t_sample(rng_t, W.CFG["batch_size"])))
        epss.append(np.asarray(jax.random.normal(
            jax.random.split(rng_l)[0], batch.shape[1:])))
    mesh = jax_create_mesh((2,), devices=jax.devices()[:2])
    state = jax.device_put(state, jax_replicated(mesh))
    batch_j = jax.device_put(jnp.asarray(batch),
                             NamedSharding(mesh, P(None, "data")))
    new, metrics = jax.jit(jax_make_train_step(proc_j, tx, 2, 0.995))(
        state, batch_j)
    return (new, {k: float(v) for k, v in metrics.items()},
            torch.from_numpy(np.stack(ts)[None].astype(np.int64)),
            torch.from_numpy(np.stack(epss)[None]))


SAMPLE_RUNS = [("ddpm", W.CFG, dict(fid_samples=12, batch_size=8)),
               ("dddpm", W.DD_CFG, dict(fid_samples=12, batch_size=8)),
               ("ddim", W.DD_CFG, dict(fid_samples=8, batch_size=8,
                                       ddim_steps=5, ddim_eta=0.5))]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every case on 2 ranks, with the one-process and JAX references."""
    root = tmp_path_factory.mktemp("world2")
    rng = np.random.default_rng(1)
    params_j = _jax_params(W.CFG)
    weights = _to_torch(params_j, W.CFG)
    batch = rng.uniform(-1, 1, (2, 2, 16, 8, 8, 3)).astype(np.float32)
    new_j, metrics_j, t_j, eps_j = _jax_step(params_j, batch[0])

    def init(config):
        net, _, init_fn, _ = build_model(config, device="cpu")
        init_fn(7)
        return {k: v.clone() for k, v in net.state_dict().items()}

    dd_t = torch.tensor([[[0, 3, 7, 9, 6, 8, 9, 5], [9, 9, 9, 9, 1, 2, 8, 7]]])
    images = rng.uniform(0, 255, (5, 16, 16, 3)).astype(np.float32)
    # a one-process FSDP checkpoint (nothing to shard in one process)
    one = root / "one"
    one.mkdir()
    cwd = os.getcwd()
    os.chdir(one)
    try:
        one_ckpt = os.path.join(one, train_main.main(
            list(W.TRAIN_ARGV)).checkpoint_dir)
    finally:
        os.chdir(cwd)
    inputs = {
        "cases": ["mesh", "steps", "compact", "sample", "inception", "cli",
                  "dryrun"],
        "weights": weights, "batch": torch.from_numpy(batch),
        "jax_draws": (t_j, eps_j),
        "dd_weights": init(W.DD_CFG),
        "dd_batch": torch.from_numpy(rng.uniform(
            -1, 1, (1, 2, 8, 16, 16, 3)).astype(np.float32)),
        "dd_t": dd_t,
        "dd_eps": torch.from_numpy(rng.standard_normal(
            (1, 2, 8, 8, 8, 4)).astype(np.float32)),
        "sample_runs": SAMPLE_RUNS,
        "sample_weights": {name: init(cfg) for name, cfg, _ in SAMPLE_RUNS},
        "images": images, "inception_batch": 3,
        "one_process_ckpt": one_ckpt,
    }
    outs = _spawn(2, root, inputs)
    one = _spawn(0, root / "reference", dict(
        inputs, cases=["steps", "sample", "inception"]))[0]
    refs = {"steps": one["steps"], "jax": (new_j, metrics_j),
            "samples": one["sample"], "inception": one["inception"],
            "one_ckpt": one_ckpt}
    return outs, refs, inputs


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = tmp_path_factory.mktemp("world4")
    rng = np.random.default_rng(2)
    batch = rng.uniform(-1, 1, (2, 2, 16, 8, 8, 3)).astype(np.float32)
    weights = _to_torch(_jax_params(W.CFG, seed=3), W.CFG)
    inputs = {"cases": ["mesh", "steps"], "weights": weights,
              "batch": torch.from_numpy(batch)}
    return _spawn(4, root, inputs), None, inputs


# ------------------------------------------------------------------ rules


@pytest.mark.parametrize("min_size", [512, 4096])
@pytest.mark.parametrize("axis", [2, 4, 8])
def test_spec_for_matches_jax(axis, min_size):
    """Per parameter of the test model: sharded or not, and the size of
    the sharded dimension (the torch layouts permute JAX's)."""
    shapes = jax.eval_shape(jax_build_model(W.CFG)[2], jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(shapes)
    # each leaf's index written into it, to find its torch name
    marks = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    marks = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(marks),
        [np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    named = _to_torch(marks, W.CFG)
    assert len(named) == len(leaves)
    n_sharded = 0
    for name, t in named.items():
        s = leaves[int(t.reshape(-1)[0])]
        spec = jax_spec_for(s.shape, axis, min_size)
        want = (None if "data" not in spec
                else s.shape[list(spec).index("data")])
        dim = spec_for(tuple(t.shape), axis, min_size)
        assert (None if dim is None else t.shape[dim]) == want, name
        n_sharded += want is not None
    assert n_sharded > 0 or min_size > 512


def test_one_process_needs_no_group():
    """No coordinator and one process: initialize_distributed is a no-op
    returning 0, no mesh, and a multi-rank mesh shape raises."""
    assert initialize_distributed(device="cpu") == 0
    assert not dist.is_initialized()
    assert create_mesh() is None and create_mesh((1,)) is None
    with pytest.raises(ValueError, match="needs 2 processes"):
        create_mesh((2,))
    x = torch.arange(6)
    assert shard_batch(x, None) is not None and torch.equal(
        shard_batch(x, None), x)


def test_initialize_distributed_two_processes(world2):
    outs, _, _ = world2
    assert [o["rank"] for o in outs] == [0, 1]
    assert [o["again"] for o in outs] == [0, 1]   # a second call: no-op


@pytest.mark.parametrize("world", [2, 4])
def test_rows_and_mesh_shape_rule(world, world2, world4):
    """Rank r of N takes rows [r B / N, (r + 1) B / N); a mesh shape whose
    product is not the world size raises (deliberate: JAX takes a prefix
    of its devices), as does a batch N does not divide."""
    outs = (world2 if world == 2 else world4)[0]
    rows = torch.cat([o["mesh"]["rows"] for o in outs])
    assert torch.equal(rows, torch.arange(4 * world))
    dim1 = np.concatenate([o["mesh"]["rows_dim1"] for o in outs], axis=1)
    np.testing.assert_array_equal(dim1, np.arange(8 * world).reshape(2, -1))
    for r, o in enumerate(outs):
        assert o["mesh"]["coords"] == (r, world)
        assert len(o["mesh"]["errors"]) == 3, o["mesh"]["errors"]


# ------------------------------------------------------------ train steps


def _close_steps(got, want, lr, steps, tag):
    """Two train states at JAX's own data-parallel bounds
    (tests/test_parallel.py:71-76): the clipped gradients within 1e-5 of
    the largest; params and EMA at rtol 1e-3 / atol 2e-4 where the
    gradient is not noise, elsewhere within Adam's step of each other
    (Adam turns sum-order noise in an exactly-zero gradient, e.g. a conv
    bias before a one-channel GroupNorm group, into a step of +-lr)."""
    g_max = max(float(g.abs().max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        torch.testing.assert_close(got["grads"][k], g, rtol=0,
                                   atol=1e-5 * g_max, msg=f"{tag} grad {k}")
        solid = g.abs() > 1e-5 * g_max
        for part in ("params", "ema"):
            a, b = got[part][k], want[part][k]
            torch.testing.assert_close(a[solid], b[solid], rtol=1e-3,
                                       atol=2e-4, msg=f"{tag} {part} {k}")
            assert float((a - b).abs().max()) <= 2.2 * lr * steps, (tag, k)


def _metrics_close(got, want, keys=("train_obj", "grad_norm")):
    for m, n in zip(got, want, strict=True):
        for k in keys:
            np.testing.assert_allclose(m[k], n[k], rtol=1e-5, err_msg=k)


def test_replicated_step_equals_one_process_step(world2):
    """Two steps on 2 ranks (the seeded global draws, each rank its rows)
    against one process on the global batch; the params are bit-identical
    across ranks."""
    outs, refs, _ = world2
    want = refs["steps"]["rep"]
    got = outs[0]["steps"]["rep"]
    _metrics_close(got["metrics"], want["metrics"])
    _close_steps(got, want, W.CFG["lr"], 2, "rep")
    for k, p in got["params"].items():
        assert torch.equal(p, outs[1]["steps"]["rep"]["params"][k]), k
        assert torch.equal(got["ema"][k], outs[1]["steps"]["rep"]["ema"][k]), k


def test_two_rank_step_matches_jax_two_device_mesh(world2):
    """Converted weights, JAX's t and eps injected: the 2-rank step
    against JAX's step on a 2-device mesh, and against the one-process
    port step."""
    outs, refs, _ = world2
    got = outs[0]["steps"]["rep_jax"]
    new_j, metrics_j = refs["jax"]
    _metrics_close(got["metrics"], [metrics_j])
    net, _, _, _ = build_model(W.CFG, device="cpu")
    conv = lambda tree: jax_to_state_dict(jax.tree.map(np.asarray, tree), net)
    mu = conv(new_j.opt_state[1][0].mu)   # (1 - b1) x the clipped gradient
    want = {"params": conv(new_j.params), "ema": conv(new_j.ema_params),
            "grads": {k: v / 0.1 for k, v in mu.items()}}
    _close_steps(got, want, W.CFG["lr"], 1, "jax")
    one = refs["steps"]["rep_jax"]
    _metrics_close(got["metrics"], one["metrics"])
    _close_steps(got, one, W.CFG["lr"], 1, "one")


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_step_equals_replicated_step(world, world2, world4):
    """FSDP (min_size 512) against the replicated step, 2 steps; each
    rank holds 1/N of every sharded parameter's master, EMA and Adam
    moments, and no full copy between steps."""
    outs, _, inputs = world2 if world == 2 else world4
    rep, shard = outs[0]["steps"]["rep"], outs[0]["steps"]["fsdp"]
    _metrics_close(shard["metrics"], rep["metrics"])
    # JAX's FSDP bounds (tests/test_parallel.py:163-168)
    for part in ("params", "ema"):
        for k, v in rep[part].items():
            torch.testing.assert_close(shard[part][k], v, rtol=5e-3,
                                       atol=1.1e-3, msg=f"{part} {k}")
    shapes = {k: tuple(v.shape) for k, v in inputs["weights"].items()}
    want_dims = {k: spec_for(s, world, W.FSDP_MIN_SIZE)
                 for k, s in shapes.items()}
    want_dims = {k: d for k, d in want_dims.items() if d is not None}
    assert shard["dims"] == want_dims and want_dims
    for o in outs:
        local = o["steps"]["fsdp"]["local"]
        for k in want_dims:
            assert local[k] == (np.prod(shapes[k]) // world,) * 4, k
        assert o["steps"]["fsdp"]["released"] == 0


def test_compact_recon_equals_dense_on_two_ranks(world2):
    """Rank 0 has recon rows in micro-batch 0, rank 1 none (its compact
    branch skips the resamplers); the step equals the dense branch's."""
    outs, _, _ = world2
    compact, dense = outs[0]["compact"][True], outs[0]["compact"][False]
    _metrics_close(compact["metrics"], dense["metrics"],
                   ("train_obj", "train_latent", "train_recon", "grad_norm"))
    g_max = max(float(g.abs().max()) for g in dense["grads"].values())
    for k, g in dense["grads"].items():
        torch.testing.assert_close(compact["grads"][k], g, rtol=0,
                                   atol=1e-5 * g_max, msg=k)


# ------------------------------------------------- sampling and inception


@pytest.mark.parametrize("name", [n for n, _, _ in SAMPLE_RUNS])
def test_sharded_sampler_equals_one_process(name, world2):
    """Two batches of 8 (DDPM, dDDPM with its latents) or one DDIM-5 batch
    (eta 0.5), 4 rows a rank: the arrays one process returns, bit for
    bit, on every rank."""
    outs, refs, _ = world2
    x1, z1 = refs["samples"][name]
    for o in outs:
        x, z = o["sample"][name]
        np.testing.assert_array_equal(x, x1)
        if name == "ddpm":
            assert z is None and z1 is None
        else:
            np.testing.assert_array_equal(z, z1)


def test_sharded_inception_equals_one_process(world2):
    """5 images in batches of 4 (3 rounded up to the 2 ranks; the tail of
    1 zero-padded to 2): the three heads at 1e-5."""
    outs, refs, _ = world2
    assert refs["inception"]["batch_size"] == 3
    for o in outs:
        assert o["inception"]["batch_size"] == 4
        for k, v in refs["inception"]["features"].items():
            got = o["inception"]["features"][k]
            assert got.shape == v.shape, k
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


# ------------------------------------------------------------- entries


def _blob(ckpt_dir):
    return torch.load(os.path.join(ckpt_dir, "state.pt"), weights_only=True)


def _assert_same_blob(a, b):
    assert a["step"] == b["step"] and a["seed"] == b["seed"]
    for part in ("params", "ema"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for s in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][s], sb[i][s]), (i, s)


def test_train_main_on_two_ranks_writes_from_rank_0(world2):
    """train_main -e 1 --mesh-shape 2 --fsdp on 2 ranks (then
    resume_main): rank 0 writes the checkpoint and the metrics log, rank
    1 writes nothing."""
    outs, _, _ = world2
    assert outs[0]["cli"]["sharded"] > 0
    assert ckpt.load_config(outs[0]["cli"]["ckpt"])["mesh_shape"] == [2]
    files = outs[0]["cli"]["files"]
    assert any(f.endswith("state.pt") for f in files), files
    assert any(f.startswith(os.path.join("results", "logging")) for f in files)
    assert outs[1]["cli"]["files"] == []
    assert os.path.exists(os.path.join(outs[0]["cli"]["ckpt"], "state.pt"))


def test_checkpoint_moves_between_world_sizes(world2, tmp_path):
    """Two ranks -> one process: the FSDP checkpoint restores into a
    one-process trainer bit for bit (its reconstructions equal the ones
    each rank made from its gathered EMA), which saves it back
    unchanged.  One
    process -> two ranks: resume_main of a one-process checkpoint on two
    FSDP ranks saves it unchanged."""
    outs, refs, _ = world2
    two = outs[0]["cli"]["ckpt"]
    config = ckpt.load_config(two)
    config["unet_dims"] = tuple(config["unet_dims"])
    config["mesh_shape"] = None
    trainer, _ = setup_trainer(config, mute=True, workdir=str(tmp_path),
                               n_samples=4, device="cpu")
    trainer.load_checkpoint(two)
    blob = _blob(two)
    for k, p in trainer.state.params.items():
        assert torch.equal(p.detach(), blob["params"][k]), k
    # the evaluation weights: rank r's gathered EMA, one process's EMA
    x_recon, _ = trainer.recon(trainer.val_batch, seed=5)
    for o in outs:
        torch.testing.assert_close(o["cli"]["recon"], x_recon, rtol=1e-5,
                                   atol=1e-5)
    trainer.checkpoint_dir = str(tmp_path / "back")
    trainer.save_checkpoint()
    _assert_same_blob(_blob(tmp_path / "back"), blob)
    _assert_same_blob(_blob(outs[0]["cli"]["resumed_ckpt"]),
                      _blob(refs["one_ckpt"]))


def test_dryrun_multichip_two_ranks(world2):
    outs, _, _ = world2
    res = outs[0]["dryrun"]
    assert np.isfinite(res["train_obj"]) and res["sharded"] > 0
    assert tuple(res["samples"]) == (4, 16, 16, 3)
