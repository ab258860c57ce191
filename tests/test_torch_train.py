"""The port's training slice held against the JAX package on the CPU:
the DDPM and dDDPM losses, the EMA, one whole train step (accumulation
x2, clip, Adam, EMA) on the same weights, batch, t and eps, the data
loader and the config; then the port's trainer end to end with a
checkpoint and a resume.  All in float32.

The port draws t and eps from torch generators; here both are drawn as
the JAX package draws them, from its key layout, and handed to the port.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddpm_tpu import config as jconfig
from dddpm_tpu.data import pipeline as jpipeline
from dddpm_tpu.models.factory import build_model as jax_build_model
from dddpm_tpu.train.ema import ema_update as jax_ema_update
from dddpm_tpu.train.state import create_optimizer as jax_create_optimizer
from dddpm_tpu.train.state import TrainState as JaxTrainState
from dddpm_tpu.train.state import make_train_step as jax_make_train_step
from dddpm_tpu_torch import config as tconfig
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.data import pipeline
from dddpm_tpu_torch.models import resample
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.train import checkpoint
from dddpm_tpu_torch.train.ema import ema_update
from dddpm_tpu_torch.train.state import (
    create_optimizer,
    create_train_state,
    make_train_step,
)
from dddpm_tpu_torch.train.trainer import setup_trainer

# a tiny x2 dDDPM: image 16 -> latent 8x8x8, UNet 8 wide; ConvResNet
# resamplers at d_chans 64 (the main path's block widths, cio 64 / cm 32)
CONFIG = {
    "model": "dddpm", "dataset": "synthetic", "image_size": 16,
    "batch_size": 16, "n_steps": 2, "lr": 1e-3, "T": 50,
    "loss_type": "simple", "beta_schedule": "linear", "loss_flat": "sum",
    "unet_chan": 8, "unet_dims": (1, 2), "unet_dropout": 0.0,
    "unet_in": 8, "n_downsamples": 1,
    "d_mode": "convolutional_res", "u_mode": "convolutional_res",
    "d_dropout": 0, "d_chans": 64, "d_n_blocks": 2, "u_n_blocks": 2,
    "ae_loss": True, "t_rec_max": 5, "force_latent": True,
    "compute_dtype": "float32", "ema_decay": 0.995, "grad_accum": 2,
    "prefetch": 0, "val_split": 0, "rnd_flip": False,
}
B = 16
LATENT = (B, 8, 8, 8)


@pytest.fixture(scope="module")
def params():
    """Weights for the JAX tree of CONFIG, drawn here with numpy (kernels
    U(+-1/sqrt(fan_in)), norm scales near 1, biases near 0): JAX's own
    init costs a long XLA compile, and the tree's shapes are all a
    comparison needs."""
    _, _, init_j, _ = jax_build_model(CONFIG)
    shapes = jax.eval_shape(init_j, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        u = rng.uniform(-1.0, 1.0, s.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(u / np.sqrt(np.prod(s.shape[:-1])))
        return jnp.asarray(0.1 * u + (1.0 if ("scale" in name or "'g'" in name)
                                      else 0.0))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(config, params):
    """The JAX process and the port's model on the CPU with the same
    weights."""
    _, proc_j, _, _ = jax_build_model(config)
    net, proc, _, _ = build_model(config, device="cpu")
    net.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, params), net))
    return proc_j, net, proc


def _images(seed, n=B):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("loss_type", ["simple", "vlb", "hybrid"])
@pytest.mark.parametrize("loss_flat", ["sum", "mean"])
def test_loss_ddpm_matches_jax(loss_type, loss_flat):
    cfg = dict(CONFIG, loss_type=loss_type, loss_flat=loss_flat)
    _, proc_j, _, _ = jax_build_model(cfg)
    _, proc, _, _ = build_model(cfg, device="cpu")
    rng = np.random.default_rng(2)
    eps, eps_hat = (rng.standard_normal(LATENT).astype(np.float32)
                    for _ in range(2))
    t = rng.integers(0, 50, B)
    want = proc_j.loss_ddpm(jnp.asarray(eps), jnp.asarray(eps_hat),
                            jnp.asarray(t, jnp.int32))
    got = proc.loss_ddpm(torch.from_numpy(eps), torch.from_numpy(eps_hat),
                         torch.from_numpy(t))
    # one f32 reduction of 512 terms in another order
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def models(params):
    out = {}
    for compact in (True, False):
        proc_j, net, proc = _pair(dict(CONFIG, recon_compact=compact), params)
        losses_j = jax.jit(proc_j.losses, static_argnames="train")
        out[compact] = (proc_j, losses_j, net, proc)
    return out


# t with 3 rows under t_rec_max = 5 (JAX's compact branch, capacity 8),
# with none (compact, all fill-ins), and with 10 (over capacity: JAX's
# dense fallback)
T_CASES = {
    "some": [0, 20, 4, 33, 49, 7, 12, 3, 45, 30, 8, 19, 25, 40, 11, 9],
    "none": [5, 20, 14, 33, 49, 7, 12, 30, 45, 30, 8, 19, 25, 40, 11, 9],
    "many": [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 8, 19, 25, 40, 11, 9],
}


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("case", list(T_CASES))
def test_autoencoder_losses_match_jax(models, params, compact, case):
    proc_j, losses_j, net, proc = models[compact]
    assert proc.recon_compact == proc_j.recon_compact == compact
    x = _images(3)
    t = np.asarray(T_CASES[case])
    rng = jax.random.PRNGKey(11)
    obj_j, parts_j = losses_j(params, rng, jnp.asarray(x),
                              jnp.asarray(t, jnp.int32), train=False)
    # the AE variant's eps: normal(split(rng, 4)[0], z.shape)
    eps = np.array(jax.random.normal(jax.random.split(rng, 4)[0], LATENT))
    with torch.no_grad():
        obj, parts = proc.losses(torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(eps))
    if case == "none":
        assert float(parts["recon"]) == 0.0
    # f32 both sides, conv sums in other orders; the latent loss is a sum
    # of 512 squares per row (~500): 1e-5 relative
    for got, want in ((obj, obj_j), (parts["latent"], parts_j["latent"]),
                      (parts["recon"], parts_j["recon"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)


def test_compact_recon_skips_the_resamplers_when_no_row_is_gated(models):
    """With no t under t_rec_max the compact branch launches nothing:
    the resamplers see only the full-batch no-grad downsample."""
    *_, net, proc = models[True]
    calls = []
    hook = net.upsample.register_forward_hook(lambda *a: calls.append(1))
    try:
        proc.losses(torch.from_numpy(_images(4)),
                    torch.tensor(T_CASES["none"]), torch.zeros(LATENT))
    finally:
        hook.remove()
    assert calls == []


# ---------------------------------------------------------------------- EMA


@pytest.mark.parametrize("step,why", [(100, "warm-up copy"),
                                      (2000, "lerp on an update step"),
                                      (2003, "unchanged off-cycle")])
def test_ema_matches_jax(step, why):
    rng = np.random.default_rng(5)
    ema, params = (rng.standard_normal(7).astype(np.float32) for _ in range(2))
    want = jax_ema_update({"w": jnp.asarray(ema)}, {"w": jnp.asarray(params)},
                          jnp.asarray(step), 0.995, 2000, 10)["w"]
    got = torch.from_numpy(ema.copy())
    ema_update([got], [torch.from_numpy(params)], step, 0.995, 2000, 10)
    # the lerp: two f32 products and a sum on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7, err_msg=why)


# --------------------------------------------------------------- train step


def test_train_step_matches_jax(monkeypatch, params):
    """One make_train_step (accumulation x2) against JAX's on the same
    weights, batch, t and eps, with a clip norm small enough that the
    clip triggers.  The port's ConvResBlocks take the fused op's autograd
    Function (its gate lowered), JAX's their plain convs: the same
    function either way, and the block-level tests pin the two fused
    paths against each other."""
    monkeypatch.setattr(resample, "FUSED_MIN_PIXELS", 0)
    cfg = dict(CONFIG, lr=1e-3)
    clip = 0.5
    proc_j, net, proc = _pair(cfg, params)
    tx = jax_create_optimizer(cfg["lr"], clip_norm=clip)
    state_j = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            ema_params=params, opt_state=tx.init(params),
                            rng=jax.random.PRNGKey(1))
    to_torch = lambda tree: jax_to_state_dict(jax.tree.map(np.asarray, tree), net)
    assert any(isinstance(m, resample.ConvResBlock) and m.fused_shape_ok(16, 16)
               for m in net.modules())

    batch = np.stack([_images(6), _images(7)])
    # JAX's draws: fold_in(fold_in(rng, step), i), then the loss_fn /
    # losses splits
    step_rng = jax.random.fold_in(state_j.rng, 0)
    ts, epss = [], []
    for i in range(2):
        rng_t, rng_l = jax.random.split(jax.random.fold_in(step_rng, i))
        ts.append(np.asarray(proc_j.t_sample(rng_t, B)))
        epss.append(np.asarray(jax.random.normal(
            jax.random.split(rng_l, 4)[0], LATENT)))
    assert any((t < cfg["t_rec_max"]).any() for t in ts), "no recon rows"

    new_j, metrics_j = jax.jit(jax_make_train_step(proc_j, tx, 2, 0.995))(
        state_j, jnp.asarray(batch))
    # Adam's first moment after one step is (1 - b1) times the clipped
    # gradients, on both sides
    mu_j = to_torch(new_j.opt_state[1][0].mu)

    opt = create_optimizer(net, cfg["lr"], clip_norm=clip)
    state = create_train_state(net, opt, seed=1)
    old = {k: p.detach().clone() for k, p in state.params.items()}
    metrics = make_train_step(proc, 2, 0.995)(
        state, torch.from_numpy(batch), t=torch.from_numpy(np.stack(ts)),
        eps=torch.from_numpy(np.stack(epss)))
    assert state.step == 1

    norm = float(metrics["grad_norm"])
    assert norm > clip, "the clip did not trigger"
    # metric scalars: f32 sums in other orders
    for k in ("train_obj", "train_latent", "train_recon", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]),
                                   rtol=1e-5, err_msg=k)
    # the clipped mean gradients (left in .grad, and Adam's first moment)
    # against JAX's: within 1e-5 of the largest gradient entry (conv and
    # matmul sums in other orders)
    g_max = max(float(m.abs().max()) for m in mu_j.values()) / 0.1
    adam = state.opt.adam
    for k, p in state.params.items():
        g_want = mu_j[k] / 0.1
        torch.testing.assert_close(p.grad, g_want, rtol=0, atol=1e-5 * g_max,
                                   msg=k)
        torch.testing.assert_close(adam.state[p]["exp_avg"], mu_j[k], rtol=0,
                                   atol=1e-6 * g_max, msg=k)
    # Adam's first step moves each entry by lr * g / (|g| + eps): about
    # lr, whatever |g|.  Entries with |g| below 1e-5 of the largest are
    # left out of the value check (there sum-order noise decides the
    # step: e.g. a conv bias right before a one-channel GroupNorm group
    # has an exact gradient of 0), and only bounded
    p_want, ema_want = to_torch(new_j.params), to_torch(new_j.ema_params)
    for k, p in state.params.items():
        step_got, step_want = p.detach() - old[k], p_want[k] - old[k]
        solid = (mu_j[k] / 0.1).abs() > 1e-5 * g_max
        torch.testing.assert_close(step_got[solid], step_want[solid],
                                   rtol=1e-3, atol=1e-6, msg=k)
        assert float(step_got.abs().max()) <= cfg["lr"] * 1.001, k
        # step 0 < ema start: the EMA is a copy of the new params
        torch.testing.assert_close(state.ema_params[k], p.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(ema_want[k], p_want[k], rtol=0, atol=0)


def test_optimizer_clip_is_optax_rule():
    """Below the norm the gradients pass untouched (no 1e-6 in the
    divisor); at or above it they are scaled to the norm exactly."""
    for scale, want_norm in ((0.5, 0.5), (3.0, 1.0)):
        w = torch.nn.Parameter(torch.zeros(4))
        w.grad = torch.tensor([3.0, 4.0, 0.0, 0.0]) * scale / 5.0
        before = w.grad.clone()
        opt = create_optimizer(torch.nn.Linear(1, 1), lr=0.0)
        opt.params, opt.adam = [w], torch.optim.Adam([w], lr=0.0)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), scale, rtol=1e-6)
        np.testing.assert_allclose(float(w.grad.norm()), want_norm, rtol=1e-6)
        if scale < 1.0:
            assert torch.equal(w.grad, before)


# ---------------------------------------------------------- data and config


def test_loader_matches_jax():
    images = np.random.default_rng(8).integers(0, 256, (20, 6, 6, 3),
                                               dtype=np.uint8)
    labels = np.arange(20)
    kw = dict(batch_size=4, shuffle=True, rescale=True, rnd_flip=True, seed=3)
    got = list(pipeline.Loader(images, labels, **kw))
    want = list(jpipeline.Loader(images, labels, **kw))
    assert len(got) == len(want) == 5
    for (x, y), (xj, yj) in zip(got, want):
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)


def test_config_matches_jax_without_tpu_flags():
    argv = ["-d", "synthetic", "-e", "7", "-bs", "8", "-is", "16",
            "-downsample", "3", "--T", "50", "--compute-dtype", "float32",
            "--remat", "--mesh-shape", "2", "--fsdp"]
    got, mute = tconfig.get_args(argv=argv)
    want, _ = jconfig.get_args(argv=argv)
    # the kernel selectors, remat, the mesh shape and fsdp are mirrored;
    # the port reads its data from inside the working directory by default
    assert want.pop("data_root") == "../data/" and got["data_root"] == "./data/"
    assert want == {k: v for k, v in got.items()
                    if k not in ("device", "data_root")}
    assert got["model"] == "dddpm" and got["T"] == 50 and not mute
    assert got["remat"] is True
    assert got["mesh_shape"] == (2,) and got["fsdp"] is True


# ------------------------------------------------------------------ trainer


def test_trainer_trains_checkpoints_and_resumes(tmp_path):
    cfg = dict(CONFIG, batch_size=4, n_steps=2)
    trainer, cfg_out = setup_trainer(dict(cfg), mute=True, workdir=str(tmp_path),
                                     n_samples=4, device="cpu")
    assert cfg_out["model_size"] == sum(p.numel() for p in trainer.net.parameters())
    before = {k: p.detach().clone() for k, p in trainer.state.params.items()}
    losses = trainer.train()
    assert trainer.step == 2 and len(losses) == 2
    assert all(np.isfinite(losses))
    assert any(not torch.equal(before[k], p) for k, p in trainer.state.params.items())
    ckpt_dir = trainer.checkpoint_dir
    assert sorted(os.listdir(ckpt_dir)) == ["config.json", "state.pt",
                                            "train_losses.json"]
    assert checkpoint.load_config(ckpt_dir)["n_steps"] == 2
    # eval-time load prefers the EMA weights
    ema = checkpoint.load_model_params(ckpt_dir)
    for k, v in trainer.state.ema_params.items():
        assert torch.equal(ema[k], v)

    # resume into a fresh trainer and take one more step
    resumed, _ = setup_trainer(dict(cfg, n_steps=3), mute=True,
                               workdir=str(tmp_path), n_samples=4, device="cpu")
    resumed.load_checkpoint(ckpt_dir)
    assert resumed.step == 2 and resumed.train_losses == losses
    for k, p in resumed.state.params.items():
        assert torch.equal(p, trainer.state.params[k])
    assert (resumed.opt.state_dict()["state"][0]["exp_avg"].tolist()
            == trainer.opt.state_dict()["state"][0]["exp_avg"].tolist())
    resumed.train()
    assert resumed.step == 3 and len(resumed.train_losses) == 3
    # the image grids of the logging step, with the EMA weights
    resumed.log_images()
    names = os.listdir(os.path.join(str(tmp_path), "logging"))
    assert sum(n.startswith("3_") and n.endswith(".png") for n in names) == 4


# ------------------------------------------------------------ dropout keys


def _dropout_state(seed):
    """A fresh net (weights from init seed 0) and train state under run
    seed `seed`, with the default generator reseeded as Trainer.__init__
    reseeds it, and the UNet's dropout active."""
    torch.manual_seed(seed)
    cfg = dict(CONFIG, unet_dropout=0.5, batch_size=4)
    net, proc, init_fn, _ = build_model(cfg, device="cpu")
    init_fn(0)
    net.train()
    state = create_train_state(net, create_optimizer(net, cfg["lr"]), seed)
    return state, make_train_step(proc, grad_accum=2), cfg


def _dropout_batches(n):
    rng = np.random.default_rng(11)
    return torch.from_numpy(np.tanh(rng.standard_normal(
        (n, 2, 4, 16, 16, 3))).astype(np.float32))


def test_resumed_step_draws_the_unbroken_runs_dropout(tmp_path):
    """Step 3 after a resume from a step-2 checkpoint equals step 3 of
    the unbroken run, params and loss exactly, with dropout 0.5: each
    step seeds its masks from (seed, step), not from where the default
    generator stands."""
    batches = _dropout_batches(3)
    state, step_fn, cfg = _dropout_state(7)
    for i in range(2):
        step_fn(state, batches[i])
    checkpoint.save_checkpoint(str(tmp_path), state, cfg)
    want = float(step_fn(state, batches[2])["train_obj"])

    resumed, step_r, _ = _dropout_state(7)
    checkpoint.restore_checkpoint(str(tmp_path), resumed)
    assert resumed.step == 2
    got = float(step_r(resumed, batches[2])["train_obj"])
    assert got == want
    for k, p in resumed.params.items():
        assert torch.equal(p, state.params[k]), k


def test_dropout_masks_follow_the_run_seed():
    """The same step with t and eps given (so only dropout draws) gives
    the same loss under one seed and another loss under another."""
    batch = _dropout_batches(1)[0]
    rng = np.random.default_rng(12)
    t = torch.from_numpy(rng.integers(0, CONFIG["T"], (2, 4)))
    eps = torch.from_numpy(rng.standard_normal((2, 4, 8, 8, 8)).astype(np.float32))
    loss = {}
    for run, seed in (("a", 7), ("b", 7), ("c", 8)):
        state, step_fn, _ = _dropout_state(seed)
        loss[run] = float(step_fn(state, batch, t=t, eps=eps)["train_obj"])
    assert loss["a"] == loss["b"]
    assert loss["a"] != loss["c"]
