"""The JAX-checkpoint bridge (convert_jax_checkpoint.py): a tiny orbax
checkpoint written here by the JAX trainer on the CPU becomes a
checkpoint of the port whose parameters, EMA weights, Adam moments and
step are JAX's, whose eps-predictor agrees with JAX's at 1e-5 of its
largest output (f32 convs summed in other orders), and which the port's
generate_main and resume_main take."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import convert_jax_checkpoint as bridge
from dddpm_tpu.models.factory import build_model as jax_build_model
from dddpm_tpu.train.trainer import setup_trainer as jax_setup_trainer
from dddpm_tpu_torch import generate_main, resume_main
from dddpm_tpu_torch.convert import jax_to_state_dict
from dddpm_tpu_torch.models.factory import build_model
from dddpm_tpu_torch.train import checkpoint as ckpt

CFG = {
    "model": "ddpm", "dataset": "synthetic", "image_size": 8,
    "batch_size": 8, "n_steps": 3, "lr": 1e-3, "T": 10,
    "loss_type": "simple", "beta_schedule": "cosine", "loss_flat": "sum",
    "unet_chan": 8, "unet_dims": (1, 2), "unet_dropout": 0.0,
    "ema_decay": 0.995, "val_split": 0, "rnd_flip": False,
    "grad_accum": 2, "compute_dtype": "float32",
}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(JAX trainer after 3 steps, its checkpoint, the port's copy)."""
    root = tmp_path_factory.mktemp("bridge")
    trainer, _ = jax_setup_trainer(dict(CFG), mute=True, workdir=str(root))
    trainer.n_samples, trainer.n_rows = 4, 2
    trainer.train()
    out = bridge.main(["--checkpoint", trainer.checkpoint_dir,
                       "--out", str(root / "port")])
    return trainer, trainer.checkpoint_dir, out


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_state_is_jax_state(converted):
    trainer, _, out = converted
    state = trainer.state
    blob = torch.load(os.path.join(out, "state.pt"), weights_only=True)
    net, _, _, _ = build_model(ckpt.load_config(out), device="cpu")
    names = [n for n, _ in net.named_parameters()]
    adam = bridge._adam_state(state.opt_state)
    assert blob["step"] == int(state.step) == CFG["n_steps"]
    for key, tree in (("params", state.params), ("ema", state.ema_params)):
        want = jax_to_state_dict(_np(tree), net)
        assert list(blob[key]) == names
        for n in names:
            assert torch.equal(blob[key][n], want[n]), (key, n)
    mu, nu = jax_to_state_dict(_np(adam.mu), net), jax_to_state_dict(_np(adam.nu), net)
    opt = blob["opt_state"]["state"]
    assert sorted(opt) == list(range(len(names)))
    for i, n in enumerate(names):
        assert float(opt[i]["step"]) == int(adam.count) == CFG["n_steps"]
        assert torch.equal(opt[i]["exp_avg"], mu[n]), n
        assert torch.equal(opt[i]["exp_avg_sq"], nu[n]), n
    assert blob["opt_state"]["param_groups"][0]["lr"] == CFG["lr"]
    assert ckpt.load_losses(out) == pytest.approx(trainer.train_losses)


def test_eps_forward_matches_jax(converted):
    trainer, _, out = converted
    jnet, _, _, _ = jax_build_model(dict(CFG))
    net, _, _, _ = build_model(ckpt.load_config(out), device="cpu")
    net.load_state_dict(ckpt.load_model_params(out, prefer_ema=False))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 4, 9], np.int32)
    want = np.asarray(jnet.apply(jax.device_get(trainer.state.params),
                                 jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(t).long()).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, float(np.abs(want).max()))


def test_port_entries_take_the_converted_checkpoint(converted, tmp_path,
                                                    monkeypatch):
    _, _, out = converted
    monkeypatch.chdir(tmp_path)
    samples, _, _ = generate_main.main(
        ["--checkpoint", out, "--fid-samples", "2", "--batch-size", "2",
         "--out", "s", "--device", "cpu"])
    assert samples.shape == (1, 2, 8, 8, 3) and np.isfinite(samples).all()
    resumed = resume_main.main(["--checkpoint", out, "--steps",
                                str(CFG["n_steps"] + 1), "-mute",
                                "--device", "cpu"])
    assert resumed.step == CFG["n_steps"] + 1
    assert len(resumed.train_losses) == CFG["n_steps"] + 1
    assert np.isfinite(resumed.train_losses[-1])
